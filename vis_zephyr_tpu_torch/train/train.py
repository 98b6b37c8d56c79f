"""Training entry point: two-stage multimodal training on one card, PyTorch.

Port of `vis_zephyr_tpu/train/train.py` (reference `vis_zephyr/train/
train.py:729-957`, driven by `script/pretrain.sh` / `script/finetune.sh`):
- stage 1 "pretrain": frozen tower and decoder, the Q-Former projector
  trains (projector LR, cosine schedule, warmup 0.03);
- stage 2 "finetune": LoRA adapters on the decoder's linears (dropout 0.05),
  everything else frozen;
- modality-grouped length sampler, bucket-padded collation, threaded
  prefetch; gradient accumulation with optimizer-step accounting;
- projector-only checkpoints each save interval, a full-state checkpoint at
  the end (and on SIGTERM), resume from the latest full state with the data
  order fast-forwarded; per-step metrics JSONL and the `benchmark.csv` row.

One card: on a CUDA device the decoder's attention runs the flash kernels
(K1 forward, twice under remat; K7 and K8 backward) whenever the spliced
length is a multiple of 128 (in practice when `model_max_length` truncates
it). Meshes and more than one process are not ported (ROADMAP.md, Queue A
step 13). `mm_use_im_start_end` / `mm_use_im_patch_token` add their tokens
to the tokenizer and mean-extend the tables (`initialize_vision_tokenizer`)
before LoRA is attached, as the JAX trainer does.

Departures from the JAX signature:
- `build_components` and `train` take an optional prebuilt `dataset` (any
  object with `__len__`, `__getitem__`, `lengths` and `modality_lengths`, as
  `SupervisedDataset` has). It replaces only the JSON and image reading:
  the Collator, the sampler, the prefetch loader and everything after them
  run as usual. It exists because a machine without PIL cannot open an image
  (the H100 machine `chip_smoke.py` runs on has none).
- `TrainArguments` adds `device` (the card unless asked otherwise) and
  `config_path`, a `VisZephyrConfig` JSON for a random-weight model when no
  `model_path` is given (the JAX trainer then builds the full-width default;
  a small config lets the CLI run on the CPU).
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import signal
import time
from typing import Optional

import numpy as np
import torch

from ..config import VisZephyrConfig
from ..data import prefetch as _prefetch
from ..data.dataset import Collator, DataConfig, LengthGroupedSampler, SupervisedDataset
from ..models.vis_zephyr import init_vis_zephyr, initialize_vision_tokenizer
from ..utils.metrics import MetricsLogger
from .checkpoints import latest_checkpoint, load_checkpoint, load_projector, save_checkpoint
from .lora import LoraConfig, add_lora
from .optimizer import OptimizerConfig, build_optimizer, learning_rates_at
from .steps import init_train_state, make_train_step


@dataclasses.dataclass
class TrainArguments:
    # Stage/model
    stage: str = "1"                      # "1" projector pretrain | "2" LoRA finetune
    model_path: str = ""                  # init checkpoint dir (optional)
    pretrain_mm_mlp_adapter: str = ""     # projector-only ckpt to load for stage 2
    lora_r: int = 128
    lora_alpha: int = 256
    lora_dropout: float = 0.05            # reference script/finetune.sh
    # Data
    data_path: str = ""
    image_folder: str = ""
    image_aspect_ratio: str = "anyres"
    mm_grid_pinpoints: str = "[[336, 672], [672, 336], [336, 1008], [1008, 336]]"
    mm_projector_type: str = "qformer"    # qformer | mlp2x_gelu
    mm_patch_merge_type: str = "flat"     # flat | spatial | spatial_unpad
    mm_use_im_start_end: bool = False
    mm_use_im_patch_token: bool = False
    model_max_length: int = 2048
    group_by_modality_length: bool = True
    # Optimization
    learning_rate: float = 2e-5
    mm_projector_lr: Optional[float] = 2e-3
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    num_epochs: int = 1
    per_device_batch_size: int = 16
    # Reference stage-2 recipe: per-GPU bs 4 × gradient_accumulation_steps 4.
    grad_accum_steps: int = 1
    max_steps: Optional[int] = None       # optimizer steps (HF semantics)
    max_grad_norm: float = 1.0
    seed: int = 42
    remat: bool = True
    # Mesh (one card only: data = model = 1, fsdp 0 or 1)
    mesh_data: int = 1
    mesh_fsdp: int = 0                    # 0 = all devices
    mesh_model: int = 1
    # Output
    output_dir: str = "./checkpoints/run"
    save_steps: int = 500
    logging_steps: int = 1
    resume: bool = True
    dtype: str = "bfloat16"
    report_to: str = "jsonl"              # "jsonl" | "none"
    metrics_path: str = ""                # default: <output_dir>/metrics.jsonl
    # The port's own
    device: str = "cuda"
    config_path: str = ""                 # VisZephyrConfig JSON when model_path is empty


def build_components(args: TrainArguments, tokenizer, cfg: Optional[VisZephyrConfig] = None,
                     dataset=None):
    """Construct (cfg, model, dataset, collator) for a run. `dataset`, if
    given, stands in for the `SupervisedDataset` of `args.data_path`."""
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    device = torch.device(args.device)
    if args.model_path:
        from ..models.builder import load_pretrained_model

        _, model, cfg, _ = load_pretrained_model(args.model_path, dtype=dtype, device=device)
    else:
        if cfg is None and args.config_path:
            with open(args.config_path) as f:
                cfg = VisZephyrConfig.from_json(f.read())
        cfg = cfg or VisZephyrConfig(
            image_aspect_ratio=args.image_aspect_ratio,
            mm_grid_pinpoints=args.mm_grid_pinpoints,
            mm_projector_type=args.mm_projector_type,
            mm_patch_merge_type=args.mm_patch_merge_type,
            tokenizer_model_max_length=args.model_max_length,
        )
        model = init_vis_zephyr(cfg, torch.Generator(device).manual_seed(args.seed),
                                device=device, dtype=dtype)
    if args.pretrain_mm_mlp_adapter:
        load_projector(args.pretrain_mm_mlp_adapter, model.projector)
    if args.mm_use_im_start_end or args.mm_use_im_patch_token:
        cfg, _ = initialize_vision_tokenizer(model, tokenizer, cfg,
                                             mm_use_im_patch_token=args.mm_use_im_patch_token,
                                             mm_use_im_start_end=args.mm_use_im_start_end)
        cfg = dataclasses.replace(cfg, mm_use_im_start_end=args.mm_use_im_start_end,
                                  mm_use_im_patch_token=args.mm_use_im_patch_token)
        model.cfg = cfg
    if args.stage == "2":
        add_lora(model, LoraConfig(r=args.lora_r, alpha=args.lora_alpha),
                 torch.Generator(device).manual_seed(args.seed + 1), dtype=dtype)

    if dataset is None:
        data_cfg = DataConfig(
            data_path=args.data_path,
            image_folder=args.image_folder,
            image_aspect_ratio=args.image_aspect_ratio,
            mm_grid_pinpoints=args.mm_grid_pinpoints,
            image_size=cfg.vision.image_size,
            mm_patch_merge_type=cfg.mm_patch_merge_type,
            vision_patch_size=cfg.vision.patch_size,
            seed=args.seed,
        )
        dataset = SupervisedDataset(data_cfg, tokenizer)
    collator = Collator(pad_token_id=cfg.decoder.pad_token_id, max_length=args.model_max_length)
    return cfg, model, dataset, collator


def _check_one_card(args: TrainArguments) -> None:
    if args.mesh_data != 1 or args.mesh_model != 1 or args.mesh_fsdp not in (0, 1):
        raise NotImplementedError(
            f"mesh data={args.mesh_data} fsdp={args.mesh_fsdp} model={args.mesh_model}: the "
            "PyTorch trainer runs on one card; meshes are ROADMAP.md, Queue A step 13")
    distributed = torch.distributed.is_available() and torch.distributed.is_initialized()
    world = torch.distributed.get_world_size() if distributed else int(
        os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        raise NotImplementedError(f"{world} processes: the PyTorch trainer runs in one "
                                  "process on one card (ROADMAP.md, Queue A step 13)")


def _to_device(batch, device: torch.device):
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


def train(args: TrainArguments, tokenizer, cfg: Optional[VisZephyrConfig] = None,
          dataset=None):
    """Run a training job; returns the final train state ({"params": model,
    "opt_state": optimizer, "step": micro-steps})."""
    _check_one_card(args)
    cfg, model, dataset, collator = build_components(args, tokenizer, cfg, dataset)
    device = torch.device(args.device)

    dp = 1
    global_batch = args.per_device_batch_size * dp
    accum = max(1, args.grad_accum_steps)

    # Optimizer-step accounting (HF semantics): max_steps / save_steps /
    # logging_steps / the LR schedule count optimizer steps; the loop below
    # consumes `accum` micro-batches per optimizer step.
    steps_per_epoch = max(1, len(dataset) // (global_batch * accum))
    total_steps = args.max_steps or steps_per_epoch * args.num_epochs
    total_micro = total_steps * accum

    opt_cfg = OptimizerConfig(
        learning_rate=args.learning_rate,
        projector_lr=args.mm_projector_lr,
        weight_decay=args.weight_decay,
        warmup_ratio=args.warmup_ratio,
        total_steps=total_steps,
        max_grad_norm=args.max_grad_norm,
    )
    optimizer = build_optimizer(model, opt_cfg, stage=args.stage, accum=accum)
    train_step = make_train_step(
        model, cfg, optimizer, remat=args.remat,
        lora_dropout=args.lora_dropout if args.stage == "2" else 0.0,
        dropout_seed=args.seed,
    )
    state = init_train_state(model, optimizer)

    start_step = 0
    if args.resume:
        last = latest_checkpoint(args.output_dir, full_state=True)
        if last:
            state = load_checkpoint(last, state)
            start_step = state["step"]
            print(f"resumed from {last} at step {start_step}")

    sampler = LengthGroupedSampler(
        dataset.modality_lengths if args.group_by_modality_length else dataset.lengths,
        batch_size=args.per_device_batch_size,
        # Megabatch spans one OPTIMIZER step's samples: world × accum
        # (reference `train/vis_zephyr_trainer.py:215`).
        world_size=dp * accum,
        group_by_modality=args.group_by_modality_length,
        seed=args.seed,
    )

    # Preemption safety: checkpoint at the next step boundary on SIGTERM and
    # exit cleanly so `--resume` continues without losing work.
    preempted = {"flag": False}

    def _on_sigterm(signum, frame):  # noqa: ARG001
        preempted["flag"] = True

    try:
        prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:  # non-main thread (tests drive train() directly)
        prev_handler = None

    run_t0 = time.perf_counter()
    seen_samples = 0
    step = start_step
    losses = []
    window_metrics = []  # last `accum` micro-steps' (loss, grad_norm)
    mlogger = None
    if args.report_to == "jsonl":
        mlogger = MetricsLogger(args.metrics_path or os.path.join(args.output_dir, "metrics.jsonl"),
                                echo=False)
    last_log_t = run_t0
    last_log_step = start_step

    # Data-order resume: the sampler is deterministic in (seed, epoch), so
    # skipping the batches an uninterrupted run would already have consumed
    # reproduces its exact data order (HF Trainer skip semantics).
    to_skip = start_step
    try:
        for epoch in range(args.num_epochs):
            sampler.set_epoch(epoch)
            order = list(iter(sampler))
            batch_indices = [
                order[s : s + global_batch]
                for s in range(0, len(order) - global_batch + 1, global_batch)
            ]
            if to_skip >= len(batch_indices):
                to_skip -= len(batch_indices)
                continue
            if to_skip:
                batch_indices = batch_indices[to_skip:]
                to_skip = 0
            loader = _prefetch.PrefetchLoader(dataset, collator, batch_indices, num_workers=4)
            for batch in loader:
                if step >= total_micro or preempted["flag"]:
                    break
                state, metrics = train_step(state, _to_device(batch, device))
                step += 1
                seen_samples += global_batch
                opt_step, at_boundary = step // accum, step % accum == 0
                # Device scalars, no host sync: averaged over the accumulation
                # window at logging time (HF Trainer reports the window mean).
                window_metrics.append((metrics["loss"], metrics["grad_norm"]))
                if len(window_metrics) > accum:
                    window_metrics.pop(0)

                if at_boundary and opt_step % args.logging_steps == 0:
                    loss = float(np.mean([float(m[0]) for m in window_metrics]))
                    losses.append(loss)
                    print(f"step {opt_step}/{total_steps} loss {loss:.4f}", flush=True)
                    if mlogger:
                        now = time.perf_counter()
                        d_steps = max(1, step - last_log_step)
                        mlogger.log(
                            opt_step,
                            loss=loss,
                            # Mean micro-grad norm over the window.
                            grad_norm=float(np.mean([float(m[1]) for m in window_metrics])),
                            tokens=int(metrics["tokens"]),
                            samples_per_s=round(
                                d_steps * global_batch / max(now - last_log_t, 1e-9), 3),
                            step_time_s=round((now - last_log_t) / d_steps, 4),
                            epoch=epoch,
                            **{k: round(v, 8) for k, v in
                               learning_rates_at(opt_cfg, opt_step).items()},
                        )
                        last_log_t, last_log_step = now, step
                if at_boundary and opt_step % args.save_steps == 0:
                    save_checkpoint(
                        args.output_dir, state, opt_step,
                        projector_only=(args.stage == "1"),
                        metadata={"loss": losses[-1] if losses else None},
                    )
                if preempted["flag"]:
                    # Mid-accumulation is fine: the optimizer state carries the
                    # partial gradients and resumes exactly.
                    save_checkpoint(args.output_dir, state, opt_step, projector_only=False,
                                    metadata={"preempted": True})
                    print(f"preempted: checkpointed at step {opt_step}", flush=True)
                    break
            if preempted["flag"]:
                break

        # Final save: stage 1 keeps the projector artifact AND the full
        # state; stage 2 saves adapters in the full state.
        if not preempted["flag"]:
            save_checkpoint(args.output_dir, state, step // accum, projector_only=False)
            if args.stage == "1":
                save_checkpoint(args.output_dir, state, step // accum + 1, projector_only=True)
    finally:
        if mlogger:
            mlogger.close()
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)

    # benchmark.csv instrumentation (reference train.py:856-927).
    wall = time.perf_counter() - run_t0
    _append_benchmark(args.output_dir, {
        "steps": step - start_step,
        "samples": seen_samples,
        "wall_s": round(wall, 2),
        "samples_per_s": round(seen_samples / max(wall, 1e-9), 3),
        "final_loss": losses[-1] if losses else None,
        "global_batch": global_batch,
        "mesh": f"dcn=1,data={args.mesh_data},fsdp=1,model={args.mesh_model}",
    })
    return state


def _append_benchmark(output_dir: str, row: dict) -> None:
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, "benchmark.csv")
    exists = os.path.exists(path)
    with open(path, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(row.keys()))
        if not exists:
            writer.writeheader()
        writer.writerow(row)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Vis-Zephyr trainer (PyTorch, one card)")
    # Fields whose default is None still need a numeric caster.
    optional_casters = {"max_steps": int, "mm_projector_lr": float}
    for f in dataclasses.fields(TrainArguments):
        name = "--" + f.name.replace("_", "-")
        if isinstance(f.default, bool):
            p.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"),
                           default=f.default)
        elif f.name in optional_casters:
            p.add_argument(name, type=optional_casters[f.name], default=f.default)
        else:
            caster = str
            if isinstance(f.default, int):
                caster = int
            elif isinstance(f.default, float):
                caster = float
            p.add_argument(name, type=caster, default=f.default)
    p.add_argument("--tokenizer-path", default="")
    return p


def main(argv=None):
    ns = build_parser().parse_args(argv)
    args = TrainArguments(**{f.name: getattr(ns, f.name)
                             for f in dataclasses.fields(TrainArguments)})
    try:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(ns.tokenizer_path or args.model_path)
    except (ImportError, OSError, ValueError) as e:
        raise SystemExit(f"could not load a tokenizer from "
                         f"{ns.tokenizer_path or args.model_path!r}: {e}") from e
    train(args, tokenizer)


if __name__ == "__main__":
    main()
