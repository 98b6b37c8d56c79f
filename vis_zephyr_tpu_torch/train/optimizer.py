"""Optimizer: AdamW with decay/no-decay × projector-LR groups, cosine
schedule with linear warmup, global-norm clipping, gradient accumulation and
stage-based parameter freezing, PyTorch.

Port of `vis_zephyr_tpu/train/optimizer.py`, whose optax chain is
`clip_by_global_norm` after zeroing frozen grads, then `multi_transform` of
four `adamw`s (optionally wrapped in `MultiSteps`). Here:
- the frozen parameters get `requires_grad=False` and no optimizer state
  (optax's `set_to_zero` group), so they get no `.grad` at all;
- `torch.optim.AdamW` with one group per (projector | base) × (decay |
  no decay) label (optax's and torch's AdamW are the same update: decoupled
  decay on the old parameter, eps added to the bias-corrected sqrt(v));
- a `LambdaLR` that reproduces `optax.warmup_cosine_decay_schedule` (or its
  linear-then-constant form) at optax's count: the first update uses the
  value at count 0, lr / warmup, not 0;
- the clip of `optax.clip_by_global_norm` exactly: g · max / ‖g‖ when ‖g‖ ≥
  max over the trainable gradients (not `clip_grad_norm_`, which adds 1e-6);
- `accum` > 1 as `optax.MultiSteps`: the mean of the micro-batch gradients,
  applied every `accum` calls, the schedule advancing once per update.

Parity surface (reference): four groups `vis_zephyr_trainer.py:224-302`;
stage-1 trains only the projector, stage-2 the LoRA adapters
(`train/train.py:775-829`); warmup 0.03, cosine, clip 1.0 (`pretrain.sh`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from ..models.mistral import RMSNorm


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 2e-5
    projector_lr: Optional[float] = 2e-3  # None → use learning_rate
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    total_steps: int = 1000
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    max_grad_norm: float = 1.0
    schedule: str = "cosine"  # "cosine" | "constant"


def is_projector(name: str) -> bool:
    return name.startswith("projector")


def no_decay_names(model: nn.Module) -> set:
    """Parameters excluded from weight decay: norm scales, biases, the
    Q-Former's queries and the image newline (JAX `no_decay`: leaves named
    `scale` or `bias`, paths with `queries` or `image_newline`)."""
    names = set()
    for mname, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            full = f"{mname}.{pname}" if mname else pname
            if (isinstance(mod, (nn.LayerNorm, RMSNorm)) or pname.endswith("bias")
                    or "queries" in full or "image_newline" in full):
                names.add(full)
    return names


def trainable_mask(model: nn.Module, stage: str) -> Dict[str, bool]:
    """{parameter name: whether it trains}.

    stage "1"    → the projector only (reference stage-1 freeze);
    stage "2"    → the LoRA adapters when attached (the projector frozen: the
                   reference's own freeze is a typo no-op, SURVEY §2.4.6),
                   otherwise everything but the projector and the tower;
    stage "full" → everything but the (always frozen) vision tower.
    """
    names = [name for name, _ in model.named_parameters()]
    has_lora = any(name.endswith("lora_a") for name in names)

    def decide(name: str) -> bool:
        leaf = name.rsplit(".", 1)[-1]
        if stage == "2" and has_lora:
            return leaf in ("lora_a", "lora_b")
        if name.startswith("vision"):
            return False
        if stage == "1":
            return is_projector(name)
        if stage == "2":
            return not is_projector(name)
        return True

    return {name: decide(name) for name in names}


def schedule_value(cfg: OptimizerConfig, lr: float, count: int) -> float:
    """The JAX `_make_schedule(cfg, lr)` at optax's update count."""
    warmup = max(1, int(cfg.total_steps * cfg.warmup_ratio))
    init = lr / warmup
    if count < warmup:  # optax.linear_schedule(init, lr, warmup)
        return (init - lr) * (1.0 - count / warmup) + lr
    if cfg.schedule == "constant":
        return lr
    decay_steps = max(cfg.total_steps, warmup + 1) - warmup
    t = min(count - warmup, decay_steps)
    return lr * 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))


def learning_rates_at(opt_cfg: OptimizerConfig, step: int) -> dict:
    """Schedule values at `step` for experiment logging (base + projector
    groups), matching what the optimizer actually applies."""
    proj = opt_cfg.projector_lr if opt_cfg.projector_lr is not None else opt_cfg.learning_rate
    return {"lr": schedule_value(opt_cfg, opt_cfg.learning_rate, step),
            "projector_lr": schedule_value(opt_cfg, proj, step)}


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (`optax.global_norm`)."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32) for t in tensors]
    return torch.linalg.vector_norm(torch.stack(norms))


class TrainOptimizer:
    """The JAX `build_optimizer` chain (and `MultiSteps` for `accum` > 1)
    over the trainable parameters of `model`, which it marks: `params` is
    their list, in `named_parameters` order."""

    def __init__(self, model: nn.Module, opt_cfg: OptimizerConfig, stage: str = "1",
                 accum: int = 1):
        self.cfg = opt_cfg
        self.accum = max(1, accum)
        self.micro = 0  # micro-batches accumulated since the last update
        mask = trainable_mask(model, stage)
        no_decay = no_decay_names(model)
        proj_lr = opt_cfg.projector_lr if opt_cfg.projector_lr is not None else opt_cfg.learning_rate
        groups: Dict[str, List[nn.Parameter]] = {}
        self.params = []
        for name, p in model.named_parameters():
            p.requires_grad_(mask[name])
            if not mask[name]:
                continue
            label = (("projector" if is_projector(name) else "base") + "_"
                     + ("no_decay" if name in no_decay else "decay"))
            groups.setdefault(label, []).append(p)
            self.params.append(p)
        if not self.params:
            raise ValueError(f"stage {stage!r} leaves no parameter to train")
        settings = {
            "projector_decay": (proj_lr, opt_cfg.weight_decay),
            "projector_no_decay": (proj_lr, 0.0),
            "base_decay": (opt_cfg.learning_rate, opt_cfg.weight_decay),
            "base_no_decay": (opt_cfg.learning_rate, 0.0),
        }
        self.adamw = torch.optim.AdamW(
            [{"params": groups[label], "lr": settings[label][0],
              "weight_decay": settings[label][1], "label": label}
             for label in settings if label in groups],
            betas=(opt_cfg.b1, opt_cfg.b2), eps=opt_cfg.eps)
        # The schedule is linear in its peak, so one factor serves every group.
        self.schedule = torch.optim.lr_scheduler.LambdaLR(
            self.adamw, lambda count: schedule_value(opt_cfg, 1.0, count))

    def update(self, grads: Sequence[torch.Tensor]) -> bool:
        """Take one micro-batch's gradients (aligned with `params`). Returns
        True when this call applied an update."""
        for p, g in zip(self.params, grads):
            p.grad = g if p.grad is None else p.grad.add_(g)
        self.micro += 1
        if self.micro < self.accum:
            return False
        grads = [p.grad for p in self.params]
        if self.accum > 1:
            torch._foreach_div_(grads, float(self.accum))
        if self.cfg.max_grad_norm:
            norm = global_norm(grads)
            factor = torch.where(norm < self.cfg.max_grad_norm, torch.ones_like(norm),
                                 self.cfg.max_grad_norm / norm)
            for g in grads:
                g.mul_(factor)
        self.adamw.step()
        self.schedule.step()
        for p in self.params:
            p.grad = None
        self.micro = 0
        return True

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "schedule": self.schedule.state_dict(),
                "micro": self.micro,
                "grads": [p.grad for p in self.params] if self.micro else None}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.schedule.load_state_dict(state["schedule"])
        self.micro = state["micro"]
        for p, g in zip(self.params, state["grads"] or [None] * len(self.params)):
            p.grad = None if g is None else g.to(p.device)


def build_optimizer(model: nn.Module, opt_cfg: OptimizerConfig, stage: str = "1",
                    accum: int = 1) -> TrainOptimizer:
    """AdamW with the reference's four parameter groups + freezing."""
    return TrainOptimizer(model, opt_cfg, stage=stage, accum=accum)
