"""VCR evaluation: ViP-overlaid multiple-choice QA / QA→R.

Port of `vis_zephyr_tpu/eval/eval_vqa.py` (reference
`vis_zephyr/eval/eval_vqa.py`): per-item ViP overlay (constant point
style), anyres preprocess, greedy generate, regex answer extraction, JSONL
output with in-loop accuracy. The reference parallelizes by shell fan-out
over `--num-chunks/--chunk-idx` (one process per GPU); that flag surface is
kept, and within a process items are batched (`--batch-size`) through one
right-padded prefill (`text_valid`) and the batch's replayed decode steps.
`--num-beams` > 1 decodes each item by beam search
(`serve/generate.py::beam_search`).

Failure handling keeps the reference's semantics (`eval_vqa.py:79-88`):
ViP preprocessing is retried up to 10 times, then the item is substituted
with a random other item.

`eval_model` prepares items (PIL: the image and its overlay) and hands them
to `score_items`, which does everything after preparation: batching,
decoding, answer extraction, the JSONL lines and the running accuracy. A
caller with items built otherwise (pixels without PIL, as `chip_smoke.py`
builds them) calls `score_items` directly. The model runs on the card unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import random
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..config import VisZephyrConfig
from ..conversation import templates
from ..data.image_pipeline import anyres_preprocess_host
from ..data.tokenization import tokenize_with_images
from ..data.vip import visual_prompt_process
from ..serve.generate import SamplingConfig, beam_search, generate, pad_to_bucket
from .answer_extraction import extract_answer, get_chunk


def prepare_item(
    record: Dict,
    image_folder: str,
    cfg: VisZephyrConfig,
    tokenizer,
    style: str,
    rng: random.Random,
    conv_mode: str = "zephyr_vcr",
) -> Dict:
    """One VCR item → overlaid+tiled pixels and tokenized prompt."""
    from PIL import Image

    image = Image.open(os.path.join(image_folder, record["image"])).convert("RGB")
    image, conversations = visual_prompt_process(
        record, image,
        image_size_anchor=cfg.vision.image_size,
        image_folder=image_folder,
        visual_prompt_style=style,
        rng=rng,
    )
    pixels, patch_valid = anyres_preprocess_host(
        image, cfg.mm_grid_pinpoints, target_size=cfg.vision.image_size
    )
    return prompt_item(conversations[0]["value"], pixels, patch_valid, tokenizer,
                       gold=conversations[1]["value"],
                       question_id=record.get("question_id", record["id"]), conv_mode=conv_mode)


def prompt_item(prompt: str, pixels: np.ndarray, patch_valid: np.ndarray, tokenizer, gold,
                question_id, conv_mode: str = "zephyr_vcr") -> Dict:
    """A prepared item: `prompt` (the human turn) in the `conv_mode` template,
    tokenized with its image sentinel, beside its pixels [P, S, S, 3], their
    validity [P] and the gold answer."""
    conv = templates[conv_mode].copy()
    conv.append_message(conv.roles[0], prompt)
    conv.append_message(conv.roles[1], None)
    ids = tokenize_with_images(conv.get_prompt(), tokenizer)
    return {
        "input_ids": np.asarray(ids, np.int64),
        "images": pixels,
        "patch_valid": patch_valid,
        "gold": gold,
        "question_id": question_id,
        "prompt": prompt,
    }


def prepare_item_with_retry(
    records: List[Dict], index: int, image_folder, cfg, tokenizer, style, rng,
    max_attempts: int = 10,
) -> Dict:
    for attempt in range(max_attempts):
        try:
            return prepare_item(records[index], image_folder, cfg, tokenizer, style, rng)
        except Exception:  # noqa: BLE001 — data errors → resample (parity)
            if attempt == max_attempts - 1:
                index = rng.randint(0, len(records) - 1)
    return prepare_item(records[index], image_folder, cfg, tokenizer, style, rng)


def collate(items: List[Dict], cfg: VisZephyrConfig):
    """A batch of prepared items, right-padded: (ids [B, T] int64 with T a
    multiple of 64, text_valid [B, T] bool, pixels [B, P, S, S, 3] f32,
    patch_valid [B, P] bool), numpy."""
    B = len(items)
    T = pad_to_bucket(max(len(it["input_ids"]) for it in items), 64, 64)
    ids = np.full((B, T), cfg.decoder.pad_token_id, np.int64)
    valid = np.zeros((B, T), bool)
    for b, it in enumerate(items):
        n = len(it["input_ids"])
        ids[b, :n] = it["input_ids"]
        valid[b, :n] = True
    return (ids, valid, np.stack([it["images"] for it in items]),
            np.stack([it["patch_valid"] for it in items]))


def run_batch_beam(model, cfg, tokenizer, items: List[Dict], sampling: SamplingConfig,
                   num_beams: int):
    """Beam-search decode, one item at a time (beams ride the batch axis of
    the decode step — `generate.beam_search`). The reference reaches this
    through HF `model.generate(num_beams=...)`."""
    dev = model.device
    texts = []
    for it in items:
        toks = beam_search(
            model,
            torch.as_tensor(np.asarray(it["input_ids"])[None], device=dev),
            torch.as_tensor(np.asarray(it["images"], np.float32)[None], device=dev),
            torch.as_tensor(np.asarray(it["patch_valid"])[None], device=dev),
            cfg,
            num_beams=num_beams,
            max_new_tokens=sampling.max_new_tokens,
            eos_token_id=sampling.eos_token_id,
        )
        texts.append(tokenizer.decode(toks, skip_special_tokens=True))
    return texts


def run_batch(model, cfg, tokenizer, items: List[Dict], sampling: SamplingConfig):
    """Pad a batch of prepared items and decode it (greedily unless the
    sampling says otherwise)."""
    dev = model.device
    ids, valid, images, patch_valid = (torch.from_numpy(a).to(dev)
                                       for a in collate(items, cfg))
    out = generate(model, ids, images, patch_valid, cfg, sampling, text_valid=valid)
    texts = []
    for b in range(len(items)):
        toks = [int(t) for t in out[b]]
        if sampling.eos_token_id in toks:
            toks = toks[: toks.index(sampling.eos_token_id)]
        texts.append(tokenizer.decode(toks, skip_special_tokens=True))
    return texts


def score_items(model, cfg: VisZephyrConfig, tokenizer, items: Iterable[Dict],
                sampling: SamplingConfig, batch_size: int, out_f, num_beams: int = 1
                ) -> Tuple[int, int]:
    """Everything after preparation: `items` (any iterable of prepared items,
    pulled a batch at a time) in batches of `batch_size` through `run_batch`
    (or `run_batch_beam` when `num_beams` > 1), each answer's letter
    (`extract_answer`) against the gold's first letter, one JSONL line an
    item to `out_f`, the running accuracy printed every 10 batches. Returns
    (correct, total)."""
    correct = total = 0
    items = iter(items)
    while True:
        batch = list(itertools.islice(items, batch_size))
        if not batch:
            break
        outputs = (
            run_batch_beam(model, cfg, tokenizer, batch, sampling, num_beams)
            if num_beams > 1
            else run_batch(model, cfg, tokenizer, batch, sampling)
        )
        for it, text in zip(batch, outputs):
            pred = extract_answer(text)
            gold = str(it["gold"]).strip()[:1]
            total += 1
            correct += int(pred == gold)
            out_f.write(
                json.dumps(
                    {
                        "question_id": it["question_id"],
                        "prompt": it["prompt"],
                        "text": text,
                        "extracted_answer": pred,
                        "gold_answer": gold,
                    }
                )
                + "\n"
            )
        if total and total % (10 * batch_size) < batch_size:
            print(f"[{total}] accuracy so far: {correct / total:.4f}", flush=True)
    return correct, total


def eval_model(args, model=None, cfg: Optional[VisZephyrConfig] = None, tokenizer=None):
    num_beams = getattr(args, "num_beams", 1)
    if model is None:
        from ..models.builder import load_pretrained_model

        tokenizer, model, cfg, _ = load_pretrained_model(
            args.model_path, model_base=args.model_base,
            vision_tower_path=args.vision_tower, dtype=torch.bfloat16, device=args.device,
        )

    with open(args.question_file) as f:
        records = json.load(f)
    records = get_chunk(records, args.num_chunks, args.chunk_idx)

    rng = random.Random(args.seed)
    sampling = SamplingConfig(
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature,
        top_p=1.0 if args.top_p is None else args.top_p,
        eos_token_id=cfg.decoder.eos_token_id,
    )

    os.makedirs(os.path.dirname(os.path.abspath(args.answers_file)), exist_ok=True)
    # Prepared lazily, a batch at a time, in the reference's order of the rng.
    items = (prepare_item_with_retry(records, i, args.image_folder, cfg, tokenizer,
                                     args.visual_prompt_style, rng)
             for i in range(len(records)))
    with open(args.answers_file, "w") as out_f:
        correct, total = score_items(model, cfg, tokenizer, items, sampling, args.batch_size,
                                     out_f, num_beams=num_beams)
    print(f"final accuracy: {correct / max(total, 1):.4f} ({correct}/{total})")
    return correct, total


def build_parser():
    p = argparse.ArgumentParser(description="VCR eval")
    p.add_argument("--model-path", required=False, default="")
    p.add_argument("--model-base", default=None)
    p.add_argument("--vision-tower", default=None)
    p.add_argument("--question-file", required=True)
    p.add_argument("--image-folder", required=True)
    p.add_argument("--answers-file", default="answers.jsonl")
    p.add_argument("--visual-prompt-style", default="vcr_qa", choices=["vcr_qa", "vcr_qar"])
    p.add_argument("--num-chunks", type=int, default=1)
    p.add_argument("--chunk-idx", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--temperature", type=float, default=0.0)
    # Reference flag surface (eval_vqa.py:229-230): top_p threads into
    # sampling; num_beams > 1 runs real beam search (HF generate
    # semantics, `serve/generate.py::beam_search`).
    p.add_argument("--top-p", "--top_p", dest="top_p", type=float,
                   default=None)
    p.add_argument("--num-beams", "--num_beams", dest="num_beams", type=int,
                   default=1)
    p.add_argument("--max-new-tokens", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="the model's device: the card unless asked otherwise (cpu)")
    return p


if __name__ == "__main__":
    eval_model(build_parser().parse_args())
