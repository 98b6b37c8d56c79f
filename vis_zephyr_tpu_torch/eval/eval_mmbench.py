"""MMBench evaluation: TSV with base64 images, hint+options prompt assembly.

Port of `vis_zephyr_tpu/eval/eval_mmbench.py` (reference
`vis_zephyr/eval/eval_mmbench.py:23-171`): rows carry ``index, question,
hint, A..D, image (base64)``; the prompt is ``hint\\nquestion\\nA. ...\\n...``
+ "Answer with the option's letter from the given choices directly.";
outputs go to JSONL. The TSV is read with the stdlib csv module, and items
are batched through the VCR harness's `run_batch` (one right-padded prefill,
the batch's replayed decode steps). The model runs on the card unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import base64
import csv
import io
import json
import os
from typing import Dict, List, Optional

import torch

from ..config import VisZephyrConfig
from ..constants import DEFAULT_IMAGE_TOKEN
from ..data.image_pipeline import anyres_preprocess_host
from ..serve.generate import SamplingConfig
from .answer_extraction import extract_answer, get_chunk
from .eval_vqa import prompt_item, run_batch

OPTION_KEYS = ("A", "B", "C", "D")


def _is_none(value) -> bool:
    return value is None or value == "" or str(value).lower() in ("nan", "none")


def load_tsv(path: str) -> List[Dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f, delimiter="\t"))


def build_prompt(row: Dict) -> str:
    question = row["question"]
    hint = row.get("hint")
    if not _is_none(hint):
        question = hint + "\n" + question
    for key in OPTION_KEYS:
        if not _is_none(row.get(key)):
            question += f"\n{key}. {row[key]}"
    return (
        DEFAULT_IMAGE_TOKEN + "\n" + question + "\n"
        "Answer with the option's letter from the given choices directly."
    )


def prepare_row(row: Dict, cfg: VisZephyrConfig, tokenizer, conv_mode="zephyr_vcr") -> Dict:
    from PIL import Image

    image = Image.open(io.BytesIO(base64.b64decode(row["image"]))).convert("RGB")
    pixels, patch_valid = anyres_preprocess_host(
        image, cfg.mm_grid_pinpoints, target_size=cfg.vision.image_size
    )
    return prompt_item(build_prompt(row), pixels, patch_valid, tokenizer,
                       gold=row.get("answer", ""), question_id=row.get("index"),
                       conv_mode=conv_mode)


def eval_model(args, model=None, cfg: Optional[VisZephyrConfig] = None, tokenizer=None):
    if model is None:
        from ..models.builder import load_pretrained_model

        tokenizer, model, cfg, _ = load_pretrained_model(
            args.model_path, model_base=args.model_base,
            vision_tower_path=args.vision_tower, dtype=torch.bfloat16, device=args.device,
        )

    rows = load_tsv(args.question_file)
    rows = get_chunk(rows, args.num_chunks, args.chunk_idx)
    sampling = SamplingConfig(
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature,
        eos_token_id=cfg.decoder.eos_token_id,
    )

    os.makedirs(os.path.dirname(os.path.abspath(args.answers_file)), exist_ok=True)
    correct = total = with_gold = 0
    with open(args.answers_file, "w") as out_f:
        for start in range(0, len(rows), args.batch_size):
            items = [
                prepare_row(rows[i], cfg, tokenizer)
                for i in range(start, min(start + args.batch_size, len(rows)))
            ]
            outputs = run_batch(model, cfg, tokenizer, items, sampling)
            for it, text in zip(items, outputs):
                pred = extract_answer(text)
                total += 1
                if it["gold"]:
                    with_gold += 1
                    correct += int(pred == str(it["gold"]).strip()[:1])
                out_f.write(
                    json.dumps(
                        {
                            "question_id": it["question_id"],
                            "prompt": it["prompt"],
                            "text": text,
                            "extracted_answer": pred,
                        }
                    )
                    + "\n"
                )
    if with_gold:
        print(f"accuracy: {correct / with_gold:.4f} ({correct}/{with_gold})")
    print(f"processed {total} rows")
    return correct, with_gold, total


def build_parser():
    p = argparse.ArgumentParser(description="MMBench eval")
    p.add_argument("--model-path", default="")
    p.add_argument("--model-base", default=None)
    p.add_argument("--vision-tower", default=None)
    p.add_argument("--question-file", required=True)
    p.add_argument("--answers-file", default="mmbench_answers.jsonl")
    p.add_argument("--num-chunks", type=int, default=1)
    p.add_argument("--chunk-idx", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--max-new-tokens", type=int, default=16)
    p.add_argument("--device", default="cuda",
                   help="the model's device: the card unless asked otherwise (cpu)")
    return p


if __name__ == "__main__":
    eval_model(build_parser().parse_args())
