"""Supervised dataset, bucket-padding collator and length-grouped sampling.

The port's own copy of `vis_zephyr_tpu/data/dataset.py` (whose module
imports JAX through its `image_pipeline`): host-side numpy, on the port's
host anyres (`data/image_pipeline.py`, PIL inside its functions). Parity
surface:
- `SupervisedDataset` ↔ reference `LazySupervisedDataset`
  (`vis_zephyr/train/train.py:511-654`): a JSON list of ``{"id", "image"?,
  "conversations": [{"from", "value"}, ...]}``; images are loaded and
  anyres- or pad-processed on the fly; `lengths` / `modality_lengths` drive
  the sampler.
- `Collator` ↔ `DataCollatorForSupervisedDataset` (`train.py:657-707`),
  sequences padded up to a multiple of `pad_multiple` (capped at
  `max_length`) and images to the static max patch count.
- `length_grouped_indices` / `modality_grouped_indices` ↔
  `vis_zephyr/train/vis_zephyr_trainer.py:59-190`.

Not ported, each refused with `NotImplementedError` naming its step in
ROADMAP.md Queue A: the native C++ image route (`use_native="yes"`; the
port's "auto" takes the PIL route), visual-prompt (ViP) records (step 12)
and the `spatial*` patch merge's `merge_info` (steps 2 and 3).
"""

from __future__ import annotations

import copy
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..constants import DEFAULT_IMAGE_TOKEN, IGNORE_INDEX
from ..conversation import Conversation, default_conversation
from . import anyres
from .image_pipeline import anyres_preprocess_host, preprocess_mode_host
from .tokenization import preprocess

# The dataset families the JAX package routes through its ViP processor
# (`vis_zephyr_tpu/data/vip/config.py::VIP_TRAIN_STYLES`).
VIP_DATASETS = ("refcocog", "vcr", "vg_rel", "flickr30k", "v7w", "pointQA_twice")


def vip_supports(record_id) -> bool:
    """Whether a record id belongs to a ViP dataset family (the JAX
    `data/vip/processor.py::supports`)."""
    return isinstance(record_id, str) and record_id.split("-")[0] in VIP_DATASETS


def normalize_multimodal_text(text: str) -> str:
    """Force `<image>` to appear once, first, on its own line
    (reference `preprocess_multimodal`, train.py:305-327)."""
    if DEFAULT_IMAGE_TOKEN in text:
        text = text.replace(DEFAULT_IMAGE_TOKEN, "").strip()
        text = DEFAULT_IMAGE_TOKEN + "\n" + text
    return text


@dataclass
class DataConfig:
    data_path: str = ""
    image_folder: str = ""
    image_aspect_ratio: str = "anyres"  # anyres | pad | resize | square
    mm_grid_pinpoints: str = "[[336, 672], [672, 336], [336, 1008], [1008, 336]]"
    image_size: int = 336
    max_patches: Optional[int] = None   # default: derived from pinpoints
    mm_patch_merge_type: str = "flat"
    vision_patch_size: int = 14
    visual_prompt_style: Optional[str] = None
    conv: Conversation = field(default_factory=lambda: default_conversation)
    seed: int = 0
    use_native: str = "auto"  # "auto" | "no" take the PIL route; "yes" is not ported


class SupervisedDataset:
    """Lazily processed supervised dataset (host-side)."""

    def __init__(self, data_config: DataConfig, tokenizer):
        if data_config.use_native == "yes":
            raise NotImplementedError(
                "the native C++ image route (use_native='yes') is not ported yet; "
                "'auto' takes the PIL route (ROADMAP.md, Queue A steps 1 and 5)")
        if data_config.mm_patch_merge_type.startswith("spatial"):
            raise NotImplementedError(
                f"mm_patch_merge_type={data_config.mm_patch_merge_type!r} (merge_info) is not "
                "ported yet (ROADMAP.md, Queue A steps 2 and 3)")
        with open(data_config.data_path) as f:
            self.records = json.load(f)
        self.cfg = data_config
        self.tokenizer = tokenizer
        if data_config.max_patches is None:
            pins = anyres.parse_grid_pinpoints(data_config.mm_grid_pinpoints)
            self.max_patches = anyres.max_anyres_patches(pins, data_config.image_size)
        else:
            self.max_patches = data_config.max_patches

    def __len__(self):
        return len(self.records)

    @staticmethod
    def _record_words(rec: Dict) -> int:
        """Word-count estimate for the sampler (raw VCR items, which carry no
        "conversations", are counted from their token-list fields)."""
        if "conversations" in rec:
            return sum(len(c["value"].split()) for c in rec["conversations"])
        n = len(rec.get("question") or ())
        for key in ("answer_choices", "rationale_choices"):
            choices = rec.get(key)
            if isinstance(choices, list) and choices:
                n += max(len(c) if isinstance(c, list) else len(str(c).split())
                         for c in choices)
        return n or 32

    @property
    def modality_lengths(self) -> List[int]:
        out = []
        for rec in self.records:
            n = self._record_words(rec)
            out.append(n if "image" in rec else -n)
        return out

    @property
    def lengths(self) -> List[int]:
        return [
            self._record_words(rec) + (128 if "image" in rec else 0)
            for rec in self.records
        ]

    def __getitem__(self, i: int) -> Dict:
        from PIL import Image

        rec = self.records[i]
        has_image = "image" in rec
        if has_image and vip_supports(rec.get("id")):
            raise NotImplementedError(
                f"record {rec.get('id')!r}: visual-prompt (ViP) records are not ported yet "
                "(ROADMAP.md, Queue A step 12)")
        conversations = copy.deepcopy(rec.get("conversations"))

        sample: Dict = {}
        if has_image:
            image = Image.open(os.path.join(self.cfg.image_folder, rec["image"])).convert("RGB")
            sample["images_size"] = image.size
            if self.cfg.image_aspect_ratio == "anyres":
                pixels, patch_valid = anyres_preprocess_host(
                    image, self.cfg.mm_grid_pinpoints,
                    target_size=self.cfg.image_size, max_patches=self.max_patches,
                )
            else:
                one = preprocess_mode_host(image, self.cfg.image_aspect_ratio, self.cfg.image_size)
                pixels = np.zeros((self.max_patches,) + one.shape, np.float32)
                pixels[0] = one
                patch_valid = np.arange(self.max_patches) < 1
            sample["images"] = pixels
            sample["patch_valid"] = patch_valid
            for turn in conversations or ():
                turn["value"] = normalize_multimodal_text(turn["value"])

        if conversations is None:
            raise ValueError(
                f"record {rec.get('id', i)!r} has no 'conversations' and no "
                "ViP route builds them (raw VCR items need a vcr-* id)")
        out = preprocess([conversations], self.tokenizer, has_image=has_image, conv=self.cfg.conv)
        sample["input_ids"] = out["input_ids"][0]
        sample["labels"] = out["labels"][0]
        if not has_image:
            # Dummy zero image keeps the batch shape uniform (reference
            # train.py:648-651); patch_valid all-False keeps it inert.
            sample["images"] = np.zeros(
                (self.max_patches, self.cfg.image_size, self.cfg.image_size, 3), np.float32
            )
            sample["patch_valid"] = np.zeros((self.max_patches,), bool)
            sample["images_size"] = (self.cfg.image_size, self.cfg.image_size)
        return sample


@dataclass
class Collator:
    """Batch + pad to bucketed static shapes."""

    pad_token_id: int
    max_length: int = 2048
    pad_multiple: int = 64

    def __call__(self, samples: Sequence[Dict]) -> Dict[str, np.ndarray]:
        longest = max(len(s["input_ids"]) for s in samples)
        T = min(self.max_length, -(-longest // self.pad_multiple) * self.pad_multiple)

        B = len(samples)
        input_ids = np.full((B, T), self.pad_token_id, np.int64)
        labels = np.full((B, T), IGNORE_INDEX, np.int64)
        text_valid = np.zeros((B, T), bool)
        for b, s in enumerate(samples):
            ids = s["input_ids"][: self.max_length]
            input_ids[b, : len(ids)] = ids
            labels[b, : len(ids)] = s["labels"][: self.max_length]
            text_valid[b, : len(ids)] = True

        batch = {
            "input_ids": input_ids,
            "labels": labels,
            "text_valid": text_valid,
            "images": np.stack([s["images"] for s in samples]),
            "patch_valid": np.stack([s["patch_valid"] for s in samples]),
        }
        if "merge_info" in samples[0]:
            batch["merge_info"] = np.stack([s["merge_info"] for s in samples])
        return batch


def split_to_even_chunks(indices, lengths, num_chunks):
    """Greedy length-balanced split (reference `vis_zephyr_trainer.py:103-124`)."""
    if len(indices) % num_chunks != 0:
        return [indices[i::num_chunks] for i in range(num_chunks)]
    per_chunk = len(indices) // num_chunks
    chunks = [[] for _ in range(num_chunks)]
    chunk_len = [0] * num_chunks
    for idx in indices:
        shortest = chunk_len.index(min(chunk_len))
        chunks[shortest].append(idx)
        chunk_len[shortest] += lengths[idx]
        if len(chunks[shortest]) == per_chunk:
            chunk_len[shortest] = float("inf")
    return chunks


def length_grouped_indices(lengths, batch_size, world_size, rng: np.random.Generator):
    """Shuffle → megabatches of batch×world → sort each by length desc
    (reference `vis_zephyr_trainer.py:127-142`)."""
    indices = rng.permutation(len(lengths)).tolist()
    mb = batch_size * world_size
    megabatches = [indices[i : i + mb] for i in range(0, len(indices), mb)]
    megabatches = [sorted(m, key=lambda i: lengths[i], reverse=True) for m in megabatches]
    return [i for m in megabatches for i in m]


def modality_grouped_indices(lengths, batch_size, world_size, rng: np.random.Generator):
    """Multimodal (length>0) and text-only (length<0) samples form separate
    megabatches; the two leftovers merge into one final batch
    (reference `vis_zephyr_trainer.py:145-190`)."""
    if all(l > 0 for l in lengths) or all(l < 0 for l in lengths):
        return length_grouped_indices([abs(l) for l in lengths], batch_size, world_size, rng)

    mm = [(i, l) for i, l in enumerate(lengths) if l > 0]
    lang = [(i, l) for i, l in enumerate(lengths) if l < 0]

    def shuffle_group(group):
        idx = [i for i, _ in group]
        lens = [abs(l) for _, l in group]
        order = length_grouped_indices(lens, batch_size, world_size, rng)
        return [idx[j] for j in order]

    mm_s, lang_s = shuffle_group(mm), shuffle_group(lang)
    mb = batch_size * world_size
    mm_mb = [mm_s[i : i + mb] for i in range(0, len(mm_s), mb)]
    lang_mb = [lang_s[i : i + mb] for i in range(0, len(lang_s), mb)]

    extra = (mm_mb[-1] if mm_mb else []) + (lang_mb[-1] if lang_mb else [])
    megabatches = (mm_mb[:-1] if mm_mb else []) + (lang_mb[:-1] if lang_mb else [])
    order = rng.permutation(len(megabatches))
    megabatches = [megabatches[i] for i in order]
    if extra:
        megabatches.append(sorted(extra))
    return [i for m in megabatches for i in m]


class LengthGroupedSampler:
    """Iterable of dataset indices, modality- and length-grouped."""

    def __init__(self, lengths, batch_size, world_size=1, group_by_modality=True, seed=0):
        self.lengths = lengths
        self.batch_size = batch_size
        self.world_size = world_size
        self.group_by_modality = group_by_modality
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.lengths)

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        if self.group_by_modality:
            return iter(modality_grouped_indices(self.lengths, self.batch_size, self.world_size, rng))
        return iter(length_grouped_indices(self.lengths, self.batch_size, self.world_size, rng))
