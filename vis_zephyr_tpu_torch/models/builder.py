"""Model loading: the `load_pretrained_model` surface, HF path.

Port of `vis_zephyr_tpu/models/builder.py` for the base + projector route:
`model_base` (an HF Zephyr/Mistral dir, safetensors or torch .bin shards) +
`vision_tower_path` (an HF CLIP dir) + `model_path/mm_projector.bin`. The
port's parameters carry HF names, so each part loads with
`load_state_dict(strict=True)` after its key prefix is stripped. safetensors
and transformers are imported lazily.

Not ported yet: the native orbax checkpoint (needs orbax), LoRA artifacts,
the consolidated single-dir checkpoint, and 8/4-bit loading.

Returns `(tokenizer, model, cfg, context_len)`.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Optional, Tuple

import torch

from vis_zephyr_tpu.config import VisZephyrConfig

from .vis_zephyr import VisZephyr

# HF CLIPVisionModel keys the tower does not use (it returns raw hidden states).
_UNUSED_VISION_KEYS = ("post_layernorm.weight", "post_layernorm.bias",
                       "embeddings.position_ids")


def _load_hf_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """All safetensors (or pytorch_model*.bin) shards of a directory."""
    sd: Dict[str, torch.Tensor] = {}
    safes = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if safes:
        from safetensors.torch import load_file

        for shard in safes:
            sd.update(load_file(shard))
        return sd
    for shard in sorted(glob.glob(os.path.join(model_dir, "pytorch_model*.bin"))):
        sd.update(torch.load(shard, map_location="cpu", weights_only=True))
    if not sd:
        raise FileNotFoundError(f"no safetensors/bin weights under {model_dir}")
    return sd


def _strip(sd: Dict, marker: str) -> Dict:
    """Keys after `marker` when any key carries it, else sd unchanged."""
    if any(marker in k for k in sd):
        return {k.split(marker, 1)[1]: v for k, v in sd.items() if marker in k}
    return sd


def _read_config(model_path: str) -> VisZephyrConfig:
    cfg_file = os.path.join(model_path, "config.json")
    if not os.path.exists(cfg_file):
        return VisZephyrConfig()
    with open(cfg_file) as f:
        raw = f.read()
    try:
        return VisZephyrConfig.from_json(raw)
    except TypeError:
        # An HF-style config: the defaults encode the released architecture,
        # but refuse one that plainly describes another model.
        declared = json.loads(raw).get("num_hidden_layers")
        cfg = VisZephyrConfig()
        if declared is not None and declared != cfg.decoder.num_layers:
            raise ValueError(f"{cfg_file} is an HF config for a {declared}-layer model; "
                             f"the defaults describe {cfg.decoder.num_layers} layers")
        return cfg


def load_pretrained_model(
    model_path: str,
    model_base: Optional[str] = None,
    vision_tower_path: Optional[str] = None,
    dtype: torch.dtype = torch.bfloat16,
    device="cuda",
) -> Tuple[object, VisZephyr, VisZephyrConfig, int]:
    if os.path.isdir(os.path.join(model_path, "state")):
        raise NotImplementedError(
            f"{model_path} is a native orbax checkpoint; the PyTorch port loads only "
            "HF weights (--model-base, --vision-tower, mm_projector.bin) so far")
    proj_bin = os.path.join(model_path, "mm_projector.bin")
    missing = [name for name, ok in (("--model-base", model_base),
                                     ("--vision-tower", vision_tower_path),
                                     (proj_bin, os.path.exists(proj_bin))) if not ok]
    if missing:
        raise FileNotFoundError(f"the HF load path needs {', '.join(missing)}")
    cfg = _read_config(model_path)

    model = VisZephyr(cfg, device="meta")
    parts = (
        (model.decoder, _load_hf_state_dict(model_base)),
        (model.vision, {k: v for k, v in _strip(_load_hf_state_dict(vision_tower_path),
                                                "vision_model.").items()
                        if k not in _UNUSED_VISION_KEYS}),
        (model.projector, _strip(torch.load(proj_bin, map_location="cpu", weights_only=True),
                                 "mm_projector.")),
    )
    for module, sd in parts:
        module.load_state_dict(sd, strict=True, assign=True)
    model = model.to(device=device, dtype=dtype).requires_grad_(False).eval()

    tokenizer = None
    try:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_base, use_fast=True)
    except Exception:  # noqa: BLE001 — the tokenizer is optional for weight-only use
        tokenizer = None
    return tokenizer, model, cfg, cfg.tokenizer_model_max_length
