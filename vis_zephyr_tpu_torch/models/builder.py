"""Model loading: the `load_pretrained_model` surface, HF path.

Port of `vis_zephyr_tpu/models/builder.py` for the base + projector route:
`model_base` (an HF Zephyr/Mistral dir, safetensors or torch .bin shards) +
`vision_tower_path` (an HF CLIP dir) + `model_path/mm_projector.bin`. The
port's parameters carry HF names, so each part loads with
`load_state_dict(strict=True)` after its key prefix is stripped. safetensors
and transformers are imported lazily.

`load_8bit` quantizes the decoder's and the Q-Former's projections to int8
weights with per-output-channel scales; `load_4bit` (which wins over
`load_8bit`) makes the decoder's int4 with group-128 scales and the
Q-Former's int8 (`ops/quant.py`, the reference's bitsandbytes options
mapped as in the JAX builder). Both run after the float weights are on the
device, one layer at a time.

Not ported yet: the port trainer's own checkpoint (`state/state.pt`), the
native orbax checkpoint (needs orbax), LoRA artifacts and the consolidated
single-dir checkpoint; a `state/` directory is refused under its form.

Returns `(tokenizer, model, cfg, context_len)`.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Optional, Tuple

import torch

from ..config import VisZephyrConfig

from ..ops.quant import quantize_decoder_layers, quantize_qformer
from ..train.checkpoints import state_form
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
    load_8bit: bool = False,
    load_4bit: bool = False,
) -> Tuple[object, VisZephyr, VisZephyrConfig, int]:
    state = os.path.join(model_path, "state")
    if os.path.isdir(state):
        form = state_form(state)
        if form == "torch":
            raise NotImplementedError(
                f"{model_path} holds the port trainer's own checkpoint ({state}/state.pt, "
                "train/checkpoints.py); serving it is not ported yet (ROADMAP.md, Queue A "
                "steps 1 and 5). The PyTorch port loads only HF weights (--model-base, "
                "--vision-tower, mm_projector.bin) so far")
        kind = ("a native orbax checkpoint" if form == "orbax" else
                "a checkpoint of another form (its state/ holds neither state.pt nor "
                "orbax's metadata)")
        raise NotImplementedError(
            f"{model_path} is {kind}; the PyTorch port loads only "
            "HF weights (--model-base, --vision-tower, mm_projector.bin) so far")
    cfg = _read_config(model_path)
    if cfg.mm_use_im_start_end or cfg.mm_use_im_patch_token:
        # The JAX builder adds <im_patch> / <im_start> / <im_end> to the
        # tokenizer and mean-extends the embeddings; refuse before any weight
        # is read rather than serve a misaligned vocabulary.
        raise NotImplementedError(
            "mm_use_im_start_end / mm_use_im_patch_token (the image-token alignment, "
            "initialize_vision_tokenizer) is not ported to PyTorch yet (ROADMAP.md, "
            "Queue A step 11)")
    proj_bin = os.path.join(model_path, "mm_projector.bin")
    missing = [name for name, ok in (("--model-base", model_base),
                                     ("--vision-tower", vision_tower_path),
                                     (proj_bin, os.path.exists(proj_bin))) if not ok]
    if missing:
        raise FileNotFoundError(f"the HF load path needs {', '.join(missing)}")

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
    if load_8bit or load_4bit:  # load_4bit wins, as in the JAX builder
        quantize_weights(model, bits=4 if load_4bit else 8)

    tokenizer = None
    try:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_base, use_fast=True)
    except Exception:  # noqa: BLE001 — the tokenizer is optional for weight-only use
        tokenizer = None
    return tokenizer, model, cfg, cfg.tokenizer_model_max_length


def quantize_weights(model: VisZephyr, bits: int = 8) -> VisZephyr:
    """`load_8bit` (`bits` 8) or `load_4bit` (`bits` 4) on a model already on
    its device: the decoder layers' q, k, v, o, gate, up and down in `bits`
    (int4 with group-128 scales) and the Q-Former's projections in int8, in
    place, each float weight freed as its layer is done. Returns the model."""
    quantize_decoder_layers(model.decoder, bits=bits)
    quantize_qformer(model.projector)
    return model
