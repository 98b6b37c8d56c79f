"""Model loading: the `load_pretrained_model` surface.

Port of `vis_zephyr_tpu/models/builder.py`. Its load paths, tried in the JAX
order:

(a) `model_path/state/` that the port's trainer wrote
    (`train/checkpoints.py`, `state/state.pt`): a params-only state dict or
    a full train state ({"params", "opt_state", "step"}). The file is read
    with `torch.load(mmap=True)` into a model built on the `meta` device
    (`load_state_dict(assign=True)`), so host memory never holds a second
    copy and `opt_state` is never read; the decoder's tables are sized from
    the saved tensors (a resized checkpoint has more rows than its config).
    LoRA adapters are merged on the device by `train/lora.py::merge_lora`
    (the reference's merge_and_unload) in the saved dtype, then floating
    tensors are cast to `dtype`. A `state/` that orbax wrote is refused by
    name: `scripts/export_orbax_to_torch.py` turns it into this form.
(b) The reference's stage-2 artifact: `model_path` holds a peft adapter dir
    (`adapter_config.json`, `adapter_model.safetensors|bin`) and
    `non_lora_trainables.bin`, `model_base` the HF decoder. The projector
    (and a saved `embed_tokens` / `lm_head`) come from the non-LoRA file,
    the adapters are merged on the device.
(c) HF weights: `model_base` (an HF Zephyr/Mistral dir, safetensors or
    torch .bin shards), `vision_tower_path` (an HF CLIP dir) and
    `model_path/mm_projector.bin`.
(d) The consolidated single-dir checkpoint: one HF-style dir at
    `model_path` with the decoder, `mm_projector.*` and `vision_tower.*`
    keys.

The port's parameters carry HF names, so each part loads with
`load_state_dict(strict=True)` after its key prefix is stripped.
safetensors and transformers are imported lazily. Departures: routes (b)
and (c) need `vision_tower_path` (the JAX builder leaves the tower out of
its tree when none is given; a port model is whole), and (d) needs all
three parts in the dir.

The tokenizer comes from `tokenizer_path or model_base or model_path`:
with `VZT_NATIVE_TOKENIZER=1` the port's C++ BPE tokenizer
(`data/tokenizer_native.py`, which needs no Python tokenizer package; not
under the image-token flags, and with a warning and HF's in its place where
the library does not build), else HF's `AutoTokenizer`. Checkpoints trained
with `mm_use_im_start_end` / `mm_use_im_patch_token` get the tokenizer and
tables aligned by `initialize_vision_tokenizer`; the returned config's
`decoder.vocab_size` always equals the tables' rows (the JAX package reads
it from its parameters; the port sizes buffers from the config).

`load_8bit` quantizes the decoder's and the Q-Former's projections to int8
weights with per-output-channel scales; `load_4bit` (which wins over
`load_8bit`) makes the decoder's int4 with group-128 scales and the
Q-Former's int8 (`ops/quant.py`, the reference's bitsandbytes options
mapped as in the JAX builder). Both run after the merge, on the device, one
layer at a time.

Not ported yet: multi-LoRA packs (`load_lora_pack`, ROADMAP.md Queue A
step 10).

Returns `(tokenizer, model, cfg, context_len)`.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import warnings
from typing import Dict, Optional, Tuple

import torch

from ..config import VisZephyrConfig

from ..ops.quant import quantize_decoder_layers, quantize_qformer
from ..train.checkpoints import state_form
from ..train.lora import attach_lora, merge_lora
from .convert import clean_non_lora, lora_from_peft
from .vis_zephyr import VisZephyr, initialize_vision_tokenizer, with_vocab

# HF CLIPVisionModel keys the tower does not use (it returns raw hidden states).
_UNUSED_VISION_KEYS = ("post_layernorm.weight", "post_layernorm.bias",
                       "embeddings.position_ids")
# Files one of which an HF tokenizer dir holds.
_EMBED = "model.embed_tokens.weight"
_HEAD = "lm_head.weight"


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
        sd.update(torch.load(shard, map_location="cpu", mmap=True, weights_only=True))
    if not sd:
        raise FileNotFoundError(f"no safetensors/bin weights under {model_dir}")
    return sd


def _strip(sd: Dict, marker: str) -> Dict:
    """Keys after `marker` when any key carries it, else sd unchanged."""
    if any(marker in k for k in sd):
        return {k.split(marker, 1)[1]: v for k, v in sd.items() if marker in k}
    return sd


def _vision(sd: Dict) -> Dict:
    """An HF CLIPVisionModel state dict as the tower's keys."""
    return {k: v for k, v in _strip(sd, "vision_model.").items() if k not in _UNUSED_VISION_KEYS}


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


def _sized(cfg: VisZephyrConfig, decoder_sd: Dict) -> VisZephyrConfig:
    """`cfg` with the vocabulary of the saved embedding table."""
    rows = decoder_sd[_EMBED].shape[0] if _EMBED in decoder_sd else cfg.decoder.vocab_size
    return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, vocab_size=rows))


def _meta_model(cfg: VisZephyrConfig, parts: Dict[str, Dict], adapters=None) -> VisZephyr:
    """A `VisZephyr` on `meta` whose parts take the given state dicts' tensors
    as they are (`assign=True`), LoRA-wrapped where `adapters` (module name →
    r) says."""
    model = VisZephyr(cfg, device="meta")
    for name, r in (adapters or {}).items():
        base = model.get_submodule(name)
        shapes = {"lora_a": (base.in_features, r), "lora_b": (r, base.out_features),
                  "lora_scale": ()}
        attach_lora(model, {name: {k: torch.empty(shape, device="meta", dtype=base.weight.dtype)
                                   for k, shape in shapes.items()}})
    for name, sd in parts.items():
        getattr(model, name).load_state_dict(sd, strict=True, assign=True)
    return model


def _load_port_state(model_path: str, cfg: VisZephyrConfig, dtype, device) -> VisZephyr:
    """Route (a): `state/state.pt` as the port's trainer wrote it."""
    saved = torch.load(os.path.join(model_path, "state", "state.pt"), map_location="cpu",
                       mmap=True, weights_only=True)
    sd = saved["params"] if "params" in saved else saved
    parts = {name: {k[len(name) + 1:]: v for k, v in sd.items() if k.startswith(name + ".")}
             for name in ("vision", "projector", "decoder")}
    adapters = {k[:-len(".lora_a")]: v.shape[-1] for k, v in sd.items() if k.endswith(".lora_a")}
    model = _meta_model(_sized(cfg, parts["decoder"]), parts, adapters)
    model = merge_lora(model.to(device))
    return model.to(dtype=dtype)


def _read_adapter(model_path: str, num_layers: int, dtype) -> Dict:
    """One peft adapter dir → `lora_from_peft`'s adapters (r and α from
    `adapter_config.json`, else the reference's finetune defaults)."""
    r, alpha = 128, 256.0
    acfg_path = os.path.join(model_path, "adapter_config.json")
    if os.path.exists(acfg_path):
        with open(acfg_path) as f:
            acfg = json.load(f)
        r = int(acfg.get("r", r))
        alpha = float(acfg.get("lora_alpha", alpha))
    afile = next((p for p in (os.path.join(model_path, "adapter_model.safetensors"),
                              os.path.join(model_path, "adapter_model.bin"))
                  if os.path.exists(p)), None)
    if afile is None:
        raise FileNotFoundError(f"no adapter_model.(safetensors|bin) under {model_path}")
    if afile.endswith(".safetensors"):
        from safetensors.torch import load_file

        asd = load_file(afile)
    else:
        asd = torch.load(afile, map_location="cpu", weights_only=True)
    return lora_from_peft(asd, num_layers, r=r, alpha=alpha, dtype=dtype)


def _load_lora_artifact(model_path: str, model_base: str, vision_tower_path: Optional[str],
                        cfg: VisZephyrConfig, dtype, device) -> VisZephyr:
    """Route (b): the HF base decoder, the non-LoRA trainables over it (the
    projector; a saved `embed_tokens` or `lm_head` replaces the decoder's
    table), the adapters attached and merged on the device in `dtype`."""
    if not vision_tower_path:
        raise FileNotFoundError("the LoRA-artifact load path needs --vision-tower")
    decoder = _load_hf_state_dict(model_base)
    projector = None
    nlt_path = os.path.join(model_path, "non_lora_trainables.bin")
    if os.path.exists(nlt_path):
        nlt = clean_non_lora(torch.load(nlt_path, map_location="cpu", weights_only=True))
        if any("mm_projector." in k for k in nlt):
            projector = _strip(nlt, "mm_projector.")
        for key, suffix in ((_EMBED, "embed_tokens.weight"), (_HEAD, "lm_head.weight")):
            found = next((k for k in nlt if k.endswith(suffix)), None)
            if found is not None:  # a resized-embedding finetune's table
                decoder[key] = nlt[found]
    if projector is None:
        raise FileNotFoundError(f"no mm_projector weights in {nlt_path}")
    cfg = _sized(cfg, decoder)
    model = _meta_model(cfg, {"decoder": decoder, "projector": projector,
                              "vision": _vision(_load_hf_state_dict(vision_tower_path))})
    model = model.to(device=device, dtype=dtype)
    adapters = _read_adapter(model_path, cfg.decoder.num_layers, dtype)
    return merge_lora(attach_lora(model, {name: {k: v.to(device) for k, v in parts.items()}
                                          for name, parts in adapters.items()}))


def _load_hf(model_path: str, model_base: Optional[str], vision_tower_path: Optional[str],
             cfg: VisZephyrConfig, dtype, device) -> VisZephyr:
    """Route (c): base + tower + `mm_projector.bin`, each required."""
    proj_bin = os.path.join(model_path, "mm_projector.bin")
    missing = [name for name, ok in (("--model-base", model_base),
                                     ("--vision-tower", vision_tower_path),
                                     (proj_bin, os.path.exists(proj_bin))) if not ok]
    if missing:
        raise FileNotFoundError(f"the HF load path needs {', '.join(missing)}")
    decoder = _load_hf_state_dict(model_base)
    model = _meta_model(_sized(cfg, decoder), {
        "decoder": decoder,
        "vision": _vision(_load_hf_state_dict(vision_tower_path)),
        "projector": _strip(torch.load(proj_bin, map_location="cpu", weights_only=True),
                            "mm_projector."),
    })
    return model.to(device=device, dtype=dtype)


def _load_consolidated(model_path: str, cfg: VisZephyrConfig, dtype, device) -> VisZephyr:
    """Route (d): keys with `vision_tower.` go to the tower, keys with
    `mm_projector.` to the projector, the rest to the decoder."""
    try:
        sd = _load_hf_state_dict(model_path)
    except FileNotFoundError:
        raise FileNotFoundError(
            f"{model_path}: neither a checkpoint of the port's trainer (state/state.pt), a "
            "LoRA artifact (+ --model-base), HF weights (--model-base, --vision-tower, "
            "mm_projector.bin) nor a consolidated checkpoint found") from None
    decoder = {k: v for k, v in sd.items()
               if "mm_projector." not in k and "vision_tower." not in k}
    tower = {k.rsplit("vision_tower.", 1)[1]: v for k, v in sd.items() if "vision_tower." in k}
    projector = {k: v for k, v in sd.items() if "mm_projector." in k}
    missing = [name for name, part in (("vision_tower.*", tower),
                                       ("mm_projector.*", projector)) if not part]
    if missing:
        raise FileNotFoundError(f"{model_path}: the consolidated checkpoint has no "
                                f"{' or '.join(missing)} weights")
    model = _meta_model(_sized(cfg, decoder), {
        "decoder": decoder, "vision": _vision(tower),
        "projector": _strip(projector, "mm_projector.")})
    return model.to(device=device, dtype=dtype)


def _load_tokenizer(src: str, cfg: VisZephyrConfig):
    if os.environ.get("VZT_NATIVE_TOKENIZER") == "1" and not (
            cfg.mm_use_im_start_end or cfg.mm_use_im_patch_token):
        # The image-placeholder tokens need HF's added-token machinery.
        try:
            from ..data.tokenizer_native import NativeTokenizer

            return NativeTokenizer(model_dir=src, bos_token_id=cfg.decoder.bos_token_id,
                                   eos_token_id=cfg.decoder.eos_token_id,
                                   pad_token_id=cfg.decoder.pad_token_id,
                                   model_max_length=cfg.tokenizer_model_max_length)
        except Exception as e:  # noqa: BLE001 — fall back to HF below
            warnings.warn(f"native tokenizer unavailable ({e}); using HF")
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(src, use_fast=True)
    except Exception:  # noqa: BLE001 — the tokenizer is optional for weight-only use
        return None


def load_pretrained_model(
    model_path: str,
    model_base: Optional[str] = None,
    vision_tower_path: Optional[str] = None,
    dtype: torch.dtype = torch.bfloat16,
    device="cuda",
    load_8bit: bool = False,
    load_4bit: bool = False,
    tokenizer_path: Optional[str] = None,
) -> Tuple[object, VisZephyr, VisZephyrConfig, int]:
    cfg = _read_config(model_path)
    tokenizer = _load_tokenizer(tokenizer_path or model_base or model_path, cfg)

    state = os.path.join(model_path, "state")
    if os.path.isdir(state):
        form = state_form(state)
        if form != "torch":
            kind = ("a native orbax checkpoint" if form == "orbax" else
                    "a checkpoint of another form (its state/ holds neither state.pt nor "
                    "orbax's metadata)")
            raise NotImplementedError(
                f"{model_path} is {kind}; the PyTorch port reads the torch.save layout "
                "(state/state.pt) its trainer writes: convert an orbax checkpoint with "
                "`python scripts/export_orbax_to_torch.py --model-path DIR --out DIR`")
        model = _load_port_state(model_path, cfg, dtype, device)
    elif glob.glob(os.path.join(model_path, "adapter_model.*")) and model_base:
        model = _load_lora_artifact(model_path, model_base, vision_tower_path, cfg, dtype,
                                    device)
    elif (model_base or vision_tower_path
          or os.path.exists(os.path.join(model_path, "mm_projector.bin"))):
        model = _load_hf(model_path, model_base, vision_tower_path, cfg, dtype, device)
    else:
        model = _load_consolidated(model_path, cfg, dtype, device)
    model = model.requires_grad_(False).eval()
    cfg = with_vocab(model, cfg)

    # Checkpoints trained with image placeholder tokens need the tokenizer
    # and tables aligned at load (reference `builder.py:140-153`); no rows
    # are added where the saved tables were already resized.
    if tokenizer is not None and (cfg.mm_use_im_start_end or cfg.mm_use_im_patch_token):
        cfg, _ = initialize_vision_tokenizer(model, tokenizer, cfg,
                                             mm_use_im_patch_token=cfg.mm_use_im_patch_token,
                                             mm_use_im_start_end=cfg.mm_use_im_start_end)
    if load_8bit or load_4bit:  # load_4bit wins, as in the JAX builder
        quantize_weights(model, bits=4 if load_4bit else 8)
    return tokenizer, model, cfg, cfg.tokenizer_model_max_length


def quantize_weights(model: VisZephyr, bits: int = 8) -> VisZephyr:
    """`load_8bit` (`bits` 8) or `load_4bit` (`bits` 4) on a model already on
    its device: the decoder layers' q, k, v, o, gate, up and down in `bits`
    (int4 with group-128 scales) and the Q-Former's projections in int8, in
    place, each float weight freed as its layer is done. Returns the model."""
    quantize_decoder_layers(model.decoder, bits=bits)
    quantize_qformer(model.projector)
    return model
