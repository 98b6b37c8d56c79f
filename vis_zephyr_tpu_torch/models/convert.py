"""Weight bridge: a JAX parameter pytree → the port's HF-named state dict.

The inverse of `vis_zephyr_tpu/models/hf_convert.py`. The JAX tree has numpy
leaves, per-layer parameters stacked on a leading [L] axis, dense kernels
stored [in, out] and the CLIP patch kernel stored [ph*pw*3, D]; the port
keeps torch's [out, in] weights and HF's conv layout [D, 3, ph, pw]. The
result loads into `VisZephyr` with `load_state_dict(strict=True)`. A tree
quantized by the JAX package's `quantize_decoder_layers(bits=8)` and
`quantize_qformer` (`{"kernel_q" [in, out], "scale" [1, out]}` leaves) gives
`weight_q` int8 [out, in] and `scale` [out] entries; one quantized by
`quantize_decoder_layers(bits=4)` (`{"kernel_q4" [in/2, out], "scale4"
[G, out]}`) gives `weight_q4` [out, in/2] and `scale4` [out, G]. Either
loads into a model quantized by the port's `ops.quant` the same way. A
stage-2 tree's LoRA leaves (`lora_a` [in, r], `lora_b` [r, out],
`lora_scale`, stacked per layer) give `{name}.lora_a`, `.lora_b` and
`.lora_scale` in the same orientation; they load into a model whose
projections `train/lora.py::add_lora` wrapped.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..config import DecoderConfig, ProjectorConfig, VisionConfig, VisZephyrConfig


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x))


def _pick(x, i=None) -> np.ndarray:
    return np.asarray(x if i is None else x[i])


def _weight(out: Dict, name: str, p: Mapping, i=None) -> None:
    """A dense kernel [in, out] as `{name}` [out, in]; an int8 one
    (`{"kernel_q", "scale"}`) as `{name}_q` int8 [out, in] and its scales
    [1, out] as [out] under `name` with "weight" replaced by "scale"
    (`out_proj.weight` → `out_proj.scale`, `q_proj_weight` → `q_proj_scale`);
    an int4 one (`{"kernel_q4", "scale4"}`) as `{name}_q4` [out, in/2] and
    its scales [G, out] as `...scale4` [out, G]."""
    if "kernel_q4" in p:
        out[f"{name}_q4"] = _t(_pick(p["kernel_q4"], i).T)
        out[name[:-len("weight")] + "scale4"] = _t(_pick(p["scale4"], i).T)
    elif "kernel_q" in p:
        out[f"{name}_q"] = _t(_pick(p["kernel_q"], i).T)
        out[name[:-len("weight")] + "scale"] = _t(_pick(p["scale"], i)[0])
    else:
        out[name] = _t(_pick(p["kernel"], i).T)


def _linear(out: Dict, prefix: str, p: Mapping, i=None) -> None:
    _weight(out, f"{prefix}.weight", p, i)
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(_pick(p["bias"], i))
    for leaf in ("lora_a", "lora_b", "lora_scale"):
        if leaf in p:
            out[f"{prefix}.{leaf}"] = _t(_pick(p[leaf], i))


def _norm(out: Dict, prefix: str, p: Mapping, i=None, bias: bool = True) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"] if i is None else p["scale"][i])
    if bias:
        out[f"{prefix}.bias"] = _t(p["bias"] if i is None else p["bias"][i])


def vision_state_dict(params: Mapping, cfg: VisionConfig) -> Dict[str, torch.Tensor]:
    emb = params["embeddings"]
    p = cfg.patch_size
    patch = np.asarray(emb["patch_kernel"]).reshape(p, p, 3, -1).transpose(3, 2, 0, 1)
    out = {
        "embeddings.class_embedding": _t(emb["class_embedding"]),
        "embeddings.patch_embedding.weight": _t(patch),
        "embeddings.position_embedding.weight": _t(emb["position_embedding"]),
    }
    _norm(out, "pre_layrnorm", params["pre_ln"])
    lp = params["layers"]
    for i in range(cfg.num_layers):
        pre = f"encoder.layers.{i}"
        _norm(out, f"{pre}.layer_norm1", lp["ln1"], i)
        _norm(out, f"{pre}.layer_norm2", lp["ln2"], i)
        for name in ("q", "k", "v", "out"):
            _linear(out, f"{pre}.self_attn.{name}_proj", lp["attn"][name], i)
        _linear(out, f"{pre}.mlp.fc1", lp["fc1"], i)
        _linear(out, f"{pre}.mlp.fc2", lp["fc2"], i)
    return out


def qformer_state_dict(params: Mapping, cfg: ProjectorConfig) -> Dict[str, torch.Tensor]:
    out = {"learned_queries": _t(params["queries"])}
    _norm(out, "pre_norm", params["pre_norm"])
    _norm(out, "norm", params["final_norm"])
    bp = params["blocks"]
    for i in range(cfg.num_blocks):
        pre = f"blocks.{i}"
        for n in ("norm1", "norm2", "norm3"):
            _norm(out, f"{pre}.{n}", bp[n], i)
        for name, kv_dim in (("self_attn", cfg.hidden_size), ("cross_attn", cfg.visual_hidden_size)):
            a = bp[name]
            if kv_dim == cfg.hidden_size:  # packed: q, k and v stacked along out
                parts = [{} for _ in range(3)]
                for part, x in zip(parts, ("q", "k", "v")):
                    _weight(part, "in_proj_weight", a[x], i)
                for key in parts[0]:
                    out[f"{pre}.{name}.{key}"] = torch.cat([part[key] for part in parts])
            else:
                for x in ("q", "k", "v"):
                    _weight(out, f"{pre}.{name}.{x}_proj_weight", a[x], i)
            out[f"{pre}.{name}.in_proj_bias"] = _t(
                np.concatenate([np.asarray(a[x]["bias"][i]) for x in ("q", "k", "v")]))
            _linear(out, f"{pre}.{name}.out_proj", a["out"], i)
        _linear(out, f"{pre}.ffn.0", bp["fc1"], i)
        _linear(out, f"{pre}.ffn.2", bp["fc2"], i)
    return out


def mistral_state_dict(params: Mapping, cfg: DecoderConfig) -> Dict[str, torch.Tensor]:
    out = {
        "model.embed_tokens.weight": _t(params["embed_tokens"]),
        "model.norm.weight": _t(params["final_ln"]["scale"]),
        "lm_head.weight": _t(np.asarray(params["lm_head"]["kernel"]).T),
    }
    lp = params["layers"]
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}"
        _norm(out, f"{pre}.input_layernorm", lp["input_ln"], i, bias=False)
        _norm(out, f"{pre}.post_attention_layernorm", lp["post_attn_ln"], i, bias=False)
        for name, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("out", "o_proj")):
            _linear(out, f"{pre}.self_attn.{hf}", lp["attn"][name], i)
        for name in ("gate", "up", "down"):
            _linear(out, f"{pre}.mlp.{name}_proj", lp["mlp"][name], i)
    return out


def state_dict_from_jax(params_np: Mapping, cfg: VisZephyrConfig) -> Dict[str, torch.Tensor]:
    """{"vision", "projector", "decoder"} JAX params (numpy leaves) → the
    `VisZephyr` state dict ("vision.*", "projector.*", "decoder.*")."""
    out = {}
    parts = (("vision", vision_state_dict, cfg.vision),
             ("projector", qformer_state_dict, cfg.projector),
             ("decoder", mistral_state_dict, cfg.decoder))
    for name, fn, sub_cfg in parts:
        out.update({f"{name}.{k}": v for k, v in fn(params_np[name], sub_cfg).items()})
    return out
