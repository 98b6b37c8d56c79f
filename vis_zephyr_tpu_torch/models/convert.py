"""Weight bridge: a JAX parameter pytree → the port's HF-named state dict.

The inverse of `vis_zephyr_tpu/models/hf_convert.py`. The JAX tree has numpy
leaves, per-layer parameters stacked on a leading [L] axis, dense kernels
stored [in, out] and the CLIP patch kernel stored [ph*pw*3, D]; the port
keeps torch's [out, in] weights and HF's conv layout [D, 3, ph, pw]. The
result loads into `VisZephyr` with `load_state_dict(strict=True)`.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from vis_zephyr_tpu.config import DecoderConfig, ProjectorConfig, VisionConfig, VisZephyrConfig


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x))


def _linear(out: Dict, prefix: str, p: Mapping, i=None) -> None:
    kernel = p["kernel"] if i is None else p["kernel"][i]
    out[f"{prefix}.weight"] = _t(np.asarray(kernel).T)
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"] if i is None else p["bias"][i])


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
            w = [np.asarray(a[x]["kernel"][i]).T for x in ("q", "k", "v")]
            if kv_dim == cfg.hidden_size:
                out[f"{pre}.{name}.in_proj_weight"] = _t(np.concatenate(w, axis=0))
            else:
                for x, wx in zip(("q", "k", "v"), w):
                    out[f"{pre}.{name}.{x}_proj_weight"] = _t(wx)
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
