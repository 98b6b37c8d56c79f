"""Mistral / Zephyr-7B-β decoder with a static-shape dense KV cache, PyTorch.

Port of `vis_zephyr_tpu/models/mistral.py` for the serving path: RMSNorm in
f32 → GQA attention with rotate-half RoPE (θ from the config) and an
optional sliding window → SiLU-gated MLP, final RMSNorm and an untied
lm_head. Parameters carry the HF `MistralForCausalLM` names
(`model.layers.{i}.self_attn.q_proj.weight`, ...), so
`hf_convert.convert_mistral` reads `state_dict()` as it is and HF
checkpoints load with `load_state_dict`.

The KV cache is a dict `{"k": [L,B,S,Hkv,D], "v": ..., "length": [B] int32}`.
`length[b]` is the number of valid slots of row b; decode writes at slot
`length[b]` and increments. The cache tensors are updated in place.

Not ported: LoRA dropout, multi-LoRA, remat and the fused qkv / gate_up
layout (`load_pretrained_model` does not fuse).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import DecoderConfig

from ..ops.attention import attention_mask, dot_product_attention
from ..ops.flash_attention import flash_attention
from ..ops.kv_cache import dense_cache_update


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for rotate-half RoPE. positions [B, T] → [B, T, D/2] f32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, T, H, D]; cos/sin [B, T, D/2], cast to x's dtype first."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, device=device, dtype=dtype))


class MistralAttention(nn.Module):
    def __init__(self, cfg: DecoderConfig, device=None, dtype=None):
        super().__init__()
        D, hd = cfg.hidden_size, cfg.head_dim
        self.q_proj = nn.Linear(D, cfg.num_heads * hd, bias=False, device=device, dtype=dtype)
        self.k_proj = nn.Linear(D, cfg.num_kv_heads * hd, bias=False, device=device, dtype=dtype)
        self.v_proj = nn.Linear(D, cfg.num_kv_heads * hd, bias=False, device=device, dtype=dtype)
        self.o_proj = nn.Linear(cfg.num_heads * hd, D, bias=False, device=device, dtype=dtype)


class MistralMLP(nn.Module):
    def __init__(self, cfg: DecoderConfig, device=None, dtype=None):
        super().__init__()
        D, I = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(D, I, bias=False, device=device, dtype=dtype)
        self.up_proj = nn.Linear(D, I, bias=False, device=device, dtype=dtype)
        self.down_proj = nn.Linear(I, D, bias=False, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class MistralDecoderLayer(nn.Module):
    def __init__(self, cfg: DecoderConfig, device=None, dtype=None):
        super().__init__()
        self.self_attn = MistralAttention(cfg, device, dtype)
        self.mlp = MistralMLP(cfg, device, dtype)
        self.input_layernorm = RMSNorm(cfg.hidden_size, device, dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, device, dtype)


class MistralModel(nn.Module):
    def __init__(self, cfg: DecoderConfig, device=None, dtype=None):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device, dtype=dtype)
        self.layers = nn.ModuleList(MistralDecoderLayer(cfg, device, dtype)
                                    for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, device, dtype)


class MistralForCausalLM(nn.Module):
    def __init__(self, cfg: DecoderConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.model = MistralModel(cfg, device, dtype)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                                 device=device, dtype=dtype)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> None:
        """Random weights: N(0, 0.02) embeddings and unit norms as in the JAX
        `init_mistral`, but N(0, 1/fan_in) projections. The JAX init's fixed
        0.02 gives each projection a gain of 0.02·sqrt(hidden), 1.28 at
        Zephyr-7B width, and a random 32-layer stack that amplifies rounding:
        its bf16 logits then differ from an f32 run of the same weights
        (cosine 0.9986 against 0.99988 with fan-in scaling, measured on an
        H100 80GB HBM3 at 700 W), which would hide what the kernels do."""
        for name, p in self.named_parameters():
            if "norm" in name:
                p.fill_(1.0)
            elif "embed_tokens" in name:
                p.normal_(0.0, 0.02, generator=generator)
            else:
                p.normal_(0.0, p.shape[1] ** -0.5, generator=generator)


def embed(decoder: MistralForCausalLM, input_ids: torch.Tensor) -> torch.Tensor:
    """Token ids → embeddings. Negative sentinel ids (image placeholders)
    are clamped to 0; callers overwrite those slots with image features."""
    return decoder.model.embed_tokens.weight[input_ids.clamp(min=0)]


def init_cache(cfg: DecoderConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> Dict[str, torch.Tensor]:
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _project_qkv(h, attn: MistralAttention, cfg: DecoderConfig, cos, sin):
    B, T, _ = h.shape
    q = attn.q_proj(h).reshape(B, T, cfg.num_heads, cfg.head_dim)
    k = attn.k_proj(h).reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    v = attn.v_proj(h).reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def mistral_forward(
    decoder: MistralForCausalLM,
    inputs_embeds: torch.Tensor,
    cfg: DecoderConfig,
    positions: torch.Tensor,
    attn_valid: Optional[torch.Tensor] = None,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    logits_slice: str = "all",  # "all" | "last"
    return_kv: bool = False,
) -> Tuple[torch.Tensor, Optional[object]]:
    """Run the decoder stack.

    Two modes:
      - cache=None: self-contained forward over [B, T] (prefill). Mask =
        causal ∧ sliding-window ∧ attn_valid. Attention runs through the
        flash kernel K1 on a CUDA device when T % 128 == 0, head_dim % 128
        == 0 and T fits the sliding window, the masked plain op otherwise. With `return_kv=True` the per-layer K/V are
        returned too, stacked [L, B, T, Hkv, D].
      - cache given: appends T tokens at slots `cache.length[b] + arange(T)`
        (`dense_cache_update`, kernel K2) and attends against the
        whole cache buffer with plain attention.

    Returns (logits f32, new_cache_or_kv).
    """
    B, T, _ = inputs_embeds.shape
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    layers = decoder.model.layers
    h = inputs_embeds

    if cache is None:
        if (h.device.type == "cuda" and T % 128 == 0 and cfg.head_dim % 128 == 0
                and (cfg.sliding_window is None or T <= cfg.sliding_window)):
            kv_valid = (torch.ones((B, T), dtype=torch.bool, device=h.device)
                        if attn_valid is None else attn_valid.bool().contiguous())

            def attend(q, k, v):
                return flash_attention(q, k, v, kv_valid=kv_valid, causal=True)
        else:
            mask = attention_mask(positions, positions, kv_valid=attn_valid, causal=True,
                                  sliding_window=cfg.sliding_window)

            def attend(q, k, v):
                return dot_product_attention(q, k, v, mask=mask)

        ks, vs = [], []
        for layer in layers:
            hn = rms_norm(h, layer.input_layernorm.weight, cfg.rms_norm_eps)
            q, k, v = _project_qkv(hn, layer.self_attn, cfg, cos, sin)
            attn = attend(q, k, v)
            h = h + layer.self_attn.o_proj(attn.reshape(B, T, -1))
            hn = rms_norm(h, layer.post_attention_layernorm.weight, cfg.rms_norm_eps)
            h = h + layer.mlp(hn)
            if return_kv:
                ks.append(k)
                vs.append(v)
        new_cache = (torch.stack(ks), torch.stack(vs)) if return_kv else None
    else:
        ck, cv = cache["k"], cache["v"]
        S = ck.shape[2]
        lengths = cache["length"]  # [B] int32
        dev = h.device
        slot = lengths[:, None].long() + torch.arange(T, device=dev)[None, :]  # [B, T]
        new_valid = (torch.ones((B, T), dtype=torch.bool, device=dev)
                     if attn_valid is None else attn_valid.bool())
        # Masks come from slot validity + causality in slot order (slots are
        # written in position order, so slot order == position order).
        slot_ids = torch.arange(S, device=dev)[None, :]
        kv_valid_slots = slot_ids < (lengths[:, None] + T)
        mask = attention_mask(slot, slot_ids.expand(B, S), kv_valid=kv_valid_slots,
                              causal=True, sliding_window=cfg.sliding_window)
        # Padded new tokens are attended by no one.
        pad_slots = torch.ones((B, S), dtype=torch.bool, device=dev)
        rows = torch.arange(B, device=dev)[:, None].expand(B, T)
        inside = slot < S
        pad_slots[rows[inside], slot[inside]] = new_valid[inside]
        mask &= pad_slots[:, None, :]

        for i, layer in enumerate(layers):
            hn = rms_norm(h, layer.input_layernorm.weight, cfg.rms_norm_eps)
            q, k, v = _project_qkv(hn, layer.self_attn, cfg, cos, sin)
            dense_cache_update(ck, cv, k, v, lengths, i)
            attn = dot_product_attention(q, ck[i].to(q.dtype), cv[i].to(q.dtype), mask=mask)
            h = h + layer.self_attn.o_proj(attn.reshape(B, T, -1))
            hn = rms_norm(h, layer.post_attention_layernorm.weight, cfg.rms_norm_eps)
            h = h + layer.mlp(hn)
        new_cache = {
            "k": ck,
            "v": cv,
            "length": lengths + new_valid.sum(dim=1).to(lengths.dtype),
        }

    h = rms_norm(h, decoder.model.norm.weight, cfg.rms_norm_eps)
    if logits_slice == "last":
        h = h[:, -1:, :]
    return decoder.lm_head(h).float(), new_cache
