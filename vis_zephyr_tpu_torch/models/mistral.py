"""Mistral / Zephyr-7B-β decoder with a static-shape dense KV cache, PyTorch.

Port of `vis_zephyr_tpu/models/mistral.py`, for serving and training: RMSNorm in
f32 → GQA attention with rotate-half RoPE (θ from the config) and an
optional sliding window → SiLU-gated MLP, final RMSNorm and an untied
lm_head. Parameters carry the HF `MistralForCausalLM` names
(`model.layers.{i}.self_attn.q_proj.weight`, ...), so
`hf_convert.convert_mistral` reads `state_dict()` as it is and HF
checkpoints load with `load_state_dict`.

The KV cache is a dict `{"k": [L,B,S,Hkv,D], "v": ..., "length": [B] int32}`.
`length[b]` is the number of valid slots of row b; decode writes at slot
`length[b]` and increments. The cache tensors, `length` included, are
updated in place.

Training (`cache=None`): each decoder layer may run under
`torch.utils.checkpoint` (`remat`, the JAX `jax.checkpoint` of the scan
body), and LoRA adapters (`train/lora.py::LoraLinear` in place of a
projection) may drop their branch's input (`lora_dropout`, peft semantics).
Each dropout mask is drawn from a generator seeded from (dropout_rng, layer,
projection), as the JAX package folds keys in, never from a generator that
advances: the recompute in the backward pass then draws the same masks.

Not ported: multi-LoRA and the fused qkv / gate_up layout
(`load_pretrained_model` does not fuse).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import DecoderConfig

from ..ops.attention import attention_mask, dot_product_attention
from ..ops.flash_attention import flash_attention
from ..ops.kv_cache import apply_rope, dense_cache_update_rope


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


def new_token_mask(lengths: torch.Tensor, new_valid: torch.Tensor, S: int) -> torch.Tensor:
    """Bool [B, S]: False at the cache slots where an appended token that is
    not valid lands (slot `lengths[b] + t` for `new_valid[b, t]` False),
    True elsewhere. Fixed-shape ops (a gather at clamped offsets) and no
    boolean indexing, which would sync the host and could not be captured
    in a CUDA graph."""
    T = new_valid.shape[1]
    offs = torch.arange(S, device=lengths.device)[None, :] - lengths[:, None].long()
    is_new = (offs >= 0) & (offs < T)
    return ~is_new | torch.gather(new_valid, 1, offs.clamp(0, T - 1))


_MASK64 = (1 << 64) - 1


def fold_seed(seed: int, *data: int) -> int:
    """A 63-bit seed mixed from `seed` and `data` (splitmix64 per item): the
    port's `jax.random.fold_in`. Equal inputs give equal seeds, so a mask
    drawn from `torch.Generator().manual_seed(fold_seed(...))` is the same
    in a layer's forward and in its recompute under `checkpoint`."""
    x = seed & _MASK64
    for d in data:
        x = (x + 0x9E3779B97F4A7C15 + (d & _MASK64)) & _MASK64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
        x ^= x >> 31
    return x >> 1


def _plain_proj(module: nn.Module, x: torch.Tensor, index: int) -> torch.Tensor:
    return module(x)


def _dropout_proj(layer_seed: int, rate: float) -> Callable:
    """Projection `index` (q, k, v, o, gate, up, down = 0..6) of a layer whose
    dropout seed is `layer_seed`: a LoRA projection drops its branch's input
    with a mask from its own seed; any other is applied as it is."""
    def proj(module: nn.Module, x: torch.Tensor, index: int) -> torch.Tensor:
        if getattr(module, "lora_a", None) is None:
            return module(x)
        return module(x, dropout=(fold_seed(layer_seed, index), rate))
    return proj


def _project_qkv(h, attn: MistralAttention, cfg: DecoderConfig, cos, sin,
                 proj: Callable = _plain_proj, rotate_k: bool = True):
    """(q, k, v) [B, T, heads, D], q rotated; k rotated unless `rotate_k` is
    False (the dense-cache forward, whose K2 launch rotates it)."""
    B, T, _ = h.shape
    q = proj(attn.q_proj, h, 0).reshape(B, T, cfg.num_heads, cfg.head_dim)
    k = proj(attn.k_proj, h, 1).reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    v = proj(attn.v_proj, h, 2).reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    return apply_rope(q, cos, sin), (apply_rope(k, cos, sin) if rotate_k else k), v


def _decoder_layer(layer: MistralDecoderLayer, h, cfg: DecoderConfig, cos, sin,
                   attend: Callable, proj: Callable = _plain_proj):
    """One layer of the `cache=None` forward: (h_out, k, v)."""
    B, T, _ = h.shape
    hn = rms_norm(h, layer.input_layernorm.weight, cfg.rms_norm_eps)
    q, k, v = _project_qkv(hn, layer.self_attn, cfg, cos, sin, proj)
    h = h + proj(layer.self_attn.o_proj, attend(q, k, v).reshape(B, T, -1), 3)
    hn = rms_norm(h, layer.post_attention_layernorm.weight, cfg.rms_norm_eps)
    mlp = layer.mlp
    inter = F.silu(proj(mlp.gate_proj, hn, 4)) * proj(mlp.up_proj, hn, 5)
    return h + proj(mlp.down_proj, inter, 6), k, v


def mistral_forward(
    decoder: MistralForCausalLM,
    inputs_embeds: torch.Tensor,
    cfg: DecoderConfig,
    positions: torch.Tensor,
    attn_valid: Optional[torch.Tensor] = None,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    logits_slice: str = "all",  # "all" | "last"
    return_kv: bool = False,
    remat: bool = False,
    lora_dropout: float = 0.0,
    dropout_rng: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[object]]:
    """Run the decoder stack.

    Two modes:
      - cache=None: self-contained forward over [B, T] (prefill). Mask =
        causal ∧ sliding-window ∧ attn_valid. Attention runs through the
        flash kernel K1 on a CUDA device when T % 128 == 0, head_dim % 128
        == 0 and T fits the sliding window, the masked plain op otherwise
        (flash is differentiable: K7 and K8 in the backward pass). With
        `return_kv=True` the per-layer K/V are returned too, stacked
        [L, B, T, Hkv, D]. Training: `remat` checkpoints each layer while
        gradients are on; `lora_dropout` > 0 with an integer `dropout_rng`
        drops each LoRA branch's input (mask seeds fold in the layer and the
        projection).
      - cache given: appends T tokens at slots `cache.length[b] + arange(T)`
        (`dense_cache_update_rope`: kernel K2, which also applies K's RoPE,
        one launch a layer) and attends against the whole cache buffer with
        plain attention. `cache["length"]` advances IN PLACE by the valid
        new tokens (the returned cache holds the same tensors), and nothing
        on this branch syncs the host, so a decode step can be captured as
        a CUDA graph (`serve/graphs.py`).

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

        use_dropout = lora_dropout > 0.0 and dropout_rng is not None
        ks, vs = [], []
        for i, layer in enumerate(layers):
            proj = (_dropout_proj(fold_seed(dropout_rng, i), lora_dropout) if use_dropout
                    else _plain_proj)
            if remat and torch.is_grad_enabled():
                # Masks come from seeds, not from the default generators, so
                # the recompute needs no RNG state stashed.
                h, k, v = checkpoint(_decoder_layer, layer, h, cfg, cos, sin, attend, proj,
                                     use_reentrant=False, preserve_rng_state=False)
            else:
                h, k, v = _decoder_layer(layer, h, cfg, cos, sin, attend, proj)
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
        mask &= new_token_mask(lengths, new_valid, S)[:, None, :]

        for i, layer in enumerate(layers):
            hn = rms_norm(h, layer.input_layernorm.weight, cfg.rms_norm_eps)
            q, k, v = _project_qkv(hn, layer.self_attn, cfg, cos, sin, rotate_k=False)
            dense_cache_update_rope(ck, cv, k, v, cos, sin, lengths, i)
            attn = dot_product_attention(q, ck[i].to(q.dtype), cv[i].to(q.dtype), mask=mask)
            h = h + layer.self_attn.o_proj(attn.reshape(B, T, -1))
            hn = rms_norm(h, layer.post_attention_layernorm.weight, cfg.rms_norm_eps)
            h = h + layer.mlp(hn)
        # In place: a captured decode step reads and advances one buffer.
        lengths.add_(new_valid.sum(dim=1).to(lengths.dtype))
        new_cache = {"k": ck, "v": cv, "length": lengths}

    h = rms_norm(h, decoder.model.norm.weight, cfg.rms_norm_eps)
    if logits_slice == "last":
        h = h[:, -1:, :]
    return decoder.lm_head(h).float(), new_cache
