"""Weight-only int8 and int4 quantization of the decoder's and the
Q-Former's projections, in place.

Port of `vis_zephyr_tpu/ops/quant.py` (`quantize_kernel`,
`quantize_kernel_int4`, `unpack_int4`, `dequant_int4`, `maybe_dequant`,
`quantize_decoder_layers`, `quantize_qformer`). Weights keep torch's
[out, in] layout, each the JAX package's array transposed byte for byte:
int8 `weight_q` [N, K] with one f32 scale per output row (JAX: `kernel_q`
[K, N], `scale` [1, N]); int4 `weight_q4` int8 [N, K/2] with f32 group
scales `scale4` [N, K/group] (JAX: `kernel_q4` [K/2, N], `scale4` [G, N]),
packed per group half-split (`quant_matmul.py`'s note). The arithmetic is
the JAX package's, bit for bit. Quantized, every projection runs through
`quant_matmul.qlinear` (K5 or K6 for up to 128 rows). `--load-4bit` makes
the decoder's projections int4 and the Q-Former's int8, as in the JAX
builder. What stays in its float dtype: `embed_tokens`, `lm_head`, the
norms, the biases, the learned queries, and the whole CLIP tower.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..models.quant_linear import QuantLinear, QuantLinear4
from .quant_matmul import dequant_int4, dequantize, unpack_int4  # noqa: F401 (re-exported)


@torch.no_grad()
def quantize_kernel(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: weight [N, K] → (weight_q int8
    [N, K], scale f32 [N]), scale = max(absmax over K, 1e-8) / 127 and
    q = clip(round(w / scale), -127, 127), rounding half to even. Both
    divisions are true divisions (a division by a Python float multiplies by
    a rounded reciprocal on the card)."""
    w = weight.float()
    absmax = w.abs().amax(dim=-1, keepdim=True)
    scale = torch.div(absmax.clamp_min(1e-8), torch.full_like(absmax, 127.0))
    q = torch.round(torch.div(w, scale)).clamp_(-127, 127).to(torch.int8)
    return q, scale[:, 0]


@torch.no_grad()
def quantize_kernel_int4(weight: torch.Tensor,
                         group: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int4 with one scale per K-group: weight [N, K] →
    (weight_q4 int8 [N, K/2], scale4 f32 [N, K/group]), group = min(group, K),
    scale = max(absmax over the group, 1e-8) / 7 and
    q = clip(round(w / scale), -7, 7), rounding half to even (the -8 code is
    unused). Byte j of group g packs q[g·group + j] into its low nibble and
    q[g·group + group/2 + j] into its high nibble."""
    w = weight.float()
    N, K = w.shape
    group = min(group, K)
    if K % group or group % 2:
        raise ValueError(f"K={K} must tile by an even group={group}")
    grouped = w.reshape(N, K // group, group)
    absmax = grouped.abs().amax(dim=-1, keepdim=True)
    scale = torch.div(absmax.clamp_min(1e-8), torch.full_like(absmax, 7.0))
    q = torch.round(torch.div(grouped, scale)).clamp_(-7, 7).to(torch.int8)
    lo, hi = q[..., :group // 2], q[..., group // 2:]
    packed = (lo & 0x0F) | (hi << 4)
    return packed.reshape(N, K // 2), scale[..., 0]


def maybe_dequant(layer, dtype=torch.bfloat16) -> torch.Tensor:
    """The dense [N, K] weight of a float, an int8 or an int4 projection (an
    `nn.Linear`, a `QuantLinear`, a `QuantLinear4` or a `Projection`)."""
    if getattr(layer, "weight_q4", None) is not None:
        return dequant_int4(layer.weight_q4, layer.scale4, dtype)
    weight_q = getattr(layer, "weight_q", None)
    if weight_q is None:
        return layer.weight.to(dtype)
    return dequantize(weight_q, layer.scale, dtype)


def quantize_linear(linear: nn.Linear) -> QuantLinear:
    q, scale = quantize_kernel(linear.weight)
    return QuantLinear(q, scale, None if linear.bias is None else linear.bias.detach())


def quantize_linear4(linear: nn.Linear, group: int = 128) -> QuantLinear4:
    q4, scale4 = quantize_kernel_int4(linear.weight, group)
    return QuantLinear4(q4, scale4, None if linear.bias is None else linear.bias.detach())


@torch.no_grad()
def quantize_decoder_layers(decoder, bits: int = 8, group: int = 128):
    """Replace q, k, v, o, gate, up and down of every layer of a
    `MistralForCausalLM` by `QuantLinear`s (`bits` 8) or `QuantLinear4`s
    (`bits` 4, scales per `group` of K), on the decoder's device, one layer
    at a time: each float weight is dropped as soon as its quantized form
    exists, so the peak holds one layer twice, never the decoder. Returns
    the decoder."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    for layer in decoder.model.layers:
        for parent, names in ((layer.self_attn, ("q_proj", "k_proj", "v_proj", "o_proj")),
                              (layer.mlp, ("gate_proj", "up_proj", "down_proj"))):
            for name in names:
                linear = getattr(parent, name)
                setattr(parent, name, quantize_linear4(linear, group) if bits == 4
                        else quantize_linear(linear))
    return decoder


def _quantize_attention_weight(attn: nn.Module, prefix: str) -> None:
    """Parameter `{prefix}_weight` → buffers `{prefix}_weight_q`, `{prefix}_scale`."""
    q, scale = quantize_kernel(getattr(attn, f"{prefix}_weight"))
    delattr(attn, f"{prefix}_weight")
    attn.register_buffer(f"{prefix}_weight_q", q)
    attn.register_buffer(f"{prefix}_scale", scale)


@torch.no_grad()
def quantize_qformer(qformer):
    """Quantize every projection of a `QFormer`'s blocks in place: the self-
    attention's packed `in_proj` (row by row, which is exactly the JAX
    package's separate q, k and v), the cross-attention's q, k and v, both
    `out_proj`s, and `ffn.0` / `ffn.2`. Returns the Q-Former."""
    for block in qformer.blocks:
        for attn in (block.self_attn, block.cross_attn):
            for prefix in ("in_proj",) if attn.packed else ("q_proj", "k_proj", "v_proj"):
                _quantize_attention_weight(attn, prefix)
            attn.out_proj = quantize_linear(attn.out_proj)
        block.ffn[0] = quantize_linear(block.ffn[0])
        block.ffn[2] = quantize_linear(block.ffn[2])
    return qformer

