"""Weight-only int8 quantization of the decoder's and the Q-Former's
projections, in place.

Port of `vis_zephyr_tpu/ops/quant.py` (`quantize_kernel`, `maybe_dequant`,
`quantize_decoder_layers`, `quantize_qformer`) for int8. Weights keep
torch's [out, in] layout: `weight_q` int8 [N, K] with one f32 scale per
output row, where the JAX package stores `kernel_q` [K, N] and `scale`
[1, N]; the arithmetic is the JAX package's, bit for bit. Quantized, every
projection runs through `quant_matmul.qlinear` (kernel K5 for up to 128
rows). What stays in its float dtype: `embed_tokens`, `lm_head`, the norms,
the biases, the learned queries, and the whole CLIP tower.

int4 (`--load-4bit`, group-128 scales and kernel row 6) is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..models.quant_linear import QuantLinear
from .quant_matmul import dequantize


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


def maybe_dequant(layer, dtype=torch.bfloat16) -> torch.Tensor:
    """The dense [N, K] weight of a float or an int8 projection (an
    `nn.Linear`, a `QuantLinear` or a `Projection`)."""
    weight_q = getattr(layer, "weight_q", None)
    if weight_q is None:
        return layer.weight.to(dtype)
    return dequantize(weight_q, layer.scale, dtype)


def quantize_linear(linear: nn.Linear) -> QuantLinear:
    q, scale = quantize_kernel(linear.weight)
    return QuantLinear(q, scale, None if linear.bias is None else linear.bias.detach())


@torch.no_grad()
def quantize_decoder_layers(decoder, bits: int = 8):
    """Replace q, k, v, o, gate, up and down of every layer of a
    `MistralForCausalLM` by `QuantLinear`s, on the decoder's device, one
    layer at a time: each float weight is dropped as soon as its int8 form
    exists, so the peak holds one layer twice, never the decoder. Returns
    the decoder."""
    if bits == 4:
        raise NotImplementedError("int4 weights (--load-4bit) are not ported to PyTorch yet "
                                  "(ROADMAP.md, Queue A step 6b)")
    if bits != 8:
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    for layer in decoder.model.layers:
        for parent, names in ((layer.self_attn, ("q_proj", "k_proj", "v_proj", "o_proj")),
                              (layer.mlp, ("gate_proj", "up_proj", "down_proj"))):
            for name in names:
                setattr(parent, name, quantize_linear(getattr(parent, name)))
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

