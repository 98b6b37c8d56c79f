"""int8 and int4 weight-only linear layers.

No JAX counterpart: there a quantized projection is a parameter dict
`{"kernel_q", "scale"[, "bias"]}` or `{"kernel_q4", "scale4"[, "bias"]}`
that `qdot` reads. Here `QuantLinear` stands in for an `nn.Linear` with
int8 weights (buffers `weight_q` int8 [out, in] and `scale` f32 [out]),
`QuantLinear4` for one with int4 weights (buffers `weight_q4` int8
[out, in/2], two codes a byte, and `scale4` f32 [out, in/group]), each with
an optional float `bias`; `Projection` carries int8 or float tensors without
a module, for the Q-Former's q/k/v weights that live on its attention
module. All go through `ops.quant_matmul.qlinear`.

The scales stay f32: cast a quantized model with `.float()` if at all, not
`.to(torch.bfloat16)`, which would round them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..ops.quant_matmul import qlinear


class Projection(NamedTuple):
    """A linear map's tensors: `weight` [out, in] float, or `weight_q` and
    `scale`; `bias` or None."""

    weight: Optional[torch.Tensor] = None
    weight_q: Optional[torch.Tensor] = None
    scale: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None


class QuantLinear(nn.Module):
    def __init__(self, weight_q: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.out_features, self.in_features = weight_q.shape
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("scale", scale)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return qlinear(x, self)


class QuantLinear4(nn.Module):
    def __init__(self, weight_q4: torch.Tensor, scale4: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.out_features, self.in_features = weight_q4.shape[0], 2 * weight_q4.shape[1]
        self.register_buffer("weight_q4", weight_q4)
        self.register_buffer("scale4", scale4)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return qlinear(x, self)
