"""int8 weight-only linear layers.

No JAX counterpart: there a quantized projection is a parameter dict
`{"kernel_q", "scale"[, "bias"]}` that `qdot` reads. Here `QuantLinear`
stands in for an `nn.Linear` (buffers `weight_q` int8 [out, in] and `scale`
f32 [out], an optional float `bias`), and `Projection` carries the same
tensors without a module, for the Q-Former's q/k/v weights that live on its
attention module. Both go through `ops.quant_matmul.qlinear`.

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
