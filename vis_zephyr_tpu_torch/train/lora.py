"""LoRA adapters for stage-2 finetuning, PyTorch.

Port of `vis_zephyr_tpu/train/lora.py`. Reference parity: peft LoRA with
r=128, α=256, dropout 0.05 on every decoder linear (q, k, v, o, gate, up,
down) and not on the vision tower, the projector or lm_head.

Mechanism: `add_lora` replaces each targeted `nn.Linear` by a `LoraLinear`
that keeps the same `weight` (so its state-dict name stays HF's) and adds
`lora_a` [in, r] (N(0, 1/in)), `lora_b` [r, out] (zeros) and the buffer
`lora_scale` (α/r). The adapters keep the JAX package's orientation, so the
weight bridge (`models/convert.py`) copies them as they are; the branch adds
`(x @ lora_a) @ lora_b * lora_scale`. `lora_trainable_mask` selects the
adapter parameters; the decoder's training forward drops the branch's input
(peft semantics) through `LoraLinear.forward(x, dropout=(seed, rate))`.

The JAX `add_lora` seeds each adapter with Python's `hash(prefix)`, which
differs from process to process; tests carry adapters across with the
weight bridge and never compare initializations. LoRA on an int8 or int4
base (the JAX `qdot`'s QLoRA route) is not ported: it stays in ROADMAP
Queue A step 10, after multi-LoRA serving (which adds its deltas on any base
weight form, `ops/mlora.py`).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 128
    alpha: int = 256
    # The JAX pattern `decoder/layers/(attn/(q|k|v|out)|mlp/(gate|up|down))$`
    # on the port's module names.
    target_pattern: str = (r"^decoder\.model\.layers\.\d+\."
                           r"(self_attn\.(q|k|v|o)_proj|mlp\.(gate|up|down)_proj)$")


class LoraLinear(nn.Linear):
    """`nn.Linear` plus a LoRA branch: y = x Wᵀ (+ b) + (drop(x) A) B · s."""

    def __init__(self, in_features: int, out_features: int, r: int, alpha: float,
                 bias: bool = False, device=None, dtype=None):
        super().__init__(in_features, out_features, bias=bias, device=device, dtype=dtype)
        self.lora_a = nn.Parameter(torch.zeros(in_features, r, device=device, dtype=dtype))
        self.lora_b = nn.Parameter(torch.zeros(r, out_features, device=device, dtype=dtype))
        self.register_buffer("lora_scale", torch.tensor(alpha / r, device=device, dtype=dtype))

    @classmethod
    def wrap(cls, base: nn.Linear, lora_a: torch.Tensor, lora_b: torch.Tensor,
             lora_scale: torch.Tensor) -> "LoraLinear":
        """A LoraLinear that shares `base`'s weight (and bias) and holds the
        given adapter tensors."""
        r = lora_a.shape[-1]
        lin = cls(base.in_features, base.out_features, r, 1.0, bias=base.bias is not None,
                  device="meta", dtype=base.weight.dtype)
        lin.weight, lin.bias = base.weight, base.bias
        lin.lora_a = nn.Parameter(lora_a, requires_grad=False)
        lin.lora_b = nn.Parameter(lora_b, requires_grad=False)
        lin.lora_scale = lora_scale
        return lin

    def forward(self, x: torch.Tensor, dropout: Optional[Tuple[int, float]] = None
                ) -> torch.Tensor:
        """`dropout` = (seed, rate): the branch's input keeps each element with
        probability 1 - rate (scaled by 1/(1 - rate)), the mask drawn from a
        generator seeded with `seed`; the base product never sees it."""
        out = F.linear(x, self.weight, self.bias)
        xl = x
        if dropout is not None:
            seed, rate = dropout
            gen = torch.Generator(device=x.device).manual_seed(seed)
            keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
            xl = torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                                  device=x.device)).to(x.dtype)
        delta = (xl @ self.lora_a.to(x.dtype)) @ self.lora_b.to(x.dtype)
        return out + delta * self.lora_scale.to(x.dtype)


def _targets(model: nn.Module, cfg: LoraConfig):
    pattern = re.compile(cfg.target_pattern)
    return [(name, mod) for name, mod in model.named_modules() if pattern.search(name)]


def _set_module(model: nn.Module, name: str, module: nn.Module) -> None:
    parent, _, leaf = name.rpartition(".")
    setattr(model.get_submodule(parent) if parent else model, leaf, module)


def add_lora(model: nn.Module, cfg: LoraConfig, generator: torch.Generator,
             dtype: Optional[torch.dtype] = None) -> nn.Module:
    """Wrap every targeted projection in a `LoraLinear`, in place: `lora_a`
    N(0, 1/in) from `generator` (which lives on the model's device), `lora_b`
    zeros, so the model computes what it did. Returns the model."""
    for name, mod in _targets(model, cfg):
        if isinstance(mod, LoraLinear):
            continue
        if type(mod) is not nn.Linear:
            raise NotImplementedError(
                f"{name}: LoRA on a {type(mod).__name__} base (a quantized projection) is "
                "not ported yet (ROADMAP.md, Queue A step 10)")
        w = mod.weight
        dt = dtype or w.dtype
        K, N = mod.in_features, mod.out_features
        a = torch.randn(K, cfg.r, generator=generator, device=w.device, dtype=torch.float32)
        a = (a * (1.0 / math.sqrt(K))).to(dt)
        b = torch.zeros(cfg.r, N, device=w.device, dtype=dt)
        scale = torch.tensor(cfg.alpha / cfg.r, device=w.device, dtype=dt)
        _set_module(model, name, LoraLinear.wrap(mod, a, b, scale))
    return model


def lora_trainable_mask(model: nn.Module) -> Dict[str, bool]:
    """{parameter name: True only for lora_a / lora_b}."""
    return {name: name.rsplit(".", 1)[-1] in ("lora_a", "lora_b")
            for name, _ in model.named_parameters()}


def split_lora(model: nn.Module) -> Tuple[nn.Module, Dict[str, Dict[str, torch.Tensor]]]:
    """(model with plain `nn.Linear` projections, {module name: {"lora_a",
    "lora_b", "lora_scale"}}), in place: the adapters saved apart from the
    base, like the reference's adapter dir."""
    adapters = {}
    for name, mod in list(model.named_modules()):
        if isinstance(mod, LoraLinear):
            adapters[name] = {"lora_a": mod.lora_a.data, "lora_b": mod.lora_b.data,
                              "lora_scale": mod.lora_scale}
            base = nn.Linear(mod.in_features, mod.out_features, bias=mod.bias is not None,
                             device="meta", dtype=mod.weight.dtype)
            base.weight, base.bias = mod.weight, mod.bias
            _set_module(model, name, base)
    return model, adapters


def attach_lora(model: nn.Module, adapters: Dict[str, Dict[str, torch.Tensor]]) -> nn.Module:
    """Inverse of `split_lora`, in place."""
    for name, parts in adapters.items():
        _set_module(model, name, LoraLinear.wrap(model.get_submodule(name), parts["lora_a"],
                                                 parts["lora_b"], parts["lora_scale"]))
    return model


@torch.no_grad()
def merge_lora(model: nn.Module) -> nn.Module:
    """Fold every adapter into its base weight and strip it (the reference's
    merge_and_unload), in place: W += (A B · s)ᵀ, computed in the adapter's
    dtype. Returns the model."""
    model, adapters = split_lora(model)
    for name, parts in adapters.items():
        base = model.get_submodule(name)
        a, b, s = parts["lora_a"], parts["lora_b"], parts["lora_scale"]
        delta = (a @ b) * s.to(a.dtype)
        base.weight.add_(delta.T.to(base.weight.dtype))
    return model
