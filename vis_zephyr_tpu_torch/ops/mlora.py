"""Multi-LoRA: per-request adapters over one base model (serving), PyTorch.

Port of `vis_zephyr_tpu/ops/mlora.py`. Each batcher slot carries an adapter
index, and every adapted projection (q, k, v, o, gate, up, down) adds the
row's low-rank delta

    y_b += (x_b @ A[idx_b]) @ B[idx_b] * scale[idx_b]

Index 0 is the base model (an all-zero adapter), so requests without an
adapter ride the same step with a delta of exactly 0.0.

Pack layout (leaf axis 0 the layer, as the JAX pack's):

    pack = {"attn": {"q"|"k"|"v"|"out": {"a": [L, N, K, r],
                                         "b": [L, N, r, M],
                                         "scale": [L, N]}},
            "mlp":  {"gate"|"up"|"down": {...}}}

Ranks are zero-padded to the largest (exact: padded rank columns add 0) and
the pack covers the union of the adapters' targets (a missing target is a
zero adapter). The leaves live on the model's device in its dtype, `scale`
in f32.

The form. The JAX function sorts the batch by adapter and runs
`lax.ragged_dot` over the groups. Here every served decode and verify step
is a CUDA-graph replay (`serve/graphs.py`): shapes are fixed, and group
sizes brought to the host, or a Python loop over the step's groups, would
sync or be baked into the capture. So the delta is two dense products over
all adapters at once with a mask between them:

    t = x @ A_cat          A_cat [K, (N-1)·r]: adapters 1..N-1 side by side
    t = t * rows           rows [B, N-1]: the row's own adapter's scale, 0 elsewhere
    y = addmm(y, t, B_cat) B_cat [(N-1)·r, M]: the delta added in the epilogue

three launches a target a layer. `a` is stored as [L, K, N, r] and handed
out as the permuted view [L, N, K, r], so a layer's A_cat is a view (row
stride N·r), as B_cat is of `b`; the base's zero panels (index 0) are never
read. A base row's `rows` are all zero, so its delta is exactly 0.0 and its
output comes back bit for bit, whatever the pack holds. The masked scales
come from the adapter indices once a step for every layer (`mlora_ctx`),
as the JAX `ragged_ctx` does; the indices are a device tensor that the
captured steps read, so the graphs do not change with the batch's mix. The
scale multiplies t in the step's dtype before the second product, where
the JAX function scales the product in f32 (the reference's α / r = 2 is
exact either way).

What a step reads: every adapter's panels of every layer, whatever the mix.
At r = 128 on Zephyr-7B's widths (hidden 4096, kv width 1024, MLP 14336;
all seven targets) that is about 21 MB a layer an adapter in bf16, 0.67 GB
a step an adapter over 32 layers, beside the base weights' 14.5 GB.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence

import torch

# Target paths, as in the JAX pack ("decoder/layers/<path>" there).
TARGETS = ("attn/q", "attn/k", "attn/v", "attn/out", "mlp/gate", "mlp/up", "mlp/down")
# The port's module of each target, and its projection index in the
# decoder's `proj(module, x, index)` hooks (`models/mistral.py`).
MODULES = {"attn/q": "self_attn.q_proj", "attn/k": "self_attn.k_proj",
           "attn/v": "self_attn.v_proj", "attn/out": "self_attn.o_proj",
           "mlp/gate": "mlp.gate_proj", "mlp/up": "mlp.up_proj", "mlp/down": "mlp.down_proj"}
PROJ_INDEX = {t: i for i, t in enumerate(TARGETS)}


def _leaf(a_lknr: torch.Tensor, b: torch.Tensor, scale: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A target's leaves from `a` laid out [L, K, N, r]."""
    return {"a": a_lknr.permute(0, 2, 1, 3), "b": b, "scale": scale}


def build_pack(adapters: Sequence[Mapping[str, Mapping[str, torch.Tensor]]], num_layers: int,
               dtype: torch.dtype = torch.float32, device=None) -> Dict:
    """Stack adapters in `train/lora.py::attach_lora` form ({"decoder.model.
    layers.{i}.{module}": {"lora_a" [K, r], "lora_b" [r, M], "lora_scale"}},
    as `models/convert.py::lora_from_peft` gives them) into one pack, index
    0 the base (zeros) and adapter j at index j + 1.

    Ranks are zero-padded to the largest; a target that an adapter lacks is
    zero in it. The pack covers the union of the adapters' targets. A target
    must be adapted in every layer of an adapter or in none."""
    n = len(adapters) + 1
    pack: Dict = {}
    for target in TARGETS:
        module = MODULES[target]
        keys = [f"decoder.model.layers.{i}.{module}" for i in range(num_layers)]
        present = []
        for ad in adapters:
            have = [k in ad for k in keys]
            if any(have) and not all(have):
                raise ValueError(f"adapter for {module} covers {sum(have)} of "
                                 f"{num_layers} layers")
            present.append(all(have))
        if not any(present):
            continue
        first = adapters[present.index(True)][keys[0]]
        K, M = first["lora_a"].shape[0], first["lora_b"].shape[1]
        rmax = max(int(ad[keys[0]]["lora_a"].shape[1])
                   for ad, p in zip(adapters, present) if p)
        # Built where it is served, in its dtype: each leaf is rounded once.
        a = torch.zeros((num_layers, K, n, rmax), dtype=dtype, device=device)
        b = torch.zeros((num_layers, n, rmax, M), dtype=dtype, device=device)
        s = torch.zeros((num_layers, n), dtype=torch.float32)
        for j, (ad, p) in enumerate(zip(adapters, present), start=1):
            if not p:
                continue
            for i, key in enumerate(keys):
                leaf = ad[key]
                r = leaf["lora_a"].shape[1]
                a[i, :, j, :r] = torch.as_tensor(leaf["lora_a"]).to(device=device, dtype=dtype)
                b[i, j, :r] = torch.as_tensor(leaf["lora_b"]).to(device=device, dtype=dtype)
                s[i, j] = float(torch.as_tensor(leaf["lora_scale"]).float())
        group, name = target.split("/")
        pack.setdefault(group, {})[name] = _leaf(a, b, s.to(device=device))
    if not pack:
        raise ValueError("no adapted decoder targets found in any adapter")
    return pack


def pack_num_adapters(pack: Mapping) -> int:
    """N: the adapters of the pack, the base included."""
    for group in pack.values():
        for target in group.values():
            return int(target["a"].shape[1])
    raise ValueError("empty pack")


def pack_bytes(pack: Mapping) -> int:
    """The bytes the pack holds on its device."""
    return sum(t.numel() * t.element_size()
               for group in pack.values() for target in group.values()
               for t in target.values())


def target_dims(cfg) -> Dict[str, tuple]:
    """{target: (K, M)}: each adapted projection's input and output widths."""
    dec = cfg.decoder
    nq, nkv = dec.num_heads * dec.head_dim, dec.num_kv_heads * dec.head_dim
    D, I = dec.hidden_size, dec.intermediate_size
    return {"attn/q": (D, nq), "attn/k": (D, nkv), "attn/v": (D, nkv), "attn/out": (nq, D),
            "mlp/gate": (D, I), "mlp/up": (D, I), "mlp/down": (I, D)}


def make_random_pack(cfg, n_adapters: int, r: int, generator: torch.Generator,
                     targets: Sequence[str] = TARGETS, dtype: torch.dtype = torch.float32,
                     device=None) -> Dict:
    """Random adapters for tests and the smoke (index 0 still the zero base):
    A ~ N(0, 1/K), B ~ N(0, 0.02²), scale 2.0 (α / r of the reference's
    r = 128, α = 256), drawn on `generator`'s device in f32, target by
    target in `targets` order, A before B."""
    dims = target_dims(cfg)
    L, n = cfg.decoder.num_layers, n_adapters + 1
    gdev = generator.device
    pack: Dict = {}
    for target in targets:
        K, M = dims[target]
        a = torch.randn((L, K, n, r), generator=generator, device=gdev) * (1.0 / math.sqrt(K))
        b = torch.randn((L, n, r, M), generator=generator, device=gdev) * 0.02
        a[:, :, 0] = 0.0
        b[:, 0] = 0.0
        s = torch.full((L, n), 2.0, device=gdev)
        s[:, 0] = 0.0
        group, name = target.split("/")
        pack.setdefault(group, {})[name] = _leaf(a.to(device=device, dtype=dtype),
                                                 b.to(device=device, dtype=dtype),
                                                 s.to(device=device))
    return pack


def lora_leaves_for_adapter(pack: Mapping, adapter: int) -> Dict[str, Dict[str, torch.Tensor]]:
    """ONE adapter's leaves in `train/lora.py::attach_lora` form
    ({"decoder.model.layers.{i}.{module}": {"lora_a" [K, r], "lora_b" [r, M],
    "lora_scale"}}): the single-LoRA view that tests and the smoke attach as
    the solo oracle."""
    out = {}
    for group, kids in pack.items():
        for name, t in kids.items():
            module = MODULES[f"{group}/{name}"]
            for i in range(t["a"].shape[0]):
                out[f"decoder.model.layers.{i}.{module}"] = {
                    "lora_a": t["a"][i, adapter].contiguous(),
                    "lora_b": t["b"][i, adapter].contiguous(),
                    "lora_scale": t["scale"][i, adapter].to(t["a"].dtype),
                }
    return out


def mlora_ctx(pack: Mapping, adapter_idx: torch.Tensor, dtype: torch.dtype) -> Dict:
    """The step's grouping, computed once a step for every layer and target
    (the JAX `ragged_ctx`'s place): the indices [B] and, for each target,
    its rows' masked scales [L, B, N-1] in `dtype` (row b's column j holds
    scale[l, j + 1] where b's adapter is j + 1, else 0). Device ops only:
    no host sync."""
    idx = adapter_idx.to(torch.int64)
    n = pack_num_adapters(pack)
    onehot = (idx[:, None] == torch.arange(1, n, device=idx.device)[None, :]).float()
    rows = {}
    for group, kids in pack.items():
        for name, t in kids.items():
            rows[PROJ_INDEX[f"{group}/{name}"]] = (onehot[None] * t["scale"][:, None, 1:]).to(dtype)
    return {"idx": idx, "rows": rows}


def layer_targets(pack: Optional[Mapping], layer: int, ctx: Optional[Mapping]
                  ) -> Optional[Dict[int, Dict]]:
    """{projection index: what `mlora_delta` reads of that target at
    `layer`}: "a_cat" [K, (N-1)·r] and "b_cat" [(N-1)·r, M] (views of the
    pack, adapters 1..N-1 side by side) and "rows" [B, N-1] (`mlora_ctx`'s
    masked scales); None without a pack."""
    if pack is None:
        return None
    out = {}
    for group, kids in pack.items():
        for name, t in kids.items():
            index = PROJ_INDEX[f"{group}/{name}"]
            a, b = t["a"][layer], t["b"][layer]   # [N, K, r], [N, r, M]
            n, K, r = a.shape
            out[index] = {"a_cat": a[1:].transpose(0, 1).reshape(K, (n - 1) * r),
                          "b_cat": b[1:].reshape((n - 1) * r, b.shape[-1]),
                          "rows": ctx["rows"][index][layer]}
    return out


def _masked_panel(x: torch.Tensor, target: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """x @ A_cat with every column zeroed but those of the row's own adapter,
    which are scaled: [B·T, (N-1)·r] in x's dtype."""
    B, T, K = x.shape
    rows = target["rows"].to(x.dtype)
    n1 = rows.shape[1]
    t = (x.reshape(B * T, K) @ target["a_cat"].to(x.dtype)).view(B, T, n1, -1)
    return (t * rows[:, None, :, None]).view(B * T, -1)


def mlora_delta(x: torch.Tensor, target: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The per-row adapter delta of one target at one layer: x [B, T, K],
    `target` a `layer_targets` entry; returns [B, T, M] in x's dtype."""
    B, T = x.shape[0], x.shape[1]
    return (_masked_panel(x, target) @ target["b_cat"].to(x.dtype)).view(B, T, -1)


def mlora_add(out: torch.Tensor, x: torch.Tensor, target: Mapping[str, torch.Tensor]
              ) -> torch.Tensor:
    """`out` [B, T, M] (the base projection of x) plus its adapter delta, the
    sum taken in the second product's epilogue (`addmm`), so a base row comes
    back exactly as it went in."""
    t = _masked_panel(x, target)
    return torch.addmm(out.reshape(t.shape[0], -1), t,
                       target["b_cat"].to(out.dtype)).view(out.shape)
