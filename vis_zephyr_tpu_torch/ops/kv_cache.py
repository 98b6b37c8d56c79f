"""In-place dense KV-cache row writes: the wrappers of kernel K2
(`csrc/dense_cache_append.cu`) and their plain PyTorch versions.

`dense_cache_update` is the port of
`vis_zephyr_tpu/ops/kv_cache.py::dense_cache_update` (rows already rotated).
`dense_cache_update_rope` is what the decoder's dense-cache forward calls
once a layer: K arrives before its rotate-half RoPE (`apply_rope`), which
the kernel applies as it appends (the JAX package rotates K outside its
kernel; here the rotation's eager launches would cost more than the append).
A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises (outside `_kernels.plain_versions()`).
"""

from __future__ import annotations

import torch

from . import _kernels

launches = 0  # K2 launches in this process, both entries (reset by callers that count)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE. x [B, T, H, D]; cos/sin [B, T, D/2], cast to x's dtype first."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def dense_cache_update_plain(ck, cv, k, v, lengths, layer: int) -> None:
    """Row-by-row writes in t order, so a clamped slot keeps the last t (the
    TPU grid's order)."""
    B, T = k.shape[0], k.shape[1]
    S = ck.shape[2]
    rows = torch.arange(B, device=ck.device)
    slots = torch.clamp(lengths.long()[:, None] + torch.arange(T, device=ck.device), max=S - 1)
    for t in range(T):
        ck[layer, rows, slots[:, t]] = k[:, t]
        cv[layer, rows, slots[:, t]] = v[:, t]


def _check(name: str, ck, cv, lengths, layer: int, B: int, tensors) -> None:
    for what, t in (("ck", ck), ("cv", cv), ("lengths", lengths), *tensors):
        if t.device != ck.device:
            raise ValueError(f"{name}: {what} must be on {ck.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
        if t.data_ptr() % 16 and what != "lengths":
            raise ValueError(f"{name}: {what} must be 16-byte aligned")
    if cv.shape != ck.shape or cv.dtype != ck.dtype:
        raise ValueError(f"{name}: ck and cv must match in shape and dtype")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,):
        raise TypeError(f"{name}: lengths must be int32 [{B}]")
    if not 0 <= layer < ck.shape[0]:
        raise ValueError(f"{name}: layer {layer} outside [0, {ck.shape[0]})")


def _launch(ck, cv, k, v, lengths, layer: int) -> None:
    global launches
    L, Bc, S, Hkv, D = ck.shape
    B, T = k.shape[0], k.shape[1]
    _check("dense_cache_update", ck, cv, lengths, layer, B, (("k", k), ("v", v)))
    row_bytes = Hkv * D * ck.element_size()
    if row_bytes % 16:
        raise ValueError(f"dense_cache_update: a row of {row_bytes} bytes is not a "
                         "whole number of 16-byte vectors")
    code = _kernels.lib().vzt_dense_cache_append(
        ck.data_ptr(), cv.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        layer, Bc, B, T, S, row_bytes, _kernels.stream_ptr(ck.device))
    _kernels.check(code, "vzt_dense_cache_append")
    launches += 1


def dense_cache_update(
    ck: torch.Tensor,       # [L, B, S, Hkv, D], written in place
    cv: torch.Tensor,
    k: torch.Tensor,        # [B, T, Hkv, D] — the new rows (T=1 for decode)
    v: torch.Tensor,
    lengths: torch.Tensor,  # [B] int32 — first slot to write per sequence
    layer: int,             # which layer's segment to write
):
    """Write k/v at cache rows [layer, b, min(lengths[b] + t, S - 1)].

    The cache tensors are updated IN PLACE and returned: the JAX version
    donates them to the kernel (`input_output_aliases`), so no caller keeps
    the old contents. The rows are cast to the cache dtype first."""
    B, T, Hkv, D = k.shape
    if v.shape != k.shape or ck.shape[1] < B or ck.shape[3:] != (Hkv, D):
        raise ValueError(f"dense_cache_update: rows {tuple(k.shape)} do not fit "
                         f"cache {tuple(ck.shape)}")
    k = k.to(ck.dtype)
    v = v.to(cv.dtype)
    if not _kernels.use_kernel(ck):
        dense_cache_update_plain(ck, cv, k, v, lengths, layer)
    else:
        _launch(ck, cv, k, v, lengths, layer)
    return ck, cv


def dense_cache_update_rope_plain(ck, cv, k, v, cos, sin, lengths, layer: int) -> None:
    """`apply_rope`, then the row writes."""
    dense_cache_update_plain(ck, cv, apply_rope(k, cos, sin), v, lengths, layer)


def _launch_rope(ck, cv, k, v, cos, sin, lengths, layer: int) -> None:
    global launches
    L, Bc, S, Hkv, D = ck.shape
    B, T = k.shape[0], k.shape[1]
    name = "dense_cache_update_rope"
    _check(name, ck, cv, lengths, layer, B, (("k", k), ("v", v), ("cos", cos), ("sin", sin)))
    if k.dtype not in (torch.bfloat16, torch.float32) or not k.dtype == v.dtype == ck.dtype:
        raise TypeError(f"{name}: rows and cache must share one dtype, bf16 or f32 (rows "
                        f"{k.dtype}, {v.dtype}; cache {ck.dtype})")
    for what, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or tuple(t.shape) != (B, T, D // 2):
            raise TypeError(f"{name}: {what} must be f32 [{B}, {T}, {D // 2}]")
    code = _kernels.lib().vzt_dense_cache_append_rope(
        ck.data_ptr(), cv.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), lengths.data_ptr(), layer, Bc, B, T, S, Hkv, D,
        int(k.dtype == torch.float32), _kernels.stream_ptr(ck.device))
    _kernels.check(code, "vzt_dense_cache_append_rope")
    launches += 1


def dense_cache_update_rope(
    ck: torch.Tensor,       # [L, B, S, Hkv, D], written in place
    cv: torch.Tensor,
    k: torch.Tensor,        # [B, T, Hkv, D] — the new K rows BEFORE RoPE
    v: torch.Tensor,
    cos: torch.Tensor,      # [B, T, D/2] f32 — the forward's `rope_cos_sin` tables
    sin: torch.Tensor,
    lengths: torch.Tensor,  # [B] int32 — first slot to write per sequence
    layer: int,
):
    """`dense_cache_update(ck, cv, apply_rope(k, cos, sin), v, lengths,
    layer)` in one K2 launch: k is rotated and both rows are written at
    [layer, b, min(lengths[b] + t, S - 1)], the last t where the clamp sends
    several to S - 1. Rows and cache share the model's dtype. On the card
    the result is bit for bit the plain version's. Returns the cache
    tensors."""
    B, T, Hkv, D = k.shape
    if v.shape != k.shape or ck.shape[1] < B or ck.shape[3:] != (Hkv, D) or D % 2:
        raise ValueError(f"dense_cache_update_rope: rows {tuple(k.shape)} do not fit "
                         f"cache {tuple(ck.shape)}")
    if not _kernels.use_kernel(ck):
        dense_cache_update_rope_plain(ck, cv, k, v, cos, sin, lengths, layer)
    else:
        _launch_rope(ck, cv, k, v, cos, sin, lengths, layer)
    return ck, cv
