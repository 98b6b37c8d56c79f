"""In-place dense KV-cache row writes: the wrapper of kernel K2
(`csrc/dense_cache_append.cu`) and its plain PyTorch version.

Port of `vis_zephyr_tpu/ops/kv_cache.py::dense_cache_update`. A tensor on
the CPU takes the plain version; a CUDA tensor launches the kernel or raises
(outside `_kernels.plain_versions()`).
"""

from __future__ import annotations

import torch

from . import _kernels

launches = 0  # K2 launches in this process (reset by callers that count)


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


def _launch(ck, cv, k, v, lengths, layer: int) -> None:
    global launches
    L, Bc, S, Hkv, D = ck.shape
    B, T = k.shape[0], k.shape[1]
    for name, t in (("ck", ck), ("cv", cv), ("k", k), ("v", v), ("lengths", lengths)):
        if t.device != ck.device:
            raise ValueError(f"dense_cache_update: {name} must be on {ck.device}")
        if not t.is_contiguous():
            raise ValueError(f"dense_cache_update: {name} must be contiguous")
        if t.data_ptr() % 16 and name != "lengths":
            raise ValueError(f"dense_cache_update: {name} must be 16-byte aligned")
    if cv.shape != ck.shape or cv.dtype != ck.dtype:
        raise ValueError("dense_cache_update: ck and cv must match in shape and dtype")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,):
        raise TypeError(f"dense_cache_update: lengths must be int32 [{B}]")
    row_bytes = Hkv * D * ck.element_size()
    if row_bytes % 16:
        raise ValueError(f"dense_cache_update: a row of {row_bytes} bytes is not a "
                         "whole number of 16-byte vectors")
    if not 0 <= layer < L:
        raise ValueError(f"dense_cache_update: layer {layer} outside [0, {L})")
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
