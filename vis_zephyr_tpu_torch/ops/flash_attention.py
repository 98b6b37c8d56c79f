"""Flash attention forward: the wrapper of kernel K1 (`csrc/flash_fwd.cu`)
and its plain PyTorch version.

Port of `vis_zephyr_tpu/ops/flash_attention.py::flash_attention` (forward
only; the backward kernels are still to be ported). A tensor on the CPU takes
the plain version; a CUDA tensor launches the kernel or raises (outside
`_kernels.plain_versions()`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _kernels
from .attention import attention_mask, dot_product_attention

HEAD_DIM = 128  # the kernel's compiled head dimension
launches = 0    # K1 launches in this process (reset by callers that count)


def flash_attention_plain(q, k, v, kv_valid, causal: bool, scale: float) -> torch.Tensor:
    """Same contract as the kernel, through `dot_product_attention`
    (JAX `_reference`). Positions are row indices. A row with no valid key
    is 0, as the kernel writes it (the softmax alone would average V)."""
    B, T = q.shape[0], q.shape[1]
    S = k.shape[1]
    positions = torch.arange(T, device=q.device).expand(B, T)
    kv_positions = torch.arange(S, device=q.device).expand(B, S)
    mask = attention_mask(positions, kv_positions, kv_valid=kv_valid, causal=causal)
    out = dot_product_attention(q, k, v, mask=mask, scale=scale)
    return out * mask.any(dim=-1)[:, :, None, None].to(out.dtype)


def flash_attention_fwd(q, k, v, kv_valid, causal: bool, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K1 on CUDA tensors. Returns (out [B,T,Hq,D] bf16, m [B,Hq,T]
    f32, l [B,Hq,T] f32): m and l are the per-row softmax max and sum that
    the TPU kernel saves for its backward pass (logsumexp = m + log l)."""
    global launches
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v), ("kv_valid", kv_valid)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention_fwd: {name} must be on {q.device} (CUDA)")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_fwd: {name} must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention_fwd: {name} must be bfloat16, got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_fwd: {name} must be 16-byte aligned")
    if kv_valid.dtype != torch.bool or tuple(kv_valid.shape) != (B, S):
        raise ValueError(f"flash_attention_fwd: kv_valid must be bool [{B}, {S}]")
    if D != HEAD_DIM or k.shape != (B, S, Hkv, D) or v.shape != k.shape or Hq % Hkv:
        raise ValueError(f"flash_attention_fwd: unsupported shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)} (head_dim must be "
                         f"{HEAD_DIM}, Hq a multiple of Hkv)")
    if T % 64 or S % 64:
        raise ValueError(f"flash_attention_fwd: T={T}, S={S} must be multiples of 64")
    out = torch.empty_like(q)
    m = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
    l = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
    code = _kernels.lib().vzt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(),
        out.data_ptr(), m.data_ptr(), l.data_ptr(),
        B, T, S, Hq, Hkv, int(causal), float(scale), _kernels.stream_ptr(q.device))
    _kernels.check(code, "vzt_flash_fwd")
    launches += 1
    return out, m, l


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid: Optional[torch.Tensor] = None,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Blockwise attention. q: [B, T, Hq, D]; k/v: [B, S, Hkv, D];
    kv_valid: bool [B, S] (None = all valid). Returns [B, T, Hq, D].

    Requires T % 128 == 0 and S % 128 == 0 (callers pad to length buckets);
    positions are row indices. A row with no valid key returns zeros."""
    B, T, Hq, D = q.shape
    S = k.shape[1]
    scale = D ** -0.5 if scale is None else scale
    if T % 128 or S % 128:
        raise ValueError(f"T={T}, S={S} must be multiples of 128 (pad to a bucket)")
    if kv_valid is None:
        kv_valid = torch.ones((B, S), dtype=torch.bool, device=q.device)
    if not _kernels.use_kernel(q):
        return flash_attention_plain(q, k, v, kv_valid, causal, scale)
    return flash_attention_fwd(q, k, v, kv_valid, causal, scale)[0]
