"""Flash attention, forward and backward: the wrappers of kernels K1
(`csrc/flash_fwd.cu`), K7 and K8 (`csrc/flash_bwd.cu`) and their plain
PyTorch versions.

Port of `vis_zephyr_tpu/ops/flash_attention.py`: `flash_attention` is
differentiable, as the JAX `custom_vjp` is. Its forward saves K1's per-row
softmax residuals m and l; its backward recomputes the probabilities from
them, K7 giving dK and dV (already summed over each GQA group) and K8 dQ,
with di = rowsum(o * dO) a plain op between, as the JAX package leaves it to
XLA. A tensor on the CPU takes the plain versions; a CUDA tensor launches
the kernels or raises (outside `_kernels.plain_versions()`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _kernels
from .attention import attention_mask, dot_product_attention

HEAD_DIM = 128         # the kernels' compiled head dimension
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)  # K1's m on a row with no valid key
launches = 0           # K1 launches in this process (reset by callers that count)
bwd_dkv_launches = 0   # K7 launches
bwd_dq_launches = 0    # K8 launches
_kernels.register_counters(__name__, "launches", "bwd_dkv_launches", "bwd_dq_launches")


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


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """f32 for bf16/f32 inputs (the kernels' arithmetic), f64 for f64 (gradcheck)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _mask(kv_valid, T: int, S: int, causal: bool) -> torch.Tensor:
    """bool [B, 1, T, S]: valid key, and col <= row under `causal`."""
    mask = kv_valid.bool()[:, None, None, :]
    if causal:
        rows = torch.arange(T, device=kv_valid.device)[:, None]
        cols = torch.arange(S, device=kv_valid.device)[None, :]
        mask = mask & (cols <= rows)
    return mask


def _grouped(x: torch.Tensor, group: int, dtype) -> torch.Tensor:
    """k or v [B, S, Hkv, D] → [B, S, Hq, D]: q head h reads kv head h // group."""
    return x.to(dtype).repeat_interleave(group, dim=2)


def flash_attention_fwd_plain(q, k, v, kv_valid, causal: bool, scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1's contract in plain PyTorch, f32 (f64 for f64 inputs): (out
    [B,T,Hq,D] in q's dtype, m [B,Hq,T], l [B,Hq,T]). m is the row max of the
    scaled scores over valid keys and NEG_INF on a row without one, l the sum
    of exp(s - m) over valid keys (0 there), and out = sum(p V) / l (0 there).
    Unlike K1 it does not round P to bf16 before P·V."""
    B, T, Hq, _ = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    acc = _acc_dtype(q)
    mask = _mask(kv_valid, T, S, causal)
    s = torch.einsum("bthd,bshd->bhts", q.to(acc), _grouped(k, Hq // Hkv, acc)) * scale
    s = torch.where(mask, s, torch.full((), NEG_INF, dtype=acc, device=q.device))
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros((), dtype=acc, device=q.device))
    l = p.sum(dim=-1)
    l_inv = torch.where(l == 0, torch.zeros_like(l), 1.0 / l)
    out = torch.einsum("bhts,bshd->bthd", p * l_inv[..., None], _grouped(v, Hq // Hkv, acc))
    return out.to(q.dtype), m, l


def _bwd_terms(q, k, v, kv_valid, do, m, l, di, causal: bool, scale: float):
    """The TPU backward kernels' tile arithmetic over the whole [T, S]:
    p = mask ? exp(s - m) * (l == 0 ? 0 : 1/l) : 0 and ds = p (dp - di) scale,
    each [B, Hq, T, S] in f32 (f64 for f64 inputs)."""
    B, T, Hq, _ = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    acc = _acc_dtype(q)
    group = Hq // Hkv
    mask = _mask(kv_valid, T, S, causal)
    m, l, di = m.to(acc), l.to(acc), di.to(acc)
    s = torch.einsum("bthd,bshd->bhts", q.to(acc), _grouped(k, group, acc)) * scale
    l_inv = torch.where(l == 0, torch.zeros_like(l), 1.0 / l)
    p = torch.where(mask, torch.exp(s - m[..., None]),
                    torch.zeros((), dtype=acc, device=q.device)) * l_inv[..., None]
    dp = torch.einsum("bthd,bshd->bhts", do.to(acc), _grouped(v, group, acc))
    ds = p * (dp - di[..., None]) * scale
    return p, ds


def _group_sum(x: torch.Tensor, Hkv: int) -> torch.Tensor:
    """Per-q-head [B, S, Hq, D] → summed over each GQA group, [B, S, Hkv, D]."""
    B, S, Hq, D = x.shape
    return x.reshape(B, S, Hkv, Hq // Hkv, D).sum(dim=3)


def flash_attention_bwd_dkv_plain(q, k, v, kv_valid, do, m, l, di, causal: bool,
                                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's contract in plain PyTorch: (dK, dV) [B,S,Hkv,D] in k's dtype."""
    p, ds = _bwd_terms(q, k, v, kv_valid, do, m, l, di, causal, scale)
    acc, Hkv = p.dtype, k.shape[2]
    dk = _group_sum(torch.einsum("bhts,bthd->bshd", ds, q.to(acc)), Hkv)
    dv = _group_sum(torch.einsum("bhts,bthd->bshd", p, do.to(acc)), Hkv)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_plain(q, k, v, kv_valid, do, m, l, di, causal: bool,
                                 scale: float) -> torch.Tensor:
    """K8's contract in plain PyTorch: dQ [B,T,Hq,D] in q's dtype."""
    _, ds = _bwd_terms(q, k, v, kv_valid, do, m, l, di, causal, scale)
    group = q.shape[2] // k.shape[2]
    return torch.einsum("bhts,bshd->bthd", ds, _grouped(k, group, ds.dtype)).to(q.dtype)


def row_dot(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = rowsum(o * dO) in f32 (f64 for f64), [B, T, Hq, D] → [B, Hq, T]."""
    acc = _acc_dtype(o)
    return (o.to(acc) * do.to(acc)).sum(dim=-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, kv_valid, o, m, l, do, causal: bool, scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole backward in plain PyTorch (JAX `_flash_backward` with the
    GQA sum of `_flash_bwd`): (dq, dk, dv), dk and dv summed over each
    group, in the inputs' dtypes; di, then K7's and K8's plain versions, each
    recomputing from m and l as the kernels do."""
    di = row_dot(o, do)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, kv_valid, do, m, l, di, causal, scale)
    dq = flash_attention_bwd_dq_plain(q, k, v, kv_valid, do, m, l, di, causal, scale)
    return dq, dk, dv


def _check_kernel_inputs(name: str, q, k, v, kv_valid, extra=()) -> None:
    """What K1, K7 and K8 take: CUDA, contiguous, bf16 q/k/v (and `extra`
    bf16 tensors shaped like q), bool kv_valid [B, S], D = 128, Hq a multiple
    of Hkv, T and S multiples of 64."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    named = (("q", q), ("k", k), ("v", v), ("kv_valid", kv_valid)) + tuple(extra)
    for arg, t in named:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: {arg} must be on {q.device} (CUDA)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    for arg, t in (("q", q), ("k", k), ("v", v)) + tuple(extra):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {arg} must be bfloat16, got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
    for arg, t in extra:
        if t.shape != q.shape:
            raise ValueError(f"{name}: {arg} must have q's shape {tuple(q.shape)}")
    if kv_valid.dtype != torch.bool or tuple(kv_valid.shape) != (B, S):
        raise ValueError(f"{name}: kv_valid must be bool [{B}, {S}]")
    if D != HEAD_DIM or k.shape != (B, S, Hkv, D) or v.shape != k.shape or Hq % Hkv:
        raise ValueError(f"{name}: unsupported shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)} (head_dim must be "
                         f"{HEAD_DIM}, Hq a multiple of Hkv)")
    if T % 64 or S % 64:
        raise ValueError(f"{name}: T={T}, S={S} must be multiples of 64")


def _check_rows(name: str, q, **rows) -> None:
    """m, l, di: f32 [B, Hq, T], contiguous, on q's device."""
    B, T, Hq, _ = q.shape
    for arg, t in rows.items():
        if (t.dtype != torch.float32 or tuple(t.shape) != (B, Hq, T)
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name}: {arg} must be contiguous f32 [{B}, {Hq}, {T}] "
                             f"on {q.device}")


def flash_attention_fwd(q, k, v, kv_valid, causal: bool, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K1 on CUDA tensors. Returns (out [B,T,Hq,D] bf16, m [B,Hq,T]
    f32, l [B,Hq,T] f32): m and l are the per-row softmax max and sum that
    the backward kernels recompute from (logsumexp = m + log l)."""
    global launches
    _check_kernel_inputs("flash_attention_fwd", q, k, v, kv_valid)
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
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


def flash_attention_bwd_dkv(q, k, v, kv_valid, do, m, l, di, causal: bool, scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K7 on CUDA tensors: (dK, dV) bf16 [B,S,Hkv,D], each summed
    over its GQA group."""
    global bwd_dkv_launches
    _check_kernel_inputs("flash_attention_bwd_dkv", q, k, v, kv_valid, (("do", do),))
    _check_rows("flash_attention_bwd_dkv", q, m=m, l=l, di=di)
    B, T, Hq, _ = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    code = _kernels.lib().vzt_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(), do.data_ptr(),
        m.data_ptr(), l.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, T, S, Hq, Hkv, int(causal), float(scale), _kernels.stream_ptr(q.device))
    _kernels.check(code, "vzt_flash_bwd_dkv")
    bwd_dkv_launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, kv_valid, do, m, l, di, causal: bool, scale: float
                           ) -> torch.Tensor:
    """Launch K8 on CUDA tensors: dQ bf16 [B,T,Hq,D]."""
    global bwd_dq_launches
    _check_kernel_inputs("flash_attention_bwd_dq", q, k, v, kv_valid, (("do", do),))
    _check_rows("flash_attention_bwd_dq", q, m=m, l=l, di=di)
    B, T, Hq, _ = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    code = _kernels.lib().vzt_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(), do.data_ptr(),
        m.data_ptr(), l.data_ptr(), di.data_ptr(), dq.data_ptr(),
        B, T, S, Hq, Hkv, int(causal), float(scale), _kernels.stream_ptr(q.device))
    _kernels.check(code, "vzt_flash_bwd_dq")
    bwd_dq_launches += 1
    return dq


def flash_attention_bwd(q, k, v, kv_valid, o, m, l, do, causal: bool, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `flash_attention` from its saved residuals: K7 and K8
    on CUDA tensors, with di = rowsum(o * dO) between; the plain version on
    CPU tensors or inside `_kernels.plain_versions()`."""
    if not _kernels.use_kernel(q):
        return flash_attention_bwd_plain(q, k, v, kv_valid, o, m, l, do, causal, scale)
    do = do.contiguous()
    di = row_dot(o, do)
    dk, dv = flash_attention_bwd_dkv(q, k, v, kv_valid, do, m, l, di, causal, scale)
    dq = flash_attention_bwd_dq(q, k, v, kv_valid, do, m, l, di, causal, scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K1 forward, K7 + K8 backward (their plain versions on the CPU or
    inside `_kernels.plain_versions()`). The forward saves q, k, v, kv_valid,
    out, m and l, as the JAX `_flash_fwd` saves its residuals."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, causal: bool, scale: float):
        fwd = flash_attention_fwd if _kernels.use_kernel(q) else flash_attention_fwd_plain
        out, m, l = fwd(q, k, v, kv_valid, causal, scale)
        ctx.save_for_backward(q, k, v, kv_valid, out, m, l)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_valid, out, m, l = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, kv_valid, out, m, l, do, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


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
    positions are row indices. A row with no valid key returns zeros.
    Differentiable in q, k and v (`FlashAttention`); without a gradient to
    take it is K1 alone, or its plain version on the CPU."""
    B, T, Hq, D = q.shape
    S = k.shape[1]
    scale = D ** -0.5 if scale is None else scale
    if T % 128 or S % 128:
        raise ValueError(f"T={T}, S={S} must be multiples of 128 (pad to a bucket)")
    if kv_valid is None:
        kv_valid = torch.ones((B, S), dtype=torch.bool, device=q.device)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, kv_valid, causal, scale)
    if not _kernels.use_kernel(q):
        return flash_attention_plain(q, k, v, kv_valid, causal, scale)
    return flash_attention_fwd(q, k, v, kv_valid, causal, scale)[0]
