"""Paged KV pools: decode attention over pages (kernel K3,
`csrc/paged_attn_decode.cu`), the row writes (kernel K4,
`csrc/paged_kv_rows.cu`), int8 KV quantization, and the plain PyTorch version
of each.

Port of `vis_zephyr_tpu/ops/paged_attention.py`: `paged_attention_fa` (the
flash-structure kernel, with or without the self-term, any number of query
rows, either grid), `paged_attention` (the single-row entry the writefirst
decode step attends with), `paged_kv_update_rows{,_q}` (one decode step's
rows of every layer), `paged_kv_update{,_q}` (rows at absolute page ids: the
verify step's and the writefirst step's single-layer writes),
`quantize_kv`/`dequant_kv` and the pool forms, `paged_attention_reference`.
A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises (outside `_kernels.plain_versions()`, the comparison runs'
switch).

POOL LAYOUT of the port (page-major):

    k_pages / v_pages  [N, Hkv, rows, D]   N = layers * pages_per_layer
    k_scales/v_scales  [N, Hkv, rows] f32  (int8 pools only)
    rows = page_size, or 2 * page_size in a KV-fused pool (v_pages None): a
    page's K rows, then its V rows.

One page's rows of all kv heads are one contiguous piece, so admission writes
a page with one copy and a block of kernel K3 reads its (page, head) rows as
one contiguous run; scales need no singleton axis (the JAX package's
`[Hkv, N, rows, D]` pools and `[Hkv, N, 1, rows]` scales follow the TPU's
tiles). `pools_to_jax_layout` / `pools_from_jax_layout` convert between the
two, so pools can be compared with, or handed to, the JAX package.

Layer l's pages are pool entries `[l * P, (l + 1) * P)`; a slot's page table
holds within-layer ids and the layer's offset `l * P` is an argument
(`page_offset`), not a new table per layer. Page 0 of every layer is a trash
page: inactive slots write there.

The pools are updated IN PLACE (the JAX functions donate them).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import _kernels
from .attention import attention_mask, dot_product_attention

HEAD_DIM = 128  # the kernels' compiled head dimension
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
# int8 KV quantization: row ≈ int8 · scale / 127.5, scale = absmax of the row.
KV_QUANT_MAX = 127.5

attn_launches = 0  # K3 launches in this process (reset by callers that count)
rows_launches = 0  # K4 launches through `paged_kv_update_rows{,_q}`
update_launches = 0  # K4 launches through `paged_kv_update{,_q}`


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., D] float → (int8 [..., D], scales [..., 1] f32), per-row absmax.

    The row's largest positive element rounds to 128 and saturates to 127 (as
    XLA's float → int8 convert does); a plain `.to(torch.int8)` would wrap it
    to -128, hence the clamp."""
    x32 = x.float()
    s = x32.abs().amax(dim=-1, keepdim=True)
    # A true division: `float / tensor` would multiply by a rounded reciprocal.
    q = torch.round(x32 * torch.div(torch.full_like(s, KV_QUANT_MAX), s.clamp_min(1e-9)))
    return q.clamp_(-128, 127).to(torch.int8), s


def dequant_kv(q: torch.Tensor, s: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """int8 [..., D] with scales [..., 1] → float [..., D]."""
    return (q.float() * (s / KV_QUANT_MAX)).to(dtype)


def quantize_kv_pool(pool: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, Hkv, rows, D] float pool → (int8 pool, scales [N, Hkv, rows])."""
    q, s = quantize_kv(pool)
    return q, s[..., 0]


def dequant_kv_pool(q: torch.Tensor, s: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of `quantize_kv_pool`."""
    return dequant_kv(q, s[..., None], dtype)


# -- layout converters (numpy; they know the JAX layout, import nothing) ------


def _swap_head_and_page(pool):
    """[A, B, rows, D] → [B, A, rows, D], contiguous; None stays None."""
    return None if pool is None else np.ascontiguousarray(np.transpose(np.asarray(pool), (1, 0, 2, 3)))


def pools_to_jax_layout(k_pages, v_pages=None, k_scales=None, v_scales=None):
    """Port pools `[N, Hkv, rows, D]` / scales `[N, Hkv, rows]` → the JAX
    package's `[Hkv, N, rows, D]` / `[Hkv, N, 1, rows]`. numpy in, numpy out;
    None stays None."""
    def scale(s):
        return None if s is None else np.ascontiguousarray(
            np.transpose(np.asarray(s), (1, 0, 2))[:, :, None, :])

    return (_swap_head_and_page(k_pages), _swap_head_and_page(v_pages),
            scale(k_scales), scale(v_scales))


def pools_from_jax_layout(k_pages, v_pages=None, k_scales=None, v_scales=None):
    """Inverse of `pools_to_jax_layout`."""
    def scale(s):
        return None if s is None else np.ascontiguousarray(
            np.transpose(np.asarray(s)[:, :, 0, :], (1, 0, 2)))

    return (_swap_head_and_page(k_pages), _swap_head_and_page(v_pages),
            scale(k_scales), scale(v_scales))


# -- K3: paged decode attention --------------------------------------------------


def _page_size(k_pages: torch.Tensor, fused: bool) -> int:
    return k_pages.shape[2] // 2 if fused else k_pages.shape[2]


def paged_attention_fa_plain(q, k_pages, v_pages, page_table, lengths, q_offs, scale,
                             sliding_window=None, k_scales=None, v_scales=None,
                             k_new=None, v_new=None, page_offset: int = 0) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: gather every page of the
    table, f32 scores with the K scales folded in, the mask, the softmax over
    the pool, probabilities times the V scales rounded to the working dtype,
    f32 P·V, and the self-term folded in last as one more online-softmax
    step (so the pool's probabilities are rounded against the pool's
    maximum, as the kernel and the JAX package's kernels round them). A row
    with no key is 0."""
    B, S, Hq, D = q.shape
    fused = v_pages is None
    quant = k_scales is not None
    Hkv = k_pages.shape[1]
    ps = _page_size(k_pages, fused)
    G = Hq // Hkv
    T = page_table.shape[1] * ps
    idx = page_table.long() + page_offset                       # [B, pps]

    def rows(pool, lo):  # → [B, Hkv, T, ...]
        r = pool[idx][:, :, :, lo:lo + ps]                      # [B, pps, Hkv, ps, ...]
        r = r.transpose(1, 2)
        return r.reshape((B, Hkv, T) + tuple(r.shape[4:]))

    v_lo = ps if fused else 0
    k = rows(k_pages, 0).float()                                # [B, Hkv, T, D]
    v = rows(k_pages if fused else v_pages, v_lo).float()
    # Rows at or past `length` never reach the output (a recycled page may
    # hold anything there, and 0 · NaN = NaN).
    in_pool = torch.arange(T, device=q.device)[None, :] < lengths.long()[:, None]
    v = torch.where(in_pool[:, None, :, None], v, torch.zeros_like(v))
    qg = q.float().reshape(B, S, Hkv, G, D)
    s = torch.einsum("bshgd,bhtd->bhsgt", qg, k) * scale        # [B, Hkv, S, G, T]
    if quant:
        ksc = rows(k_scales, 0)                                 # [B, Hkv, T]
        s = s * (ksc * (1.0 / KV_QUANT_MAX))[:, :, None, None, :]
    slot = torch.arange(T, device=q.device)[None, None, :]
    qpos = (q_offs.long()[:, None] + torch.arange(S, device=q.device))[:, :, None]
    mask = (slot <= qpos) & (slot < lengths.long()[:, None, None])
    if sliding_window is not None:
        mask = mask & (slot > qpos - sliding_window)
    mask = mask[:, None, :, None, :]                            # [B, 1, S, 1, T]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    if quant:
        vsc = rows(k_scales if fused else v_scales, v_lo)
        p = torch.where(mask, p * (vsc * (1.0 / KV_QUANT_MAX))[:, :, None, None, :],
                        torch.zeros_like(p))
    work = q.dtype if quant else k_pages.dtype  # the P·V operand's dtype
    acc = torch.einsum("bhsgt,bhtd->bhsgd", p.to(work).float(), v)
    if k_new is not None:
        kn = k_new.to(q.dtype).float()                          # [B, Hkv, D]
        vn = v_new.to(q.dtype).float()
        s_self = torch.einsum("bshgd,bhd->bhsg", qg, kn)[..., None] * scale
        m_next = torch.maximum(m, s_self)
        alpha = torch.exp(m - m_next)
        p_self = torch.exp(s_self - m_next)
        l = alpha * l + p_self
        acc = acc * alpha + p_self * vn[:, :, None, None, :]
    l_inv = torch.where(l == 0.0, torch.zeros_like(l), 1.0 / l)
    out = (acc * l_inv).to(q.dtype)                             # [B, Hkv, S, G, D]
    return out.permute(0, 2, 1, 3, 4).reshape(B, S, Hq, D)


def _check_cuda(name: str, t: torch.Tensor, device, dtype, shape=None) -> None:
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_attention(q, k_pages, v_pages, page_table, lengths, q_offs, scale, sliding_window,
                      k_scales, v_scales, k_new, v_new, page_offset) -> torch.Tensor:
    global attn_launches
    B, S, Hq, D = q.shape
    fused = v_pages is None
    quant = k_scales is not None
    N, Hkv, rows, _ = k_pages.shape
    ps = _page_size(k_pages, fused)
    dev = q.device
    if D != HEAD_DIM or k_pages.shape[3] != D or Hq % Hkv:
        raise ValueError(f"paged_attention_fa: head_dim must be {HEAD_DIM} and Hq a multiple "
                         f"of Hkv; q={tuple(q.shape)}, pool={tuple(k_pages.shape)}")
    pool_dtype = torch.int8 if quant else torch.bfloat16
    _check_cuda("q", q, dev, torch.bfloat16)
    _check_cuda("k_pages", k_pages, dev, pool_dtype)
    if not fused:
        _check_cuda("v_pages", v_pages, dev, pool_dtype, k_pages.shape)
    if quant:
        _check_cuda("k_scales", k_scales, dev, torch.float32, (N, Hkv, rows))
        if fused != (v_scales is None):
            raise ValueError("paged_attention_fa: v_scales go with split pools only")
        if not fused:
            _check_cuda("v_scales", v_scales, dev, torch.float32, (N, Hkv, rows))
    elif k_pages.dtype != torch.bfloat16:
        raise TypeError("paged_attention_fa: int8 pools need k_scales")
    _check_cuda("page_table", page_table, dev, torch.int32, (B, page_table.shape[1]))
    _check_cuda("lengths", lengths, dev, torch.int32, (B,))
    _check_cuda("q_offs", q_offs, dev, torch.int32, (B,))
    if (k_new is None) != (v_new is None):
        raise ValueError("paged_attention_fa: k_new and v_new go together")
    if k_new is not None:
        _check_cuda("k_new", k_new, dev, torch.bfloat16, (B, Hkv, D))
        _check_cuda("v_new", v_new, dev, torch.bfloat16, (B, Hkv, D))
    if k_pages.data_ptr() % 16 or (ps * D * k_pages.element_size()) % 16:
        raise ValueError("paged_attention_fa: pool rows must be 16-byte aligned")
    out = torch.empty_like(q)
    code = _kernels.lib().vzt_paged_attn_decode(
        q.data_ptr(), out.data_ptr(), k_pages.data_ptr(), _ptr(v_pages), _ptr(k_scales),
        _ptr(v_scales), page_table.data_ptr(), lengths.data_ptr(), q_offs.data_ptr(),
        _ptr(k_new), _ptr(v_new), B, S, Hq, Hkv, ps, page_table.shape[1], int(page_offset),
        int(sliding_window or 0), int(quant), float(scale), _kernels.stream_ptr(dev))
    _kernels.check(code, "vzt_paged_attn_decode")
    attn_launches += 1
    return out


def paged_attention_fa(
    q: torch.Tensor,                # [B, S, Hq, D]
    k_pages: torch.Tensor,          # [N, Hkv, ps, D] bf16 or int8; [N, Hkv, 2·ps, D] fused
    v_pages: Optional[torch.Tensor],  # None: KV-fused pool
    page_table: torch.Tensor,       # [B, pages_per_seq] int32, within-layer page ids
    lengths: torch.Tensor,          # [B] int32 tokens of the slot in the pool
    q_offs: torch.Tensor,           # [B] int32 position of query row 0
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    k_scales: Optional[torch.Tensor] = None,  # [N, Hkv, rows] f32 (int8 pools)
    v_scales: Optional[torch.Tensor] = None,
    k_new: Optional[torch.Tensor] = None,     # [B, Hkv, D] self-term (S = 1)
    v_new: Optional[torch.Tensor] = None,
    page_offset: int = 0,
    fold_heads: Optional[bool] = None,
) -> torch.Tensor:
    """Flash-structure paged attention. Query row j of slot b sits at position
    `q_offs[b] + j` and attends pool slots `[max(0, pos − window + 1), pos]`
    below `lengths[b]`; S = 1 with `q_offs = lengths − 1` is single-token
    decode over a pool that already holds the token.

    Any S ≥ 1: the kernel takes the S·(Hq/Hkv) query rows of a kv head in
    tiles of at most 32 rows. S > 1 without the self-term is the verify
    step's shape: the rows are already in the pool and `q_offs` is the
    position of the first.

    `k_new`/`v_new` (S = 1): the current token's K/V as a final
    online-softmax self-term. The pool then holds `[0, lengths)`, the query
    sits at `lengths` (`q_offs = lengths`), and the decode step can attend
    first and write all layers' rows once (`paged_kv_update_rows`). The
    self-term stays unquantized even over int8 pools.

    `page_offset` is added to every table entry (the layer's pool segment).

    `fold_heads` names the JAX package's two TPU grids: one cell per slot
    over all kv heads (None or True, `_fa_mh_kernel` / `_fa_gmh_kernel`) or
    one per (slot, kv head) (False, `_fa_kernel`,
    `vis_zephyr_tpu/ops/paged_attention.py:1286-1305`). False keeps the JAX
    package's refusals: no self-term and no fused pools. Every value
    launches the same K3, whose grid (kv head, slot, row tile) is already
    the (slot, kv head) grid: the TPU folded the heads to divide a fixed
    cost per grid cell over more work, and a CUDA block pays no such cost
    in the same way. The TPU tilings `pages_per_block` and `slot_block` are
    not taken (ROADMAP Queue B).
    Returns [B, S, Hq, D]."""
    B, S, Hq, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    if k_new is not None and (S != 1 or fold_heads is False):
        raise ValueError("k_new/v_new self-term requires S == 1 and the folded grid")
    if v_pages is None and fold_heads is False:
        raise ValueError("KV-fused pools require the folded grid")
    args = (q, k_pages, v_pages, page_table, lengths, q_offs, scale, sliding_window,
            k_scales, v_scales, k_new, v_new, page_offset)
    if not _kernels.use_kernel(q):
        return paged_attention_fa_plain(*args)
    return _launch_attention(*args)


def paged_attention(
    q: torch.Tensor,                # [B, Hq, D]
    k_pages: torch.Tensor,          # [N, Hkv, ps, D] bf16 or int8; [N, Hkv, 2·ps, D] fused
    v_pages: Optional[torch.Tensor],  # None: KV-fused pool
    page_table: torch.Tensor,       # [B, pages_per_seq] int32, within-layer page ids
    lengths: torch.Tensor,          # [B] int32 tokens already in the pool
    k_new: Optional[torch.Tensor] = None,  # [B, Hkv, D] the current token's K/V
    v_new: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    k_scales: Optional[torch.Tensor] = None,  # [N, Hkv, rows] f32 (int8 pools)
    v_scales: Optional[torch.Tensor] = None,
    page_offset: int = 0,
) -> torch.Tensor:
    """One query row per slot against the pools: the JAX package's
    `paged_attention` (its split-pool self-term case is the TPU kernel
    `_make_kernel`). `lengths` counts the tokens already in the pool. With
    `k_new`/`v_new` the query sits at `lengths` and the current token is a
    final self-term; without them the token is already in the pool and the
    query sits at `lengths − 1` (the writefirst decode step). Split and
    fused pools alike; returns [B, Hq, D].

    K3 with S = 1 on a CUDA tensor, its plain version on a CPU tensor. The
    JAX function's `interpret` and `use_lib` choose among TPU routes (the
    library kernel is JAX's, not a kernel of this repository) and are not
    taken."""
    q_offs = lengths if k_new is not None else lengths - 1
    return paged_attention_fa(
        q[:, None], k_pages, v_pages, page_table, lengths, q_offs, scale=scale,
        sliding_window=sliding_window, k_scales=k_scales, v_scales=v_scales, k_new=k_new,
        v_new=v_new, page_offset=page_offset)[:, 0]


# -- K4: rows into the pools -------------------------------------------------------


def _kv_write_plain(k_pages, v_pages, k_scales, v_scales, ks, vs, pages, offsets) -> None:
    """Rows [L, B, Hkv, D] to absolute pool pages `pages` [L, B] (long), row
    `offsets[b]` (its V row `ps` further in a fused pool). Rows that land on
    one page row in one call must be equal (the trash page's): which write
    wins is not defined, here as on the card."""
    fused = v_pages is None
    quant = k_scales is not None
    Hkv = ks.shape[2]
    ps = _page_size(k_pages, fused)
    page = pages[:, :, None]
    head = torch.arange(Hkv, device=k_pages.device)[None, None, :]
    k_row = offsets.long()[None, :, None]
    v_row = k_row + (ps if fused else 0)
    v_pool = k_pages if fused else v_pages
    if quant:
        kq, ksc = quantize_kv(ks)
        vq, vsc = quantize_kv(vs)
        v_sc_pool = k_scales if fused else v_scales
        k_pages[page, head, k_row] = kq
        v_pool[page, head, v_row] = vq
        k_scales[page, head, k_row] = ksc[..., 0]
        v_sc_pool[page, head, v_row] = vsc[..., 0]
    else:
        k_pages[page, head, k_row] = ks.to(k_pages.dtype)
        v_pool[page, head, v_row] = vs.to(v_pool.dtype)


def _launch_write(k_pages, v_pages, k_scales, v_scales, ks, vs, pages, offsets,
                  absolute: bool) -> None:
    """One K4 launch: `vzt_paged_kv_update` for absolute page ids [L, B],
    `vzt_paged_kv_rows` for within-layer ids [B]."""
    global rows_launches, update_launches
    name = "paged_kv_update" if absolute else "paged_kv_update_rows"
    fused = v_pages is None
    quant = k_scales is not None
    L, B, Hkv, D = ks.shape
    N, _, rows, _ = k_pages.shape
    dev = k_pages.device
    pool_dtype = torch.int8 if quant else torch.bfloat16
    _check_cuda("k_pages", k_pages, dev, pool_dtype, (N, Hkv, rows, D))
    if not fused:
        _check_cuda("v_pages", v_pages, dev, pool_dtype, k_pages.shape)
    if quant:
        _check_cuda("k_scales", k_scales, dev, torch.float32, (N, Hkv, rows))
        if fused != (v_scales is None):
            raise ValueError(f"{name}_q: v_scales go with split pools only")
        if not fused:
            _check_cuda("v_scales", v_scales, dev, torch.float32, (N, Hkv, rows))
    _check_cuda("ks", ks, dev, torch.bfloat16)
    _check_cuda("vs", vs, dev, torch.bfloat16, ks.shape)
    _check_cuda("pages", pages, dev, torch.int32, (L, B) if absolute else (B,))
    _check_cuda("offsets", offsets, dev, torch.int32, (B,))
    if D > 1024 or (not absolute and N % L):
        raise ValueError(f"{name}: head_dim {D} > 1024, or {N} pool pages are not {L} layers "
                         "of pages")
    ps = _page_size(k_pages, fused)
    lib = _kernels.lib()
    if absolute:
        code = lib.vzt_paged_kv_update(
            k_pages.data_ptr(), _ptr(v_pages), _ptr(k_scales), _ptr(v_scales), ks.data_ptr(),
            vs.data_ptr(), pages.data_ptr(), offsets.data_ptr(), L, B, Hkv, D, ps,
            _kernels.stream_ptr(dev))
        _kernels.check(code, "vzt_paged_kv_update")
        update_launches += 1
    else:
        code = lib.vzt_paged_kv_rows(
            k_pages.data_ptr(), _ptr(v_pages), _ptr(k_scales), _ptr(v_scales), ks.data_ptr(),
            vs.data_ptr(), pages.data_ptr(), offsets.data_ptr(), L, B, Hkv, D, N // L, ps,
            _kernels.stream_ptr(dev))
        _kernels.check(code, "vzt_paged_kv_rows")
        rows_launches += 1


def _kv_write(k_pages, v_pages, k_scales, v_scales, ks, vs, pages, offsets,
              absolute: bool) -> None:
    if vs.shape != ks.shape or k_pages.shape[1] != ks.shape[2] or k_pages.shape[3] != ks.shape[3]:
        raise ValueError(f"paged_kv_update: rows {tuple(ks.shape)} / {tuple(vs.shape)} do not "
                         f"fit pool {tuple(k_pages.shape)}")
    if _kernels.use_kernel(k_pages):
        _launch_write(k_pages, v_pages, k_scales, v_scales, ks, vs, pages, offsets, absolute)
        return
    pages = pages.long()
    if not absolute:  # within-layer ids [B] → absolute [L, B]
        L = ks.shape[0]
        pages = torch.arange(L, device=pages.device)[:, None] * (k_pages.shape[0] // L) + pages
    _kv_write_plain(k_pages, v_pages, k_scales, v_scales, ks, vs, pages, offsets)


def paged_kv_update_rows(
    k_pages: torch.Tensor,            # [L·P, Hkv, ps, D] (2·ps fused), written in place
    v_pages: Optional[torch.Tensor],  # None: KV-fused pool
    ks: torch.Tensor,                 # [L, B, Hkv, D] — one step's rows, ALL layers
    vs: torch.Tensor,
    pages: torch.Tensor,              # [B] int32 within-layer page id
    offsets: torch.Tensor,            # [B] int32 row within the page
):
    """Write one decode step's K/V rows of every layer: slot b's row of layer
    l lands at page `l·P + pages[b]`, row `offsets[b]` (its V row at
    `ps + offsets[b]` of the same page in a fused pool). Returns the pools."""
    _kv_write(k_pages, v_pages, None, None, ks, vs, pages, offsets, absolute=False)
    return k_pages, v_pages


def paged_kv_update_rows_q(
    k_pages: torch.Tensor,            # int8, written in place
    v_pages: Optional[torch.Tensor],
    k_scales: torch.Tensor,           # [L·P, Hkv, rows] f32, written in place
    v_scales: Optional[torch.Tensor],
    ks: torch.Tensor,                 # [L, B, Hkv, D] float
    vs: torch.Tensor,
    pages: torch.Tensor,
    offsets: torch.Tensor,
):
    """`paged_kv_update_rows` for int8 pools: each row is absmax-quantized
    (`quantize_kv`) and written with its scale."""
    _kv_write(k_pages, v_pages, k_scales, v_scales, ks, vs, pages, offsets, absolute=False)
    return k_pages, v_pages, k_scales, v_scales


def paged_kv_update(
    k_pages: torch.Tensor,            # [N, Hkv, ps, D] (2·ps fused), written in place
    v_pages: Optional[torch.Tensor],  # None: KV-fused pool
    ks: torch.Tensor,                 # [L, B, Hkv, D] new K rows
    vs: torch.Tensor,
    page_ids: torch.Tensor,           # [L, B] int32 ABSOLUTE pool page per (layer, slot)
    offsets: torch.Tensor,            # [B] int32 row within the page
):
    """The JAX package's `paged_kv_update` contract: row (l, b) lands at pool
    page `page_ids[l, b]`, row `offsets[b]` (its V row at `ps + offsets[b]`
    in a fused pool). The verify step calls it with L = 1, once per candidate
    row and layer. Inactive slots pass the trash page 0. Returns the pools."""
    _kv_write(k_pages, v_pages, None, None, ks, vs, page_ids, offsets, absolute=True)
    return k_pages, v_pages


def paged_kv_update_q(
    k_pages: torch.Tensor,            # int8, written in place
    v_pages: Optional[torch.Tensor],
    k_scales: torch.Tensor,           # [N, Hkv, rows] f32, written in place
    v_scales: Optional[torch.Tensor],
    ks: torch.Tensor,                 # [L, B, Hkv, D] float
    vs: torch.Tensor,
    page_ids: torch.Tensor,           # [L, B] int32 absolute
    offsets: torch.Tensor,
):
    """`paged_kv_update` for int8 pools: each row is absmax-quantized
    (`quantize_kv`, in the kernel on the card) and written with its scale."""
    _kv_write(k_pages, v_pages, k_scales, v_scales, ks, vs, page_ids, offsets, absolute=True)
    return k_pages, v_pages, k_scales, v_scales


# -- oracle ------------------------------------------------------------------------


def paged_attention_reference(q, k_pages, v_pages, page_table, lengths,
                              k_new=None, v_new=None, sliding_window=None):
    """Test oracle: gather pages into dense KV (appending the current token's
    K/V when given) and run masked attention. q [B, Hq, D]; split float pools
    in the port's layout."""
    B, Hq, D = q.shape
    _, Hkv, ps, _ = k_pages.shape
    S = page_table.shape[1] * ps
    dev = q.device
    k = k_pages[page_table.long()].transpose(2, 3).reshape(B, S, Hkv, D)
    v = v_pages[page_table.long()].transpose(2, 3).reshape(B, S, Hkv, D)
    kv_valid = torch.arange(S, device=dev)[None, :] < lengths[:, None]
    q_pos = lengths.long()[:, None] - 1
    kv_pos = torch.arange(S, device=dev).expand(B, S)
    if k_new is not None:
        k = torch.cat([k, k_new[:, None].to(k.dtype)], dim=1)
        v = torch.cat([v, v_new[:, None].to(v.dtype)], dim=1)
        kv_valid = torch.cat([kv_valid, torch.ones((B, 1), dtype=torch.bool, device=dev)], dim=1)
        q_pos = q_pos + 1
        kv_pos = torch.cat([kv_pos, q_pos], dim=1)
    mask = attention_mask(q_pos, kv_pos, kv_valid=kv_valid, causal=True,
                          sliding_window=sliding_window)
    return dot_product_attention(q[:, None], k, v, mask=mask)[:, 0]
