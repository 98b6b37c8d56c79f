"""Paged KV pools: decode attention over pages (kernel K3,
`csrc/paged_attn_decode.cu`, and its served configuration a slot a block or
a group of slots, kernels K10, `csrc/paged_attn_grouped.cu`, and K11,
`csrc/paged_attn_paired.cu`), the row
writes (kernel K4, `csrc/paged_kv_rows.cu`), int8 KV quantization, and the
plain PyTorch version of each.

Port of `vis_zephyr_tpu/ops/paged_attention.py`: `paged_attention_fa` (the
flash-structure kernel, with or without the self-term, any number of query
rows, either grid), `paged_attention` (the single-row entry the writefirst
decode step attends with), `paged_kv_update_rows{,_q}` (one decode step's
rows of every layer), `paged_kv_update{,_q}` (rows at absolute page ids, the
JAX contract), `paged_kv_update_layer{,_q}` (a layer's S rows a slot in one
launch: the verify step's and the writefirst step's writes),
`quantize_kv`/`dequant_kv` and the pool forms, `paged_attention_reference`;
`paged_attention_batched` / `paged_attention_paired` are the kernels of the
probes `experiments/batched_paged_attention_probe.py` and
`experiments/paired_slot_attention_probe.py` (`fa_batched`, `fa_paired`),
which `paged_attention_fa` runs when it is given `pages_per_block` or
`slot_block`.
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

import dataclasses
import functools
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
batched_launches = 0  # K10 launches (`paged_attention_batched`)
paired_launches = 0  # K11 launches (`paged_attention_paired`)
rows_launches = 0  # K4 launches through `paged_kv_update_rows{,_q}`
update_launches = 0  # K4 launches through `paged_kv_update{,_q}`, `paged_kv_update_layer{,_q}`
_kernels.register_counters(__name__, "attn_launches", "batched_launches", "paired_launches",
                           "rows_launches", "update_launches")


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


# K3's launch (`csrc/paged_attn_decode.cu`): the tiles of query rows and the
# splits of a slot's pages. They move with the kernel.
MAX_SPLITS = 32  # the kernel's kMaxSplits


def blocks_per_sm(quant: bool, tile_rows: int) -> int:
    """K3 blocks an SM runs at once (`Pool::kBlocksPerSm`): int8 tiles of 16
    rows (a ring of two pages) three, of 32 (three pages, more registers)
    two; bf16 pools (pages twice as large) one."""
    return (3 if tile_rows == 16 else 2) if quant else 1


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """A K3 launch: a block per (split, kv head, row tile, slot). A (slot, kv
    head)'s S·G query rows go in `tiles` tiles of `tile_rows` (16 or 32: the
    tensor-core product's M), and the pages a tile's rows attend are shared
    among `splits` blocks."""

    tile_rows: int
    tiles: int
    splits: int

    def pages(self, split: int, tile: int, length: int, q_off: int, S: int, G: int, ps: int,
              pps: int, window: Optional[int] = None) -> Tuple[int, int]:
        """The table pages [first, end) that block (split, tile) of a slot
        walks, as the kernel finds them (`split_pages`): the pages below
        `length` and within the table, none wholly after the tile's last
        query row or wholly before the window of its first, in even shares
        of ceil(valid / splits), in order; an empty range is first == end."""
        row0 = tile * self.tile_rows
        rows_here = min(self.tile_rows, S * G - row0)
        n_pages = min(-(-length // ps), pps)
        last_pos = q_off + (row0 + rows_here - 1) // G
        n_pages = min(n_pages, 0 if last_pos < 0 else last_pos // ps + 1)
        lo = 0
        if window:
            w0 = q_off + row0 // G - (window - 1)
            lo = w0 // ps if w0 > 0 else 0
        valid = max(0, n_pages - lo)
        share = -(-valid // self.splits)
        first = min(lo + split * share, lo + valid)
        return first, min(first + share, lo + valid)


@functools.lru_cache(maxsize=4096)
def split_plan(B: int, Hkv: int, rows: int, pps: int, sms: int, quant: bool = True,
               per_sm: Optional[int] = None) -> SplitPlan:
    """K3's launch for B slots of `rows` = S·(Hq/Hkv) query rows per kv head
    over a table `pps` pages wide, on a card of `sms` SMs. From shapes only
    (never `lengths`, which would synchronise): tiles of 16 rows (decode's 4,
    a tile of one mma) or 32, and the pages split only where the (slot, kv
    head, tile) units leave the card's block slots idle (`per_sm` an SM, by
    default `blocks_per_sm`): into as many splits as the slots hold whole
    sets of units, at most one a table page and `MAX_SPLITS`. A split that
    adds a second wave of blocks costs more than the pages it shares out."""
    tile_rows = 16 if rows <= 16 else 32
    tiles = -(-rows // tile_rows)
    units = max(1, B * Hkv * tiles)
    slots = sms * (per_sm or blocks_per_sm(quant, tile_rows))
    splits = max(1, min(pps, MAX_SPLITS, slots // units))
    return SplitPlan(tile_rows, tiles, splits)


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
    pps = page_table.shape[1]
    plan = split_plan(B, Hkv, S * (Hq // Hkv), pps, _kernels.sm_count(dev.index), quant)
    ws_o = ws_ml = counters = None
    if plan.splits > 1:  # held until the launch is queued
        units = B * Hkv * plan.tiles
        ws_o = torch.empty(units * plan.splits * plan.tile_rows * D, dtype=torch.float32,
                           device=dev)
        ws_ml = torch.empty(units * plan.splits * plan.tile_rows * 2, dtype=torch.float32,
                            device=dev)
        counters = _kernels.split_counts(dev, units)
    code = _kernels.lib().vzt_paged_attn_decode(
        q.data_ptr(), out.data_ptr(), k_pages.data_ptr(), _ptr(v_pages), _ptr(k_scales),
        _ptr(v_scales), page_table.data_ptr(), lengths.data_ptr(), q_offs.data_ptr(),
        _ptr(k_new), _ptr(v_new), _ptr(ws_o), _ptr(ws_ml), _ptr(counters), B, S, Hq, Hkv, N,
        ps, pps, int(page_offset), int(sliding_window or 0), int(quant), plan.tile_rows,
        plan.splits, float(scale), _kernels.stream_ptr(dev))
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
    pages_per_block: Optional[int] = None,
    slot_block: Optional[int] = None,
) -> torch.Tensor:
    """Flash-structure paged attention. Query row j of slot b sits at position
    `q_offs[b] + j` and attends pool slots `[max(0, pos − window + 1), pos]`
    below `lengths[b]`; S = 1 with `q_offs = lengths − 1` is single-token
    decode over a pool that already holds the token.

    Any S ≥ 1: the kernel takes the S·(Hq/Hkv) query rows of a kv head in
    tiles of 16 or 32 rows, and splits a slot's pages over several blocks
    where the grid would leave SMs idle (`split_plan`). S > 1 without the
    self-term is the verify step's shape: the rows are already in the pool
    and `q_offs` is the position of the first.

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
    package's refusals: no self-term and no fused pools, and no
    `slot_block` above 1. Every value launches K3, whose grid (split, kv
    head, row tile, slot) holds the (slot, kv head) grid: the TPU folded the
    heads to divide a fixed cost per grid cell over more work, and a CUDA
    block pays no such cost in the same way.

    `pages_per_block` (the online softmax's step, in pages) and `slot_block`
    (slots a grid cell owns) are the JAX package's TPU tilings. With both
    None the call runs K3, which steps one page (128 keys) at a time per
    block; the served steps pass neither. Given either, in the configuration the probes' kernels
    take (KV-fused int8 pools, the self-term, S = 1, head_dim 128, at most
    4 query heads a kv head, a block's scores within a block's shared
    memory: `grouped_fits`) the call runs K10 (`paged_attention_batched`)
    when `slot_block` is None or 1 and K11 (`paged_attention_paired`, P =
    `slot_block`) above 1, with B padded to a multiple of `slot_block` by
    empty slots as in the JAX package; `pages_per_block` None then takes
    the JAX default, the pages of 768 tokens, at most 6. In any other
    configuration they run K3, which computes the same function: the step
    only moves where the probabilities round to bf16. The launch counters
    say which ran.
    Returns [B, S, Hq, D]."""
    B, S, Hq, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    if slot_block is not None and slot_block > 1 and fold_heads is False:
        raise ValueError("slot_block requires the folded grid")
    if k_new is not None and (S != 1 or fold_heads is False):
        raise ValueError("k_new/v_new self-term requires S == 1 and the folded grid")
    if v_pages is None and fold_heads is False:
        raise ValueError("KV-fused pools require the folded grid")
    tiled = pages_per_block is not None or slot_block is not None
    if tiled and pages_per_block is None:
        pages_per_block = min(max(DEFAULT_BLOCK_TOKENS // _page_size(k_pages, v_pages is None), 1),
                              6, page_table.shape[1])
    if (tiled and v_pages is None and k_scales is not None and k_new is not None and S == 1
            and grouped_fits(Hq, k_pages.shape[1], D, k_pages.shape[3], k_pages.shape[2] // 2,
                             page_table.shape[1], pages_per_block,
                             paired=min(slot_block or 1, B) > 1)):
        sb = max(1, min(slot_block or 1, B))
        if sb == 1:
            return paged_attention_batched(q, k_pages, page_table, lengths, q_offs, k_new, v_new,
                                           k_scales, pages_per_block, sliding_window, scale,
                                           page_offset)
        pad = (-B) % sb
        if pad:  # empty slots: length 0, table row 0; sliced off below
            def padded(t):
                return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])

            q, page_table, lengths, q_offs, k_new, v_new = map(
                padded, (q, page_table, lengths, q_offs, k_new, v_new))
        out = paged_attention_paired(q, k_pages, page_table, lengths, q_offs, k_new, v_new,
                                     k_scales, pages_per_block, sliding_window, scale,
                                     page_offset, pair=sb)
        return out[:B]
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


# -- K10, K11: the served configuration a slot or a group of slots a block ------------

DEFAULT_BLOCK_TOKENS = 768  # the JAX package's default online-softmax step, in tokens
GROUPED_MAX_G = 4           # K10 / K11 hold at most 4 query heads per kv head
GROUPED_SMEM_BYTES = 232448  # a block's shared memory on the H100 (227 KB)


def grouped_fits(Hq: int, Hkv: int, D: int, pool_d: int, ps: int, pps: int,
                 pages_per_block: int, paired: bool = False) -> bool:
    """Whether K10 (or K11, `paired`) takes this shape: head_dim 128, Hq a
    multiple of Hkv by at most 4, and one warp's scores of a block (4 rows
    and the V scales of `min(pages_per_block, pps) · ps` tokens, 4 floats of
    padding a row) within a block's shared memory, as
    `csrc/paged_attn_grouped.cu` lays them out (K11's block, a ring of two
    stages and 4 rows of scores, then fits too: `paired_smem`); K11 also
    needs `ps` a multiple of 4 (its scales come by 16-byte bulk copies)."""
    bk = min(pages_per_block, pps) * ps
    return (D == HEAD_DIM and pool_d == D and Hkv > 0 and Hq % Hkv == 0
            and Hq // Hkv <= GROUPED_MAX_G
            and (GROUPED_MAX_G + 1) * (bk + 4) * 4 <= GROUPED_SMEM_BYTES
            and (not paired or ps % 4 == 0))


# K11's launch (`csrc/paged_attn_paired.cu`): a block per (slot, kv head,
# split), its ring and scores. They move with the kernel.
PAIRED_STAGE_BYTES = 128 * 128 + 128 * 4  # a stage: 128 int8 rows and their scales
PAIRED_FIXED_BYTES = 1024 + 6144          # alignment slack and the fixed region
PAIRED_BLOCKS_PER_SM = 3                  # its launch bounds
SM_SMEM_BYTES = 233472                    # an SM's shared memory, 1 KB of it per block reserved


def paired_smem(bk: int) -> int:
    """Dynamic shared memory of a K11 block whose online softmax steps over
    `bk` tokens: a ring of three stages, two where three leave the scores (4
    rows of bk floats) no room (`smem_bytes` in the kernel)."""
    three = PAIRED_FIXED_BYTES + 3 * PAIRED_STAGE_BYTES + 16 * bk
    return three if three <= GROUPED_SMEM_BYTES else three - PAIRED_STAGE_BYTES


@functools.lru_cache(maxsize=4096)
def paired_plan(B: int, Hkv: int, ps: int, pps: int, pages_per_block: int, sms: int) -> int:
    """K11's splits of a slot's walk for B slots over a table `pps` pages wide
    on a card of `sms` SMs, from shapes only (K3's `split_plan` rule): the
    (slot, kv head) units fill the card's block slots first, and a slot's
    blocks of `min(pages_per_block, pps) · ps` tokens are split only where
    the units leave slots idle, into as many splits as the slots hold whole
    sets of units, at most one a block of the table and `MAX_SPLITS`."""
    bk_pages = min(pages_per_block, pps)
    per_sm = min(PAIRED_BLOCKS_PER_SM,
                 SM_SMEM_BYTES // (paired_smem(bk_pages * ps) + 1024))
    units = max(1, B * Hkv)
    return max(1, min(-(-pps // bk_pages), MAX_SPLITS, sms * per_sm // units))


def paired_split_blocks(lo: int, hi: int, bk: int, splits: int, split: int) -> Tuple[int, int]:
    """The blocks [first, end) of `bk` tokens that split `split` of a slot
    walks, as K11 finds them (`split_blocks`): the blocks that hold a key of
    [lo, hi), in even shares of ceil(n / splits), in order."""
    if hi <= lo:
        return 0, 0
    b0, b1 = lo // bk, -(-hi // bk)
    share = -(-(b1 - b0) // splits)
    first = min(b0 + split * share, b1)
    return first, min(first + share, b1)


def paged_attention_grouped_plain(q, k_pages, page_table, lengths, q_offs, k_new, v_new, k_scales,
                                  pages_per_block: int, sliding_window=None, scale=None,
                                  page_offset: int = 0, splits: int = 1) -> torch.Tensor:
    """K10's and K11's arithmetic in plain PyTorch (the slots a block owns do
    not change a slot's): KV-fused int8 pools, S = 1, the self-term. Scores
    in f32 with the K scales, then an online softmax over blocks of
    `bk = min(pages_per_block, pps) · ps` tokens numbered from token 0: a
    block's probabilities are exp(s − m) of the running maximum after the
    block, times the V scales, rounded to q's dtype before P·V. The
    self-term last, unquantized. Rows at or past `length` never reach the
    output. Returns [B, 1, Hq, D].

    `splits` > 1 is K11's split walk: a slot's blocks that hold a key go in
    `splits` even shares (`paired_split_blocks`), each share runs the online
    softmax from a fresh maximum, so its probabilities round against its own
    running maximum, and the shares are merged in order, those without a key
    skipped (weights exp(m_s − M), M the largest m of the others)."""
    B, S, Hq, D = q.shape
    Hkv = k_pages.shape[1]
    ps = _page_size(k_pages, True)
    G = Hq // Hkv
    pps = page_table.shape[1]
    T = pps * ps
    bk = min(pages_per_block, pps) * ps
    scale = D ** -0.5 if scale is None else scale
    idx = page_table.long() + page_offset                       # [B, pps]

    def rows(pool, lo):  # → [B, Hkv, T, ...]
        r = pool[idx][:, :, :, lo:lo + ps].transpose(1, 2)
        return r.reshape((B, Hkv, T) + tuple(r.shape[4:]))

    slot = torch.arange(T, device=q.device)[None, :]
    qpos = q_offs.long()[:, None]
    mask = (slot <= qpos) & (slot < lengths.long()[:, None])    # [B, T]
    if sliding_window is not None:
        mask = mask & (slot > qpos - sliding_window)
    k = rows(k_pages, 0).float()                                # [B, Hkv, T, D]
    v = torch.where(mask[:, None, :, None], rows(k_pages, ps).float(), 0.0)
    qg = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bhtd->bhgt", qg, k) * scale
    s = s * (rows(k_scales, 0) * (1.0 / KV_QUANT_MAX))[:, :, None, :]
    v_mul = (rows(k_scales, ps) * (1.0 / KV_QUANT_MAX))[:, :, None, :]

    def walk(valid):  # the online softmax over the blocks, keys `valid` [B, T]
        mask4 = valid[:, None, None, :]
        sv = torch.where(mask4, s, NEG_INF)
        m = torch.full((B, Hkv, G, 1), -float("inf"), device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Hkv, G, D), device=q.device)
        for lo in range(0, T, bk):
            blk = slice(lo, lo + bk)
            sb, mb = sv[..., blk], mask4[..., blk]
            m_next = torch.maximum(m, sb.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_next)
            p = torch.where(mb, torch.exp(sb - m_next), 0.0)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            p = torch.where(mb, p * v_mul[..., blk], 0.0).to(q.dtype).float()
            acc = acc * alpha + torch.einsum("bhgt,bhtd->bhgd", p, v[:, :, blk])
            m = m_next
        return m, l, acc

    if splits == 1:
        m, l, acc = walk(mask)
    else:
        # Block j of slot b belongs to split (j − b0) // share (the kernel's
        # `split_blocks`); masked keys are in no split's walk.
        lo_key = (torch.clamp(qpos[:, 0] - sliding_window + 1, min=0) if sliding_window
                  is not None else torch.zeros_like(qpos[:, 0]))
        hi_key = torch.clamp(torch.minimum(lengths.long(), qpos[:, 0] + 1), max=T)
        b0 = lo_key // bk
        share = torch.clamp(-((b0 - (hi_key + bk - 1) // bk) // splits), min=1)
        owner = (slot // bk - b0[:, None]) // share[:, None]    # [B, T]
        parts = [walk(mask & (owner == sp)) for sp in range(splits)]
        has = [part[1] > 0 for part in parts]
        m = torch.full_like(parts[0][0], -float("inf"))
        for (m_s, _, _), h in zip(parts, has):
            m = torch.where(h, torch.maximum(m, m_s), m)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(parts[0][2])
        for (m_s, l_s, acc_s), h in zip(parts, has):
            w = torch.where(h, torch.exp(m_s - m), 0.0)
            l = l + l_s * w
            acc = acc + torch.where(h, acc_s * w, 0.0)
    kn = k_new.to(q.dtype).float()                              # [B, Hkv, D]
    vn = v_new.to(q.dtype).float()
    s_self = torch.einsum("bhgd,bhd->bhg", qg, kn)[..., None] * scale
    m_next = torch.maximum(m, s_self)
    alpha = torch.exp(m - m_next)
    p_self = torch.exp(s_self - m_next)
    l = alpha * l + p_self
    acc = acc * alpha + p_self * vn[:, :, None, :]
    l_inv = torch.where(l == 0.0, torch.zeros_like(l), 1.0 / l)
    return (acc * l_inv).to(q.dtype).reshape(B, 1, Hq, D)


def _launch_grouped(q, k_pages, page_table, lengths, q_offs, k_new, v_new, k_scales,
                    pages_per_block, sliding_window, scale, page_offset, pair) -> torch.Tensor:
    """One K10 launch (pair None) or K11 launch (pair >= 2)."""
    global batched_launches, paired_launches
    name = "paged_attention_batched" if pair is None else "paged_attention_paired"
    B, _, Hq, D = q.shape
    N, Hkv, rows, _ = k_pages.shape
    pps = page_table.shape[1]
    dev = q.device
    if not grouped_fits(Hq, Hkv, D, k_pages.shape[3], rows // 2, pps, pages_per_block,
                        paired=pair is not None):
        raise ValueError(f"{name}: head_dim must be {HEAD_DIM}, Hq a multiple of Hkv by at most "
                         f"{GROUPED_MAX_G}, a block's scores within {GROUPED_SMEM_BYTES} bytes "
                         f"of shared memory (and for K11 pages a multiple of 4 rows); "
                         f"q={tuple(q.shape)}, pool={tuple(k_pages.shape)}, "
                         f"pages_per_block={pages_per_block}")
    _check_cuda("q", q, dev, torch.bfloat16)
    _check_cuda("k_pages", k_pages, dev, torch.int8)
    _check_cuda("k_scales", k_scales, dev, torch.float32, (N, Hkv, rows))
    _check_cuda("page_table", page_table, dev, torch.int32, (B, page_table.shape[1]))
    _check_cuda("lengths", lengths, dev, torch.int32, (B,))
    _check_cuda("q_offs", q_offs, dev, torch.int32, (B,))
    _check_cuda("k_new", k_new, dev, torch.bfloat16, (B, Hkv, D))
    _check_cuda("v_new", v_new, dev, torch.bfloat16, (B, Hkv, D))
    if any(t.data_ptr() % 16 for t in (q, k_pages, k_new, v_new)):
        raise ValueError(f"{name}: q, the pool and k_new / v_new must be 16-byte aligned")
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), out.data_ptr(), k_pages.data_ptr(), k_scales.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), q_offs.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr())
    shape = (int(pages_per_block), int(page_offset), int(sliding_window or 0))
    if pair is None:
        code = _kernels.lib().vzt_paged_attn_batched(
            *ptrs, B, Hq, Hkv, rows // 2, pps, *shape, float(scale), _kernels.stream_ptr(dev))
        _kernels.check(code, "vzt_paged_attn_batched")
        batched_launches += 1
        return out
    splits = paired_plan(B, Hkv, rows // 2, pps, int(pages_per_block),
                         _kernels.sm_count(dev.index))
    ws_o = ws_ml = counters = None
    if splits > 1:  # held until the launch is queued
        units = B * Hkv
        ws_o = torch.empty(units * splits * GROUPED_MAX_G * D, dtype=torch.float32, device=dev)
        ws_ml = torch.empty(units * splits * GROUPED_MAX_G * 2, dtype=torch.float32, device=dev)
        counters = _kernels.split_counts(dev, units)
    code = _kernels.lib().vzt_paged_attn_paired(
        *ptrs, _ptr(ws_o), _ptr(ws_ml), _ptr(counters), B, Hq, Hkv, N, rows // 2, pps, *shape,
        int(pair), splits, float(scale), _kernels.stream_ptr(dev))
    _kernels.check(code, "vzt_paged_attn_paired")
    paired_launches += 1
    return out


def _grouped(q, k_pages, page_table, lengths, q_offs, k_new, v_new, k_scales, pages_per_block,
             sliding_window, scale, page_offset, pair) -> torch.Tensor:
    name = "paged_attention_batched" if pair is None else "paged_attention_paired"
    if q.dim() != 4 or q.shape[1] != 1 or k_pages.dim() != 4 or k_pages.shape[2] % 2:
        raise ValueError(f"{name}: q must be [B, 1, Hq, D] and the pool KV-fused "
                         f"[N, Hkv, 2·ps, D]; q={tuple(q.shape)}, pool={tuple(k_pages.shape)}")
    if pages_per_block < 1 or (pair is not None and pair < 2):
        raise ValueError(f"{name}: pages_per_block must be >= 1 and pair >= 2, got "
                         f"{pages_per_block}, {pair}")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if not _kernels.use_kernel(q):
        # Under `plain_versions()` on the card, K11's plain version splits a
        # slot's walk as the kernel's plan does there; on the CPU, one split.
        splits = 1
        if pair is not None and q.device.type == "cuda":
            splits = paired_plan(q.shape[0], k_pages.shape[1], k_pages.shape[2] // 2,
                                 page_table.shape[1], int(pages_per_block),
                                 _kernels.sm_count(q.device.index))
        return paged_attention_grouped_plain(q, k_pages, page_table, lengths, q_offs, k_new,
                                             v_new, k_scales, pages_per_block, sliding_window,
                                             scale, page_offset, splits)
    return _launch_grouped(q, k_pages, page_table, lengths, q_offs, k_new, v_new, k_scales,
                           pages_per_block, sliding_window, scale, page_offset, pair)


def paged_attention_batched(q, k_pages, page_table, lengths, q_offs, k_new, v_new, k_scales,
                            pages_per_block: int = 8, sliding_window: Optional[int] = None,
                            scale: Optional[float] = None, page_offset: int = 0) -> torch.Tensor:
    """Decode attention over a KV-fused int8 pool with the self-term, one
    block a slot over all its kv heads (K10, the TPU kernel
    `experiments/batched_paged_attention_probe.py::_batched_kernel`).

    q [B, 1, Hq, D] bf16; k_pages [N, Hkv, 2·ps, D] int8 (a page's K rows,
    then its V rows); k_scales [N, Hkv, 2·ps] f32; page_table [B, pps] int32
    within-layer ids, `page_offset` added to each; lengths [B] tokens in the
    pool; q_offs [B] the query's position (the pool holds [0, lengths) and
    the query sits at `q_offs = lengths` in a decode step); k_new, v_new
    [B, Hkv, D] the current token, folded in last. The online softmax steps
    over blocks of `min(pages_per_block, pps) · ps` tokens. On a CUDA tensor
    K10 (head_dim 128, Hq / Hkv ≤ 4); on a CPU tensor its plain version.
    Returns [B, 1, Hq, D]."""
    return _grouped(q, k_pages, page_table, lengths, q_offs, k_new, v_new, k_scales,
                    pages_per_block, sliding_window, scale, page_offset, None)


def paged_attention_paired(q, k_pages, page_table, lengths, q_offs, k_new, v_new, k_scales,
                           pages_per_block: int = 6, sliding_window: Optional[int] = None,
                           scale: Optional[float] = None, page_offset: int = 0,
                           pair: int = 2) -> torch.Tensor:
    """`paged_attention_batched`'s function for groups of `pair` consecutive
    slots (K11, `csrc/paged_attn_paired.cu`, the TPU kernel
    `experiments/paired_slot_attention_probe.py::_paired_kernel`); the last
    group may be short. K11 runs a block per (slot, kv head), the blocks of
    a group adjacent, and splits a slot's walk where the units leave the
    card idle (`paired_plan`); with one split its arithmetic is K10's slot
    for slot. On a CPU tensor the plain version with one split (its `splits`
    argument reproduces a split walk's rounding)."""
    return _grouped(q, k_pages, page_table, lengths, q_offs, k_new, v_new, k_scales,
                    pages_per_block, sliding_window, scale, page_offset, pair)


# -- K4: rows into the pools -------------------------------------------------------


def _kv_write_plain(k_pages, v_pages, k_scales, v_scales, ks, vs, pages, offsets) -> None:
    """Rows ks/vs [n, Hkv, D] in launch order ((s, b), s outer) to absolute
    pool pages `pages` [n] (long), row `offsets` [n] (its V row `ps` further
    in a fused pool). Where rows land on one pool row (the trash page's), the
    last of them in launch order is written, as on the card."""
    fused = v_pages is None
    quant = k_scales is not None
    Hkv = ks.shape[1]
    ps = _page_size(k_pages, fused)
    offsets = offsets.long()
    key = pages * ps + offsets
    keep = ~torch.triu(key[:, None] == key[None, :], diagonal=1).any(dim=1)
    pages, offsets, ks, vs = pages[keep], offsets[keep], ks[keep], vs[keep]
    page = pages[:, None]
    head = torch.arange(Hkv, device=k_pages.device)[None, :]
    k_row = offsets[:, None]
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


# The three forms of a K4 call: (its wrappers, the rows' shape, the page ids
# and offsets).
#   "rows":   `paged_kv_update_rows{,_q}`, ks [L, B, Hkv, D], within-layer ids [B], offsets [B]
#   "update": `paged_kv_update{,_q}`, ks [L, B, Hkv, D], absolute ids [L, B], offsets [B]
#   "layer":  `paged_kv_update_layer{,_q}`, ks [B, S, Hkv, D] (any strides over B and S),
#             within-layer ids [S, B] + page_base, offsets [S, B]
_FORM_NAMES = {"rows": "paged_kv_update_rows", "update": "paged_kv_update",
               "layer": "paged_kv_update_layer"}


def _plain_order(k_pages, ks, vs, pages, offsets, form: str, page_base: int):
    """The rows, absolute pages and offsets of a call, flat in launch order."""
    pages = pages.long()
    if form == "layer":
        S, B = pages.shape
        return (ks.transpose(0, 1).reshape(S * B, *ks.shape[2:]),
                vs.transpose(0, 1).reshape(S * B, *vs.shape[2:]),
                (pages + page_base).reshape(-1), offsets.reshape(-1))
    L, B = ks.shape[:2]
    if form == "rows":  # within-layer ids [B] → absolute [L, B]
        pages = torch.arange(L, device=pages.device)[:, None] * (k_pages.shape[0] // L) + pages
    return (ks.reshape(L * B, *ks.shape[2:]), vs.reshape(L * B, *vs.shape[2:]),
            pages.reshape(-1), offsets.expand(L, B).reshape(-1))


def _launch_write(k_pages, v_pages, k_scales, v_scales, ks, vs, pages, offsets, form: str,
                  page_base: int) -> None:
    """One K4 launch: `vzt_paged_kv_rows` for the "rows" form,
    `vzt_paged_kv_update` for the others."""
    global rows_launches, update_launches
    name = _FORM_NAMES[form]
    fused = v_pages is None
    quant = k_scales is not None
    Hkv, D = ks.shape[2:]
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
    if form == "layer":
        B, S = ks.shape[:2]
        id_shape = off_shape = (S, B)
    else:
        S, B = ks.shape[:2]  # S: the layers
        id_shape, off_shape = ((B,) if form == "rows" else (S, B)), (B,)
    _check_cuda("pages", pages, dev, torch.int32, id_shape)
    _check_cuda("offsets", offsets, dev, torch.int32, off_shape)
    for what, t in (("ks", ks), ("vs", vs)):
        if t.device != dev or t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {what} must be bf16 on {dev}, got {t.dtype} on {t.device}")
        if t.stride()[2:] != (D, 1) or t.stride() != ks.stride() or t.data_ptr() % 8:
            raise ValueError(f"{name}: {what} must hold each (row, head) as D contiguous "
                             "elements, 8-byte aligned, with the strides of ks")
    if D != HEAD_DIM or (form == "rows" and (N % S or not ks.is_contiguous())):
        raise ValueError(f"{name}: head_dim {D} is not {HEAD_DIM}, or {N} pool pages are not "
                         f"{S} layers of pages, or the rows are not contiguous")
    ps = _page_size(k_pages, fused)
    lib = _kernels.lib()
    ptrs = (k_pages.data_ptr(), _ptr(v_pages), _ptr(k_scales), _ptr(v_scales), ks.data_ptr(),
            vs.data_ptr(), pages.data_ptr(), offsets.data_ptr())
    stream = _kernels.stream_ptr(dev)
    if form == "rows":
        code = lib.vzt_paged_kv_rows(*ptrs, S, B, Hkv, D, N // S, ps, stream)
        _kernels.check(code, "vzt_paged_kv_rows")
        rows_launches += 1
        return
    if form == "layer":
        row_s, row_b, off_s = ks.stride(1), ks.stride(0), B
    else:
        row_s, row_b, off_s, page_base = ks.stride(0), ks.stride(1), 0, 0
    code = lib.vzt_paged_kv_update(*ptrs, S, B, Hkv, D, ps, page_base, row_s, row_b, off_s,
                                   stream)
    _kernels.check(code, "vzt_paged_kv_update")
    update_launches += 1


def _kv_write(k_pages, v_pages, k_scales, v_scales, ks, vs, pages, offsets, form: str,
              page_base: int = 0) -> None:
    if vs.shape != ks.shape or k_pages.shape[1] != ks.shape[2] or k_pages.shape[3] != ks.shape[3]:
        raise ValueError(f"{_FORM_NAMES[form]}: rows {tuple(ks.shape)} / {tuple(vs.shape)} do "
                         f"not fit pool {tuple(k_pages.shape)}")
    if _kernels.use_kernel(k_pages):
        _launch_write(k_pages, v_pages, k_scales, v_scales, ks, vs, pages, offsets, form,
                      page_base)
        return
    _kv_write_plain(k_pages, v_pages, k_scales, v_scales,
                    *_plain_order(k_pages, ks, vs, pages, offsets, form, page_base))


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
    _kv_write(k_pages, v_pages, None, None, ks, vs, pages, offsets, "rows")
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
    _kv_write(k_pages, v_pages, k_scales, v_scales, ks, vs, pages, offsets, "rows")
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
    in a fused pool); rows that meet on one pool row leave the last in (l, b)
    order. The served steps call `paged_kv_update_layer`, the same K4 entry.
    Returns the pools."""
    _kv_write(k_pages, v_pages, None, None, ks, vs, page_ids, offsets, "update")
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
    _kv_write(k_pages, v_pages, k_scales, v_scales, ks, vs, page_ids, offsets, "update")
    return k_pages, v_pages, k_scales, v_scales


def paged_kv_update_layer(
    k_pages: torch.Tensor,            # [L·P, Hkv, ps, D] (2·ps fused), written in place
    v_pages: Optional[torch.Tensor],  # None: KV-fused pool
    ks: torch.Tensor,                 # [B, S, Hkv, D] — a layer's S rows a slot, as projected
    vs: torch.Tensor,
    pages: torch.Tensor,              # [S, B] int32 within-layer page of row (s, b)
    offsets: torch.Tensor,            # [S, B] int32 row within the page
    page_base: int,                   # the layer's first pool page, layer · P
):
    """Write S rows a slot of one layer in one K4 launch: row (b, s) lands at
    pool page `page_base + pages[s, b]`, row `offsets[s, b]` (its V row at
    `ps + offsets[s, b]` in a fused pool). Rows that meet on one pool row
    (the trash page 0's: inactive slots' pad rows, rows forced there past a
    slot's span) leave the last in (s, b) order, as S sequential
    `paged_kv_update` calls do. `ks` / `vs` may be strided views (`k[:, :1]`):
    no copy is made. Returns the pools."""
    _kv_write(k_pages, v_pages, None, None, ks, vs, pages, offsets, "layer", page_base)
    return k_pages, v_pages


def paged_kv_update_layer_q(
    k_pages: torch.Tensor,            # int8, written in place
    v_pages: Optional[torch.Tensor],
    k_scales: torch.Tensor,           # [L·P, Hkv, rows] f32, written in place
    v_scales: Optional[torch.Tensor],
    ks: torch.Tensor,                 # [B, S, Hkv, D] float
    vs: torch.Tensor,
    pages: torch.Tensor,              # [S, B] int32 within-layer
    offsets: torch.Tensor,            # [S, B] int32
    page_base: int,
):
    """`paged_kv_update_layer` for int8 pools: each row is absmax-quantized
    (`quantize_kv`, in the kernel on the card) and written with its scale."""
    _kv_write(k_pages, v_pages, k_scales, v_scales, ks, vs, pages, offsets, "layer", page_base)
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
