"""Paged-KV continuous batching: the page-pool memory model behind
high-slot-count serving.

Port of `vis_zephyr_tpu/serve/paged.py`: `PageAllocator`, `_admit_paged`,
`_admit_paged_q`, `_clear_row`, `_paged_step` (modes "selfterm" and
"writefirst"),
`_paged_verify_step` (prompt-lookup speculation) and `PagedBatcher` with
eager full-span page allocation.

A dense per-slot cache pays for `cache_len` tokens per slot whether used or
not. Here K/V live as fixed-size pages in pools shared by all slots and are
addressed through per-slot page tables, so a request occupies only
`ceil((prompt + budget) / page_size)` pages.

- pools are page-major and layer-flat, `[L·num_pages, Hkv, rows, D]` (see
  `ops/paged_attention.py` for why); layer l's pages are entries
  `[l·num_pages, (l+1)·num_pages)` and the decode step passes `l·num_pages`
  to the attention kernel as an offset, so one page table serves all layers.
- page 0 (of every layer) is a reserved trash page: inactive slots write
  their dummy token there, and unused page-table entries point at it.
- allocation is host-side (a free list): a request's full span (prompt pages
  + generation budget) is claimed at admission and released at finish.
- the decode step attends FIRST and writes ONCE: each layer runs the
  paged-attention kernel over the read-only pools with the current token's
  K/V as an online-softmax self-term, and after the layer loop all layers'
  rows are written by one launch (`paged_kv_update_rows{,_q}`). The older
  "writefirst" step (the JAX package's measured fallback) writes each
  layer's row first (`paged_kv_update_layer{,_q}`) and attends over the
  pool with the token in it (`paged_attention`); no batcher takes it by
  default.
- the speculative verify step (`lookahead`) writes its S = lookahead + 1
  candidate rows first, all of a layer's in one launch
  (`paged_kv_update_layer{,_q}`; the JAX step writes one row a call), then
  attends all S rows at once without a self-term; the host then rolls
  `lengths` back to the accepted prefix.
- int8 KV (`kv_quant=True`): pools hold int8 rows with per-row absmax scales
  (row ≈ int8 · scale / 127.5). Admission quantizes on write, the decode
  write quantizes in the kernel, and the attention kernel folds the scales
  into scores and probabilities.
- KV-fused pools (`kv_fused=True`): one pool, each page holding its K rows
  then its V rows. Everywhere here `vp is None` / `vsp is None` means fused.
- sliding window: when `cache_len` exceeds `decoder.sliding_window` the
  kernel masks slots below `length − window` and skips their pages.

The JAX programs return new pools and rely on donation. Here pools,
`page_table`, `lengths` and `token` are updated in place, and only one thread
(the engine's pump) may call `step`.

Not ported yet, each raising `NotImplementedError` when asked for: meshes and
the TP wrappers, multi-LoRA, grammars, logprobs, penalties, per-slot sampling
overrides, a draft model, multi-step bursts, the prefix cache, lazy
allocation with host swap, and metrics.
"""

from __future__ import annotations

import bisect
import queue
from collections import deque
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import VisZephyrConfig
from ..models.mistral import _project_qkv, embed, rms_norm, rope_cos_sin
from ..models.vis_zephyr import VisZephyr
from ..ops.paged_attention import (paged_attention, paged_attention_fa, paged_kv_update_layer,
                                   paged_kv_update_layer_q, paged_kv_update_rows,
                                   paged_kv_update_rows_q, quantize_kv)
from .batching import ContinuousBatcher, _prefill_kv, _Request, not_ported
from .generate import SamplingConfig, _sample


class PageAllocator:
    """Free-list over pool pages. Page 0 is reserved (trash).

    `alloc` prefers a CONTIGUOUS ascending run (first fit over the sorted
    free list) and falls back to the lowest free pages under fragmentation;
    the attention kernel takes any page order. The JAX class also counts
    holders per page for its prefix cache; that comes with the cache."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free: List[int] = list(range(1, num_pages))  # sorted ascending
        self._held: set = set()

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        free = self._free
        if len(free) < n:
            return None
        pages = None
        run_start = 0
        for i in range(1, len(free)):
            if free[i] != free[i - 1] + 1:
                run_start = i
            if i - run_start + 1 == n:  # run length grows by 1 → first hit
                pages = free[run_start:i + 1]
                del free[run_start:i + 1]
                break
        if pages is None:
            if n == 1 and free:
                pages = [free.pop(0)]
            else:
                # Fragmented: lowest n pages (keeps future runs high).
                pages = free[:n]
                del free[:n]
        self._held.update(pages)
        return pages

    def release(self, pages: List[int]) -> None:
        for p in pages:
            self._held.remove(p)  # KeyError: a page released twice
            bisect.insort(self._free, p)


def _page_blocks(x: torch.Tensor, ps: int) -> torch.Tensor:
    """[L, T, Hkv, ...] → page blocks [L, T/ps, Hkv, ps, ...]."""
    L, T, Hkv = x.shape[:3]
    return x.reshape((L, T // ps, ps, Hkv) + tuple(x.shape[3:])).transpose(2, 3)


def _by_layer(pool: torch.Tensor, L: int) -> torch.Tensor:
    """Pool [L·P, ...] viewed [L, P, ...] (no copy: writes reach the pool)."""
    return pool.view((L, pool.shape[0] // L) + tuple(pool.shape[1:]))


@torch.no_grad()
def _admit_paged(kp, vp, page_table, lengths, k, v, length: int, row, *, slot: int):
    """Write a prefilled sequence's K/V into its allocated pages and install
    its page-table row. k/v: [L, T, Hkv, D] with T a page-size multiple; the
    same within-layer page id is written in every layer's segment. KV-fused
    pools (`vp=None`): pages are [2·ps, D], K rows then V rows. In place;
    returns what it was given. (The JAX function's `start`, the first page to
    write on a prefix-cache hit, comes with the prefix cache.)"""
    fused = vp is None
    L, T = k.shape[:2]
    ps = kp.shape[2] // 2 if fused else kp.shape[2]
    n = T // ps
    pages = torch.as_tensor(np.asarray(row[:n], np.int64), device=kp.device)
    kb = _page_blocks(k.to(kp.dtype), ps)              # [L, n, Hkv, ps, D]
    vb = _page_blocks(v.to(kp.dtype), ps)
    if fused:
        _by_layer(kp, L)[:, pages] = torch.cat([kb, vb], dim=3)
    else:
        _by_layer(kp, L)[:, pages] = kb
        _by_layer(vp, L)[:, pages] = vb
    page_table[slot] = torch.as_tensor(np.asarray(row, np.int32), device=page_table.device)
    lengths[slot] = int(length)
    return kp, vp, page_table, lengths


@torch.no_grad()
def _admit_paged_q(kp, vp, ksp, vsp, page_table, lengths, k, v, length: int, row, *,
                   slot: int):
    """`_admit_paged` for int8 pools: quantize the prefilled K/V per row
    (`quantize_kv`), write int8 blocks and scale blocks. Fused pools
    (`vp=None`, `vsp=None`): K rows then V rows, K scales then V scales."""
    fused = vp is None
    L, T = k.shape[:2]
    ps = kp.shape[2] // 2 if fused else kp.shape[2]
    n = T // ps
    pages = torch.as_tensor(np.asarray(row[:n], np.int64), device=kp.device)
    kq, ks = quantize_kv(k)   # [L, T, Hkv, D] int8, [L, T, Hkv, 1]
    vq, vs = quantize_kv(v)
    kb, vb = _page_blocks(kq, ps), _page_blocks(vq, ps)
    ksb = _page_blocks(ks[..., 0], ps)                 # [L, n, Hkv, ps]
    vsb = _page_blocks(vs[..., 0], ps)
    if fused:
        _by_layer(kp, L)[:, pages] = torch.cat([kb, vb], dim=3)
        _by_layer(ksp, L)[:, pages] = torch.cat([ksb, vsb], dim=3)
    else:
        _by_layer(kp, L)[:, pages] = kb
        _by_layer(vp, L)[:, pages] = vb
        _by_layer(ksp, L)[:, pages] = ksb
        _by_layer(vsp, L)[:, pages] = vsb
    page_table[slot] = torch.as_tensor(np.asarray(row, np.int32), device=page_table.device)
    lengths[slot] = int(length)
    return kp, vp, ksp, vsp, page_table, lengths


def _clear_row(page_table: torch.Tensor, slot: int) -> torch.Tensor:
    page_table[slot] = 0
    return page_table


@torch.no_grad()
def _paged_step(model: VisZephyr, kp, vp, scales: Tuple, page_table, lengths, token, active,
                generator: Optional[torch.Generator], cfg: VisZephyrConfig,
                sampling: SamplingConfig, mesh=None, mode: str = "selfterm", mlora=None,
                adapter_idx=None, sample_overrides=None, grammar=None,
                want_logprobs: bool = False, penalties=None):
    """One decode step over all slots against the paged pools.

    `scales`: `(None, None)` for bf16 pools, or `(k_scales, v_scales)`
    [L·P, Hkv, rows] f32 for int8 pools (`v_scales` None when fused).
    `active`: bool [B] on the device.

    `mode`:
    - "selfterm" (the default): each layer attends the READ-ONLY pools with
      the current token's K/V folded in as the attention kernel's
      self-term; after the layer loop ALL layers' rows are written by one
      launch (every layer of a slot shares one page id and offset).
    - "writefirst": each layer writes its row first
      (`paged_kv_update_layer{,_q}` at page `l·P + page`, one launch a
      layer) and attends over the pool with the token in it
      (`paged_attention`, lengths + 1).
    Any other value raises `ValueError` (the JAX step takes every other
    string as "writefirst").

    Inactive slots decode too: length 0, the trash page at offset 0, so
    their attention is the self-term alone (writefirst: the one trash-page
    row they just wrote); their token becomes `pad_token_id` and their
    length does not grow.

    The pools, `lengths` and `token` are updated IN PLACE. Returns
    (next_token [B], logits [B, V] f32)."""
    for value, what, step in (
            (mesh, "a device mesh (tensor-parallel paged step)", "Queue A step 13"),
            (mlora is not None or adapter_idx is not None, "multi-LoRA serving",
             "Queue A step 10"),
            (sample_overrides, "per-slot sampling overrides", "Queue A step 10"),
            (grammar, "structured output (grammar)", "Queue A step 10"),
            (want_logprobs, "logprobs", "Queue A step 10"),
            (penalties, "frequency / presence penalties", "Queue A step 10")):
        if value:
            raise not_ported(what, step)
    if mode not in ("selfterm", "writefirst"):
        raise ValueError(f"_paged_step: mode must be 'selfterm' or 'writefirst', got {mode!r}")
    dec = cfg.decoder
    decoder = model.decoder
    L = dec.num_layers
    P = kp.shape[0] // L  # pages per layer segment
    ps = kp.shape[2] // 2 if vp is None else kp.shape[2]
    B = token.shape[0]

    lengths_eff = torch.where(active, lengths, torch.zeros_like(lengths))
    positions = lengths_eff[:, None]  # the new token's position
    cos, sin = rope_cos_sin(positions, dec.head_dim, dec.rope_theta)
    h = embed(decoder, token[:, None])

    # Where the new token's K/V lands: inactive slots write the trash page.
    row_idx = torch.clamp(lengths_eff // ps, max=page_table.shape[1] - 1)
    cur_page = torch.gather(page_table, 1, row_idx[:, None].long())[:, 0]
    cur_page = torch.where(active, cur_page, torch.zeros_like(cur_page))
    offset = lengths_eff % ps

    # Sliding window only when a sequence can outgrow it (cache_len > window).
    cache_len = page_table.shape[1] * ps
    sw = dec.sliding_window
    window = sw if (sw is not None and cache_len > sw) else None

    ksp, vsp = scales
    # writefirst: attention spans the pool plus the row just written, so
    # inactive slots attend one trash-page row (finite; their token is
    # replaced below), never zero rows.
    lengths_next = lengths_eff + 1 if mode == "writefirst" else None
    ks_rows, vs_rows = [], []
    for i, layer in enumerate(decoder.model.layers):
        hn = rms_norm(h, layer.input_layernorm.weight, dec.rms_norm_eps)
        q, k, v = _project_qkv(hn, layer.self_attn, dec, cos, sin)
        k_new, v_new = k[:, 0], v[:, 0]
        if mode == "selfterm":
            attn = paged_attention_fa(q, kp, vp, page_table, lengths_eff, lengths_eff,
                                      sliding_window=window, k_scales=ksp, v_scales=vsp,
                                      k_new=k_new, v_new=v_new, page_offset=i * P)
            ks_rows.append(k_new)
            vs_rows.append(v_new)
        else:
            if ksp is None:
                paged_kv_update_layer(kp, vp, k[:, :1], v[:, :1], cur_page[None],
                                      offset[None], i * P)
            else:
                paged_kv_update_layer_q(kp, vp, ksp, vsp, k[:, :1], v[:, :1], cur_page[None],
                                        offset[None], i * P)
            attn = paged_attention(q[:, 0], kp, vp, page_table, lengths_next,
                                   sliding_window=window, k_scales=ksp, v_scales=vsp,
                                   page_offset=i * P)
        h = h + layer.self_attn.o_proj(attn.reshape(B, 1, -1))
        hn = rms_norm(h, layer.post_attention_layernorm.weight, dec.rms_norm_eps)
        h = h + layer.mlp(hn)
    if mode == "selfterm":
        ks_rows, vs_rows = torch.stack(ks_rows), torch.stack(vs_rows)   # [L, B, Hkv, D]
        if ksp is None:
            paged_kv_update_rows(kp, vp, ks_rows, vs_rows, cur_page, offset)
        else:
            paged_kv_update_rows_q(kp, vp, ksp, vsp, ks_rows, vs_rows, cur_page, offset)

    h = rms_norm(h, decoder.model.norm.weight, dec.rms_norm_eps)
    logits = decoder.lm_head(h[:, -1:]).float()[:, 0]
    next_token = _sample(logits, generator, sampling)
    next_token = torch.where(active, next_token, torch.full_like(next_token, dec.pad_token_id))
    token.copy_(next_token)
    lengths.add_(active.to(lengths.dtype))
    return next_token, logits


@torch.no_grad()
def _paged_verify_step(model: VisZephyr, kp, vp, scales: Tuple, page_table, lengths, toks,
                       active, cfg: VisZephyrConfig):
    """Batched speculative verify over the paged pools: append S candidate
    rows per slot (column 0 the slot's pending token, later columns its
    proposals) in ONE cached forward and return the greedy token of every
    position.

    Per layer, the S candidate rows' K/V are written into the pools first,
    in one launch (`paged_kv_update_layer{,_q}`, the rows as projected:
    int8 pools quantize them; the JAX step writes one row a call, since
    its TPU kernel rewrites whole row tiles), then all S rows attend at once
    (`paged_attention_fa` with S rows and no self-term: row j at position
    `lengths + j` attends causally through the pool, rows j' ≤ j included).

    Rows past a slot's allocated span land on the trash page (unallocated
    table entries are 0), and rows past `cache_len` are FORCED there:
    clamping their page index would overwrite the slot's last committed
    page. Inactive slots write their S pad rows to page 0 and attend them.
    Where two rows meet on a trash-page row, the last in (s, b) order is
    written, as S sequential calls leave it.
    The caller overwrites `lengths` with the accepted prefix. The pools are
    updated IN PLACE; `lengths` is not. Returns (greedy [B, S], logits
    [B, S, V] f32). (The JAX step's mesh and multi-LoRA arguments come with
    those features, Queue A steps 13 and 10.)"""
    dec = cfg.decoder
    decoder = model.decoder
    L = dec.num_layers
    P = kp.shape[0] // L
    ps = kp.shape[2] // 2 if vp is None else kp.shape[2]
    B, S = toks.shape
    dev = toks.device
    pps = page_table.shape[1]

    lengths_eff = torch.where(active, lengths, torch.zeros_like(lengths))
    pos = lengths_eff[:, None] + torch.arange(S, dtype=lengths.dtype, device=dev)[None, :]
    cos, sin = rope_cos_sin(pos, dec.head_dim, dec.rope_theta)
    h = embed(decoder, toks)

    cache_len = pps * ps
    row_idx = pos // ps
    in_range = row_idx < pps
    pages = torch.gather(page_table, 1, torch.clamp(row_idx, max=pps - 1).long())
    pages = torch.where(active[:, None] & in_range, pages, torch.zeros_like(pages))
    pages = pages.T.contiguous()                     # [S, B] within-layer ids
    offsets = (pos % ps).T.contiguous()              # [S, B]
    # Clamp so the page walk never runs past the table (padding rows of a
    # nearly full slot would otherwise push it over).
    lengths_attn = torch.clamp(lengths_eff + S, max=cache_len)
    sw = dec.sliding_window
    window = sw if (sw is not None and cache_len > sw) else None

    ksp, vsp = scales
    for i, layer in enumerate(decoder.model.layers):
        hn = rms_norm(h, layer.input_layernorm.weight, dec.rms_norm_eps)
        q, k, v = _project_qkv(hn, layer.self_attn, dec, cos, sin)
        if ksp is None:
            paged_kv_update_layer(kp, vp, k, v, pages, offsets, i * P)
        else:
            paged_kv_update_layer_q(kp, vp, ksp, vsp, k, v, pages, offsets, i * P)
        attn = paged_attention_fa(q, kp, vp, page_table, lengths_attn, lengths_eff,
                                  sliding_window=window, k_scales=ksp, v_scales=vsp,
                                  page_offset=i * P)
        h = h + layer.self_attn.o_proj(attn.reshape(B, S, -1))
        hn = rms_norm(h, layer.post_attention_layernorm.weight, dec.rms_norm_eps)
        h = h + layer.mlp(hn)

    h = rms_norm(h, decoder.model.norm.weight, dec.rms_norm_eps)
    logits = decoder.lm_head(h).float()
    return torch.argmax(logits, dim=-1), logits


class PagedBatcher(ContinuousBatcher):
    """Continuous batcher on paged KV pools.

    `cache_len` bounds a single sequence's span (pages_per_seq); `num_pages`
    sizes the shared pool of each layer: total memory scales with tokens in
    flight, not slots × cache_len.

    `kv_quant`: int8 pools with per-row absmax scales (halves the KV bytes a
    decode step reads). `kv_fused`: ONE pool array holding each page's K rows
    then its V rows; token-exact with the split layout. `prefill_chunk`:
    admit prompts in chunks of this many tokens, one chunk per scheduler
    step; None prefills a whole prompt at admission. `lookahead`:
    prompt-lookup speculation, greedy only (`_paged_verify_step` each
    scheduler step)."""

    def __init__(self, model: VisZephyr, cfg: VisZephyrConfig, max_slots: int = 32,
                 cache_len: int = 2048, sampling: SamplingConfig = SamplingConfig(),
                 seed: int = 0, page_size: int = 128, num_pages: Optional[int] = None,
                 mesh=None, metrics=None, prefill_chunk: Optional[int] = None,
                 kv_quant: bool = False, lookahead: int = 0, draft=None, multi_step: int = 1,
                 kv_fused: bool = False, prefix_cache: bool = False, mlora=None,
                 adapter_names=None, lazy_alloc: bool = False):
        if prefix_cache:
            raise not_ported("the prefix cache", "Queue A step 10")
        if lazy_alloc:
            raise not_ported("lazy allocation with host-swap preemption", "Queue A step 10")
        if cache_len % page_size:
            raise ValueError("cache_len must be a multiple of page_size")
        self._init_scheduler(model, cfg, max_slots, cache_len, sampling, seed, prefill_chunk,
                             mesh=mesh, metrics=metrics, lookahead=lookahead, draft=draft,
                             multi_step=multi_step, mlora=mlora, adapter_names=adapter_names)
        self.page_size = page_size
        self.pages_per_seq = cache_len // page_size
        if num_pages is None:
            # Default: half the dense-cache footprint, ≥ 2 full sequences.
            num_pages = 1 + max(2 * self.pages_per_seq, max_slots * self.pages_per_seq // 2)
        self.num_pages = num_pages
        self.allocator = PageAllocator(num_pages)

        dec = cfg.decoder
        dev = self.device
        self.kv_quant = kv_quant
        self.kv_fused = kv_fused
        pool_dtype = torch.int8 if kv_quant else model.dtype
        rows = 2 * page_size if kv_fused else page_size
        pool_shape = (dec.num_layers * num_pages, dec.num_kv_heads, rows, dec.head_dim)
        self.vp = self.ksp = self.vsp = None
        self.kp = torch.zeros(pool_shape, dtype=pool_dtype, device=dev)
        if not kv_fused:
            self.vp = torch.zeros(pool_shape, dtype=pool_dtype, device=dev)
        if kv_quant:
            self.ksp = torch.zeros(pool_shape[:3], dtype=torch.float32, device=dev)
            if not kv_fused:
                self.vsp = torch.zeros(pool_shape[:3], dtype=torch.float32, device=dev)
        self.page_table = torch.zeros((max_slots, self.pages_per_seq), dtype=torch.int32,
                                      device=dev)
        self.lengths = torch.zeros((max_slots,), dtype=torch.int32, device=dev)
        self.slot_pages: List[List[int]] = [[] for _ in range(max_slots)]
        self._requeued: deque = deque()  # head-of-queue retries (no pages free)
        # [max_slots, V] of the last decode step; [max_slots, S, V] of the
        # last verify step.
        self.last_logits: Optional[torch.Tensor] = None
        self.steps = 0          # decode steps run (verify steps: `verify_steps`)
        self.slots_stepped = 0  # active slots summed over decode and verify steps

    @property
    def has_work(self) -> bool:
        return (self.active.any() or not self.pending.empty()
                or bool(self._requeued) or self._prefilling is not None)

    @property
    def _headroom(self) -> int:
        """Rows a slot can append in ONE scheduler step (a decode step, or a
        `lookahead + 1`-row verify): the growth that lazy allocation (Queue A
        step 10) must have page-backed before a step. Eager allocation
        claims the whole span at admission, and proposals are capped by the
        budget, so every valid row lies inside it."""
        return self.lookahead + 1

    def _next_request(self) -> Optional[_Request]:
        if self._requeued:
            return self._requeued.popleft()
        try:
            return self.pending.get_nowait()
        except queue.Empty:
            return None

    def _admit_pending(self) -> None:
        """Whole-prompt admission: prefill each waiting request into a free slot."""
        for slot in range(self.max_slots):
            if not self._slot_free(slot):
                continue
            req = self._next_request()
            if req is None:
                return
            if req.cancelled:
                req.out.put(None)
                continue
            ids, images, pv = self._request_tensors(req)
            last_logits, k, v, length = _prefill_kv(self.model, ids, images, pv, self.cfg)
            if length + req.max_new_tokens > self.cache_len:
                req.out.put(None)  # exceeds a sequence's page span; reject
                continue
            if not self._install(req, slot, last_logits, k, v, length):
                # Pool exhausted: retry once active requests release pages.
                self._requeued.appendleft(req)
                return

    def _install(self, req: _Request, slot: int, last_logits, k, v, length: int) -> bool:
        """Allocate pages for the request's full span and write its K/V.
        Returns False (the caller retries) when the pool is exhausted."""
        ps = self.page_size
        T = k.shape[1]
        if T % ps:  # round the prefill up to a page
            pad = ps - T % ps
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
            T += pad
        span_pages = -(-(length + req.max_new_tokens) // ps)
        n_pages = max(T // ps, span_pages)
        pages = self.allocator.alloc(n_pages)
        if pages is None:
            return False
        row = np.zeros((self.pages_per_seq,), np.int32)
        row[:n_pages] = pages
        if self.kv_quant:
            _admit_paged_q(self.kp, self.vp, self.ksp, self.vsp, self.page_table, self.lengths,
                           k, v, length, row, slot=slot)
        else:
            _admit_paged(self.kp, self.vp, self.page_table, self.lengths, k, v, length, row,
                         slot=slot)
        self.slot_pages[slot] = pages
        self.slot_len[slot] = length
        self._activate(req, slot, last_logits)
        return True

    def _finish(self, slot: int) -> None:
        if self.slot_pages[slot]:
            self.allocator.release(self.slot_pages[slot])
            self.slot_pages[slot] = []
            _clear_row(self.page_table, slot)
        super()._finish(slot)

    def step(self) -> int:
        """Admit pending requests (one chunk's worth under chunked prefill),
        then advance every active slot by one token. Returns the number of
        active slots stepped."""
        self._reap_cancelled()
        if self.prefill_chunk:
            self._pump_prefill()
        else:
            self._admit_pending()
        if not self.active.any():
            return 0
        if self.lookahead > 0:
            stepped = self._step_verify()
            self.slots_stepped += stepped
            return stepped
        active = torch.as_tensor(self.active, device=self.device)
        _, self.last_logits = _paged_step(
            self.model, self.kp, self.vp, (self.ksp, self.vsp), self.page_table, self.lengths,
            self.token, active, self.generator, self.cfg, self.sampling)
        tokens = self.token.cpu().numpy()
        stepped = 0
        for slot in range(self.max_slots):
            if not self.active[slot]:
                continue
            stepped += 1
            tok = int(tokens[slot])
            if tok == self.sampling.eos_token_id:
                self._finish(slot)
                continue
            self._emit(self.slot_req[slot], tok)
            self.slot_len[slot] += 1
            self.budget[slot] -= 1
            if self.budget[slot] <= 0:
                self._finish(slot)
        self.steps += 1
        self.slots_stepped += stepped
        return stepped

    def _verify_device(self, toks: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """The paged verify: all S rows of every slot are written (rows past
        the accepted prefix are rolled back by `_verify_rollback`); `valid`
        only drives the host's acceptance loop."""
        greedy, self.last_logits = _paged_verify_step(
            self.model, self.kp, self.vp, (self.ksp, self.vsp), self.page_table, self.lengths,
            torch.as_tensor(toks, device=self.device),
            torch.as_tensor(self.active, device=self.device), self.cfg)
        return greedy.cpu().numpy()

    def _verify_rollback(self) -> None:
        self.lengths.copy_(torch.as_tensor(self.slot_len.astype(np.int32), device=self.device))
