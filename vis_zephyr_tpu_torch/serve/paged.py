"""Paged-KV continuous batching: the page-pool memory model behind
high-slot-count serving.

Port of `vis_zephyr_tpu/serve/paged.py`: `PageAllocator` (holder counts),
`PrefixCache`, `_admit_paged`, `_admit_paged_q`, `_clear_row`,
`_pool_rows_get` / `_pool_rows_set`, `_gather_prefix`, `_warm_scratch`,
`_paged_step` (modes "selfterm" and "writefirst"), `_paged_multi_step`
(multi-step bursts), `_paged_verify_step` (prompt-lookup speculation) and
`PagedBatcher` with eager full-span or lazy page allocation and the prefix
cache.

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
- allocation is host-side (a free list with a holder count a page): by
  default a request's full span (prompt pages + generation budget) is
  claimed at admission and released at finish. With `lazy_alloc` a slot
  holds pages for its current length plus one scheduler round's growth,
  topped up before every round; when the pool runs out the youngest slot's
  raw pool rows go to host memory and it resumes first-in, first-out.
- prefix cache (`prefix_cache`): prompts that share page-aligned tokens
  before their first image sentinel share the earlier prompt's pool pages
  (`PrefixCache`, pages held by count) and prefill only their suffix: the
  shared pages are gathered into the chunked prefill's scratch cache, whose
  later chunks run as a cold admission's do.
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
  `lengths` back to the accepted prefix. On the card the step is a replay
  of the step captured over the batcher's fixed buffers, as a decode step
  is.
- int8 KV (`kv_quant=True`): pools hold int8 rows with per-row absmax scales
  (row ≈ int8 · scale / 127.5). Admission quantizes on write, the decode
  write quantizes in the kernel, and the attention kernel folds the scales
  into scores and probabilities.
- KV-fused pools (`kv_fused=True`): one pool, each page holding its K rows
  then its V rows. Everywhere here `vp is None` / `vsp is None` means fused.
- sliding window: when `cache_len` exceeds `decoder.sliding_window` the
  kernel masks slots below `length − window` and skips their pages.
- multi-step bursts (`multi_step=n`): n decode steps with the EOS and budget
  carry on the device and one device-to-host copy at the end. Every decode
  step of the batcher runs in a burst (of one while admission work waits,
  or when n is 1); on the card each step is a replay of the step captured
  as a CUDA graph (`serve/graphs.py`) over the batcher's fixed buffers, and
  the eager `_paged_step` is the CPU's and `plain_versions()`'s form.

The JAX programs return new pools and rely on donation. Here pools,
`page_table`, `lengths` and `token` are updated in place, and only one thread
(the engine's pump) may call `step`.

Per-request temperature and top-p, logprobs and penalties ride every
decode step as the scheduler base's fixed per-slot buffers (`serve/batching.py`),
as do the slots' multi-LoRA adapters (`slot_adapter`: every step, verify
step and admission chunk adds each row's adapter delta, and the prefix
cache shares pages only within one adapter),
and the base's draft-model proposals (`draft`, `serve/draft.py`: its own
dense cache, whatever the pools) and `ServingMetrics` hooks serve this
batcher as they serve the dense one.

Fixed buffers: on the card every decode, verify and burst step is a replay
captured over `page_table`, `lengths`, `token` and the pools, so page growth,
swap-out and swap-in write those tensors in place (the JAX batcher rebinds
them); a new tensor would leave the captured graphs reading freed memory.

Not ported yet, each raising `NotImplementedError` when asked for: meshes and
the TP wrappers, and grammars.
"""

from __future__ import annotations

import bisect
import heapq
import itertools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import VisZephyrConfig
from ..constants import IMAGE_TOKEN_INDEX
from ..models.mistral import (_plain_proj, _project_qkv, adapted_proj, embed, mlp_forward,
                              rms_norm, rope_cos_sin, step_mlora_ctx)
from ..models.vis_zephyr import VisZephyr
from ..ops import _kernels
from ..ops.mlora import layer_targets
from ..ops.paged_attention import (KV_QUANT_MAX, paged_attention, paged_attention_fa,
                                   paged_kv_update_layer, paged_kv_update_layer_q,
                                   paged_kv_update_rows, paged_kv_update_rows_q, quantize_kv)
from .batching import ContinuousBatcher, _Request, _run_burst, not_ported
from .generate import SamplingConfig, _sample_tail, weight_form
from .graphs import StepGraphs, addresses, mlora_key


class PageAllocator:
    """Free-list over pool pages. Page 0 is reserved (trash).

    `alloc` prefers a CONTIGUOUS ascending run (first fit over the sorted
    free list) and falls back to the lowest free pages under fragmentation;
    the attention kernel takes any page order.

    Pages are counted by holder so that the prefix cache can share prompt
    pages: `alloc` hands a page out at count 1, `retain` adds a holder, and
    `release` returns a page to the free list only when its last holder
    lets go. A page that has no holder raises `KeyError` on `retain` and on
    `release` (a page released twice)."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free: List[int] = list(range(1, num_pages))  # sorted ascending
        self._refs: Dict[int, int] = {}  # page -> holder count (handed-out pages only)

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
        for p in pages:
            self._refs[p] = 1
        return pages

    def retain(self, pages: List[int]) -> None:
        """Add a holder to pages already handed out (prefix-cache sharing)."""
        for p in pages:
            self._refs[p] += 1

    def release(self, pages: List[int]) -> None:
        for p in pages:
            left = self._refs[p] - 1  # KeyError: a page with no holder
            if left:
                self._refs[p] = left
            else:
                del self._refs[p]
                bisect.insort(self._free, p)


class PrefixCache:
    """Exact-prefix page sharing across requests: a host-side trie keyed by
    page-sized chunks of raw prompt token ids. The node at depth i holds the
    pool page whose K/V covers prompt positions [i·ps, (i+1)·ps) of every
    prompt that starts with those ids. Admission retains the longest chain
    of cached pages and prefills only the suffix; an admitted prompt's
    shareable pages are inserted.

    The batcher keeps the rules that make sharing exact: only positions
    before the first image sentinel are shared, at least one prompt token
    stays unshared (its logits start decoding), and decode and verify write
    at positions at or past the prompt's length, so a shared page is never
    written.

    Eviction is leaf-first LRU, so a shorter prefix stays cached; a page that
    a slot still holds returns to the free list when that slot lets go."""

    def __init__(self, allocator: PageAllocator, page_size: int):
        self.allocator = allocator
        self.page_size = page_size
        # Trie node: {chunk bytes: [page id, child node, last used]}
        self.root: dict = {}
        self._clock = 0
        self.hits = 0
        self.pages_reused = 0

    def _chunks(self, ids: np.ndarray, n: int, salt: bytes = b""):
        """The first `n` chunk keys. `salt` tells apart contexts that give the
        same ids other K/V (a request's adapter); salting the root chunk is
        enough, since every deeper node descends from it."""
        ps = self.page_size
        out = [np.asarray(ids[i * ps:(i + 1) * ps], np.int32).tobytes() for i in range(n)]
        if out and salt:
            out[0] = salt + out[0]
        return out

    def lookup(self, ids: np.ndarray, max_pages: int, salt: bytes = b"") -> List[int]:
        """The longest cached chain of whole pages covering ids[:n·ps], n ≤
        `max_pages`. The caller becomes a holder of each returned page; their
        LRU stamps are refreshed."""
        self._clock += 1
        pages: List[int] = []
        node = self.root
        for chunk in self._chunks(ids, max_pages, salt):
            ent = node.get(chunk)
            if ent is None:
                break
            ent[2] = self._clock
            pages.append(ent[0])
            node = ent[1]
        if pages:
            self.allocator.retain(pages)
            self.hits += 1
            self.pages_reused += len(pages)
        return pages

    def insert(self, ids: np.ndarray, pages: List[int], n_pages: int,
               salt: bytes = b"") -> None:
        """Register pages[i] as the page of prompt chunk i (i < n_pages). The
        cache becomes a holder of each page it newly takes; a chunk already
        cached keeps its page (the caller's duplicate stays the caller's)."""
        self._clock += 1
        node = self.root
        for i, chunk in enumerate(self._chunks(ids, n_pages, salt)):
            ent = node.get(chunk)
            if ent is None:
                self.allocator.retain([pages[i]])
                ent = node[chunk] = [pages[i], {}, self._clock]
            else:
                ent[2] = self._clock
            node = ent[1]

    def evict(self, n: int) -> int:
        """Let go of up to n cached pages, leaf-first LRU; returns how many.

        Each pass walks the trie once and keeps the n oldest current leaves
        in a bounded heap (it runs on the scheduler thread when the pool is
        exhausted, where a full rescan per page would stall every slot).
        Dropping a node's last child makes its parent a leaf, so passes
        repeat until enough went; their number is bounded by the depth."""
        dropped = 0
        tiebreak = itertools.count()
        while dropped < n:
            need = n - dropped
            heap: list = []  # bounded; its root is the newest kept candidate
            stack = [self.root]
            while stack:
                d = stack.pop()
                for key, (page, children, stamp) in d.items():
                    if children:
                        stack.append(children)
                        continue
                    item = (-stamp, next(tiebreak), key, d, page)
                    if len(heap) < need:
                        heapq.heappush(heap, item)
                    elif item[0] > heap[0][0]:
                        heapq.heapreplace(heap, item)
            if not heap:
                break
            for _, _, key, parent, page in heap:
                del parent[key]
                self.allocator.release([page])
                dropped += 1
        return dropped

    def drop_all(self) -> None:
        """Let go of every cached page (shutdown, tests)."""
        stack = [self.root]
        while stack:
            d = stack.pop()
            for page, children, _ in d.values():
                self.allocator.release([page])
                stack.append(children)
        self.root = {}


def _page_blocks(x: torch.Tensor, ps: int) -> torch.Tensor:
    """[L, T, Hkv, ...] → page blocks [L, T/ps, Hkv, ps, ...]."""
    L, T, Hkv = x.shape[:3]
    return x.reshape((L, T // ps, ps, Hkv) + tuple(x.shape[3:])).transpose(2, 3)


def _by_layer(pool: torch.Tensor, L: int) -> torch.Tensor:
    """Pool [L·P, ...] viewed [L, P, ...] (no copy: writes reach the pool)."""
    return pool.view((L, pool.shape[0] // L) + tuple(pool.shape[1:]))


@torch.no_grad()
def _admit_paged(kp, vp, page_table, lengths, k, v, length: int, row, *, slot: int,
                 start: int = 0):
    """Write a prefilled sequence's K/V into its allocated pages and install
    its page-table row. k/v: [L, T, Hkv, D] with T a page-size multiple; the
    same within-layer page id is written in every layer's segment. KV-fused
    pools (`vp=None`): pages are [2·ps, D], K rows then V rows.

    `start`: the first logical page of `row` to write. A warm admission (a
    prefix-cache hit) passes the suffix's K/V only: pages row[:start] are
    shared prompt pages, already written, and are not touched. In place;
    returns what it was given."""
    fused = vp is None
    L, T = k.shape[:2]
    ps = kp.shape[2] // 2 if fused else kp.shape[2]
    n = T // ps
    pages = torch.as_tensor(np.asarray(row[start:start + n], np.int64), device=kp.device)
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
                   slot: int, start: int = 0):
    """`_admit_paged` for int8 pools: quantize the prefilled K/V per row
    (`quantize_kv`), write int8 blocks and scale blocks. Fused pools
    (`vp=None`, `vsp=None`): K rows then V rows, K scales then V scales.
    `start`: as in `_admit_paged`."""
    fused = vp is None
    L, T = k.shape[:2]
    ps = kp.shape[2] // 2 if fused else kp.shape[2]
    n = T // ps
    pages = torch.as_tensor(np.asarray(row[start:start + n], np.int64), device=kp.device)
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
def _pool_rows_get(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Pool entries `idx` along the (layer·page) axis 0: the raw swap-out
    read (bf16 or int8 pool bytes, or f32 scale rows, as stored)."""
    return pool.index_select(0, idx)


@torch.no_grad()
def _pool_rows_set(pool: torch.Tensor, idx: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Write rows that `_pool_rows_get` read back into (possibly other) pool
    entries `idx`, in place: the raw swap-in write. Nothing is dequantized
    or quantized on the way, so the round trip is bit-exact."""
    return pool.index_copy_(0, idx, data.to(pool.device))


@torch.no_grad()
def _gather_prefix(kp, vp, ksp, vsp, pages: torch.Tensor, *, num_layers: int):
    """Shared prompt pages gathered into a dense prefix K/V [L, n0·ps, Hkv, D]
    for a warm admission, whose suffix chunks attend it as their cache.
    Every pool layout by the module's None conventions: `vp` None is fused
    rows; `ksp` given is int8 with per-row scales, dequantized here as the
    JAX function runs (f32 values times scale · (1 / KV_QUANT_MAX): XLA
    compiles its division by the constant into that product, and so the two
    agree bit for bit): the one place where int8 rounding reaches a
    prefill's numbers. Returns the pools' dtype, f32 for int8 pools."""
    L = num_layers
    rows = kp.shape[2]
    ps = rows // 2 if vp is None else rows
    n0 = pages.shape[0]
    kb = _by_layer(kp, L)[:, pages]                    # [L, n0, Hkv, rows, D]
    if vp is None:
        kb, vb = kb[:, :, :, :ps], kb[:, :, :, ps:]
    else:
        vb = _by_layer(vp, L)[:, pages]
    if ksp is not None:
        ks = _by_layer(ksp, L)[:, pages]               # [L, n0, Hkv, rows]
        if vsp is None:
            ks, vs = ks[..., :ps], ks[..., ps:]
        else:
            vs = _by_layer(vsp, L)[:, pages]
        kb = kb.float() * (ks * (1.0 / KV_QUANT_MAX))[..., None]
        vb = vb.float() * (vs * (1.0 / KV_QUANT_MAX))[..., None]

    def dense(b):  # [L, n0, Hkv, ps, D] → [L, n0·ps, Hkv, D]
        return b.transpose(2, 3).reshape(L, n0 * ps, b.shape[2], b.shape[4])

    return dense(kb), dense(vb)


@torch.no_grad()
def _warm_scratch(cache, pk: torch.Tensor, pv: torch.Tensor):
    """Write a gathered prefix K/V [L, t0, Hkv, D] into rows [0, t0) of a
    fresh B = 1 prefill scratch cache and set its length to t0, in place:
    chunk extension then starts at the first chunk not cached."""
    t0 = pk.shape[1]
    cache["k"][:, 0, :t0] = pk.to(cache["k"].dtype)
    cache["v"][:, 0, :t0] = pv.to(cache["v"].dtype)
    cache["length"].fill_(t0)
    return cache


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

    The sampling operands as in `batching._batch_step`: `sample_overrides`
    (temps [B], top_ps [B]) and `penalties` (freq [B], pres [B], counts
    [B, V] f32, counted in place); the logprobs of the JAX step's
    `want_logprobs` are `_logprobs` of the returned raw logits, which
    `_paged_multi_step` takes. `mlora` / `adapter_idx` [B]: each slot's
    multi-LoRA adapter (every adapted projection adds its delta).

    The pools, `lengths` and `token` are updated IN PLACE. Returns
    (next_token [B], logits [B, V] f32)."""
    for value, what, step in (
            (mesh, "a device mesh (tensor-parallel paged step)", "Queue A step 13"),
            (grammar, "structured output (grammar)", "Queue A step 10")):
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
    mctx = step_mlora_ctx(mlora, adapter_idx, B, h.dtype, h.device)

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
        proj = adapted_proj(_plain_proj, layer_targets(mlora, i, mctx))
        hn = rms_norm(h, layer.input_layernorm.weight, dec.rms_norm_eps)
        q, k, v = _project_qkv(hn, layer.self_attn, dec, cos, sin, proj)
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
        h = h + proj(layer.self_attn.o_proj, attn.reshape(B, 1, -1), 3)
        hn = rms_norm(h, layer.post_attention_layernorm.weight, dec.rms_norm_eps)
        h = h + mlp_forward(layer.mlp, hn, proj)
    if mode == "selfterm":
        ks_rows, vs_rows = torch.stack(ks_rows), torch.stack(vs_rows)   # [L, B, Hkv, D]
        if ksp is None:
            paged_kv_update_rows(kp, vp, ks_rows, vs_rows, cur_page, offset)
        else:
            paged_kv_update_rows_q(kp, vp, ksp, vsp, ks_rows, vs_rows, cur_page, offset)

    h = rms_norm(h, decoder.model.norm.weight, dec.rms_norm_eps)
    logits = decoder.lm_head(h[:, -1:]).float()[:, 0]
    next_token = _sample_tail(logits, generator, sampling, active, dec.pad_token_id,
                              sample_overrides, penalties)
    token.copy_(next_token)
    lengths.add_(active.to(lengths.dtype))
    return next_token, logits


@torch.no_grad()
def _paged_multi_step(model: VisZephyr, kp, vp, scales: Tuple, page_table, lengths, token,
                      active, steps_left, generator: Optional[torch.Generator],
                      cfg: VisZephyrConfig, sampling: SamplingConfig, mode: str = "selfterm",
                      n: int = 4, graphs: Optional[StepGraphs] = None, sample_overrides=None,
                      penalties=None, lp_out=None, mlora=None, adapter_idx=None):
    """`n` chained `_paged_step`s in one burst (`batching._run_burst`: the
    EOS and budget carry on the device, token-exact with single-stepping;
    with temperature > 0 the draws come from `generator` in the single-step
    order; `lp_out` takes each step's logprobs).

    On a CUDA tensor (outside `_kernels.plain_versions()`) every step is a
    replay of the step captured over these buffers, the sampling operands
    and the carry's (`graphs`, a `StepGraphs`; a throwaway one when None):
    the pools, `page_table`, `lengths`, `token` and the operands (the
    multi-LoRA pack and the per-slot `adapter_idx` buffer among them) must
    keep their tensors for the graphs' life. Elsewhere the same step runs
    eagerly.

    The pools, `lengths` and `token` are updated IN PLACE. Returns (toks
    [n, B], entry_alive [n, B] bool, logits [B, V] f32 of the last step),
    all on the device: token (j, b) counts iff entry_alive[j, b]. (The JAX
    function's mesh argument comes with meshes, Queue A step 13.)"""
    def step(alive):
        return _paged_step(model, kp, vp, scales, page_table, lengths, token, alive, generator,
                           cfg, sampling, mode=mode, mlora=mlora, adapter_idx=adapter_idx,
                           sample_overrides=sample_overrides, penalties=penalties)

    key = ("paged", mode, token.shape[0], weight_form(model), sampling.temperature,
           sampling.top_p, sampling.eos_token_id, generator, lp_out is not None,
           *mlora_key(mlora, adapter_idx),
           *addresses(kp, vp, *scales, page_table, lengths, token,
                  *(sample_overrides or (None, None)), *(penalties or (None, None, None))))
    return _run_burst(step, key, token, active, steps_left, sampling.eos_token_id, n, graphs,
                      generator, lp_out)


@torch.no_grad()
def _paged_verify_step(model: VisZephyr, kp, vp, scales: Tuple, page_table, lengths, toks,
                       active, cfg: VisZephyrConfig, graphs: Optional[StepGraphs] = None,
                       mlora=None, adapter_idx=None):
    """`_paged_verify_body` as the batcher runs it. On a CUDA tensor (outside
    `_kernels.plain_versions()`) the step is a replay of the step captured
    over these buffers (`graphs`, a `StepGraphs`; a throwaway one when
    None): the pools, `page_table`, `lengths`, `toks` and `active` must keep
    their tensors for the graphs' life, and the returned tensors are the
    graph's outputs, overwritten by its next replay. Elsewhere the step runs
    eagerly. `mlora` / `adapter_idx` [B]: each slot's multi-LoRA adapter
    (the index a fixed buffer too). Returns (greedy [B, S], logits
    [B, S, V] f32) on the device."""
    if not _kernels.use_kernel(toks):
        return _paged_verify_body(model, kp, vp, scales, page_table, lengths, toks, active, cfg,
                                  mlora, adapter_idx)
    if graphs is None:
        graphs = StepGraphs()
    B, S = toks.shape
    # The step reads no sampler: greedy tokens only.
    key = ("verify", B, S, *mlora_key(mlora, adapter_idx),
           *addresses(kp, vp, *scales, page_table, lengths, toks, active))
    return graphs.run(key, lambda: _paged_verify_body(model, kp, vp, scales, page_table, lengths,
                                                      toks, active, cfg, mlora, adapter_idx),
                      toks.device)


@torch.no_grad()
def _paged_verify_body(model: VisZephyr, kp, vp, scales: Tuple, page_table, lengths, toks,
                       active, cfg: VisZephyrConfig, mlora=None, adapter_idx=None):
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
    updated IN PLACE; `lengths` is not. `mlora` / `adapter_idx` [B]: each
    slot's multi-LoRA adapter. Returns (greedy [B, S], logits [B, S, V]
    f32). (The JAX step's mesh argument comes with meshes, Queue A step
    13.)"""
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
    mctx = step_mlora_ctx(mlora, adapter_idx, B, h.dtype, h.device)

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
        proj = adapted_proj(_plain_proj, layer_targets(mlora, i, mctx))
        hn = rms_norm(h, layer.input_layernorm.weight, dec.rms_norm_eps)
        q, k, v = _project_qkv(hn, layer.self_attn, dec, cos, sin, proj)
        if ksp is None:
            paged_kv_update_layer(kp, vp, k, v, pages, offsets, i * P)
        else:
            paged_kv_update_layer_q(kp, vp, ksp, vsp, k, v, pages, offsets, i * P)
        attn = paged_attention_fa(q, kp, vp, page_table, lengths_attn, lengths_eff,
                                  sliding_window=window, k_scales=ksp, v_scales=vsp,
                                  page_offset=i * P)
        h = h + proj(layer.self_attn.o_proj, attn.reshape(B, S, -1), 3)
        hn = rms_norm(h, layer.post_attention_layernorm.weight, dec.rms_norm_eps)
        h = h + mlp_forward(layer.mlp, hn, proj)

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
    speculation, greedy only (`_paged_verify_step` each scheduler step),
    proposals from `draft` where given, else prompt lookup. `metrics`: a
    `ServingMetrics`, as on the dense batcher (it counts swaps too).
    `multi_step`: a scheduler step with no admission work waiting, and no
    slot asking for logprobs or penalties, runs a burst of this many decode
    steps, else a burst of one (`_paged_multi_step`, replayed as CUDA graphs
    on the card); ignored under `lookahead`.

    `prefix_cache`: prompts that share a page-aligned prefix (system prompts,
    multi-turn continuations) reuse the earlier prompt's pool pages and
    prefill only the suffix (`PrefixCache`). It needs `prefill_chunk`: a warm
    admission is `_chunk_extend` starting at a later chunk over the same
    scratch cache, so on bf16 pools it gives a cold admission's tokens; with
    `kv_quant` the suffix attends the int8-rounded prefix. Only positions
    before the first image sentinel are shared.

    `lazy_alloc`: a slot holds pages for its current length plus one
    scheduler round's growth (`_headroom`), topped up before every round.
    When the pool runs out the youngest slot is preempted: its raw pool rows
    (pool bytes and f32 scale rows, so the round trip is bit-exact in every
    layout) go to host memory, its pages are released, and it resumes
    first-in, first-out, oldest first and never at a running slot's
    expense, once pages free up. Its tokens equal eager allocation's."""

    def __init__(self, model: VisZephyr, cfg: VisZephyrConfig, max_slots: int = 32,
                 cache_len: int = 2048, sampling: SamplingConfig = SamplingConfig(),
                 seed: int = 0, page_size: int = 128, num_pages: Optional[int] = None,
                 mesh=None, metrics=None, prefill_chunk: Optional[int] = None,
                 kv_quant: bool = False, lookahead: int = 0, draft=None, multi_step: int = 1,
                 kv_fused: bool = False, prefix_cache: bool = False, mlora=None,
                 adapter_names=None, lazy_alloc: bool = False):
        if cache_len % page_size:
            raise ValueError("cache_len must be a multiple of page_size")
        if prefix_cache and not prefill_chunk:
            raise ValueError("prefix_cache requires chunked prefill admission (prefill_chunk): "
                             "the warm path starts chunk extension at the first chunk not cached")
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
        self.prefix_cache = PrefixCache(self.allocator, page_size) if prefix_cache else None
        self.lazy_alloc = lazy_alloc
        # slot -> host snapshot of a preempted slot; insertion order is the
        # order of resumption.
        self._swapped: Dict[int, dict] = {}
        self.slot_seq = np.zeros(max_slots, np.int64)  # admission order
        self._seq = 0

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

    @property
    def has_work(self) -> bool:
        return super().has_work or bool(self._swapped)

    def _slot_free(self, slot: int) -> bool:
        # A parked slot is inactive, yet it still owns its request, history,
        # penalty counts and draft rows: admission must not take it.
        return super()._slot_free(slot) and slot not in self._swapped

    @property
    def _headroom(self) -> int:
        """Rows a slot can append in ONE scheduler round (a decode step, a
        `multi_step` burst, or a `lookahead + 1`-row verify): the growth
        that lazy allocation has page-backed before every round. Eager
        allocation claims the whole span at admission, and bursts and
        proposals are capped by the budget, so every valid row lies inside
        it."""
        return max(self.multi_step, self.lookahead + 1)

    # -- admission ----------------------------------------------------------------

    def _shareable_pages(self, input_ids, n_tokens: int) -> int:
        """Whole pages of this prompt that may be shared: raw token ids before
        the first image sentinel (image positions splice the request's own
        embeddings) and below `n_tokens`."""
        ids = np.asarray(input_ids)
        img = np.nonzero(ids == IMAGE_TOKEN_INDEX)[0]
        limit = int(img[0]) if len(img) else n_tokens
        return min(limit, n_tokens) // self.page_size

    def _pc_salt(self, req: _Request) -> bytes:
        """The prefix cache's key salt: an adapter changes the prompt's K/V,
        so pages are shared only within one adapter (empty for the base)."""
        return (b"a%d|" % req.adapter) if req.adapter else b""

    def _install(self, req: _Request, slot: int, last_logits, k, v, length: int) -> bool:
        """Allocate the request's pages and write its K/V: its full span, or
        under `lazy_alloc` its length plus one round's growth. Returns False
        (the caller retries) when the pool is exhausted, after idle cached
        prefixes were evicted.

        A warm admission (a prefix-cache hit, chunked admission only) carries
        `shared` in the prefill state: pool pages already written that cover
        the prompt's first pages. Only the suffix's K/V is written; the table
        row chains shared and owned pages, and the slot holds both."""
        st = self._prefilling
        shared = (st.get("shared") or []) if (st is not None and st["slot"] == slot) else []
        n0 = len(shared)
        ps = self.page_size
        if n0:
            k, v = k[:, n0 * ps:], v[:, n0 * ps:]
        T = k.shape[1]
        if T % ps:  # round the prefill up to a page
            pad = ps - T % ps
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
            T += pad
        span_pages = -(-(length + req.max_new_tokens) // ps)
        if self.lazy_alloc:
            span_pages = min(span_pages, -(-(length + self._headroom) // ps))
        n_pages = max(n0 + T // ps, span_pages)
        n_owned = n_pages - n0
        pages = self.allocator.alloc(n_owned)
        if pages is None and self.prefix_cache is not None:
            if self.prefix_cache.evict(n_owned - self.allocator.available):
                pages = self.allocator.alloc(n_owned)
        if pages is None:
            return False
        row = np.zeros((self.pages_per_seq,), np.int32)
        row[:n0] = shared
        row[n0:n_pages] = pages
        if self.kv_quant:
            _admit_paged_q(self.kp, self.vp, self.ksp, self.vsp, self.page_table, self.lengths,
                           k, v, length, row, slot=slot, start=n0)
        else:
            _admit_paged(self.kp, self.vp, self.page_table, self.lengths, k, v, length, row,
                         slot=slot, start=n0)
        self.slot_pages[slot] = shared + pages
        self.slot_len[slot] = length
        self.slot_seq[slot] = self._seq
        self._seq += 1
        if self.prefix_cache is not None:
            n_ins = self._shareable_pages(req.input_ids, length)
            if n_ins > 0:
                self.prefix_cache.insert(np.asarray(req.input_ids), [int(p) for p in row[:n_ins]],
                                         n_ins, salt=self._pc_salt(req))
        self._activate(req, slot, last_logits)
        return True

    def _begin_prefill(self, req: _Request, slot: int):
        """Chunked admission's start. With a prefix cache: the longest chain
        of cached pages, cut to whole multiples of lcm(page, chunk), is
        gathered into the scratch cache as its first rows, and the chunks it
        covers are skipped; the chunks after it run as a cold admission's."""
        st = super()._begin_prefill(req, slot)
        if st is None or self.prefix_cache is None:
            return st
        ps, C = self.page_size, self.prefill_chunk
        per = (ps * C // math.gcd(ps, C)) // ps  # pages in a chunk- and page-aligned span
        # Whole pages before the first image sentinel, leaving at least one
        # prompt token unshared (its logits start decoding).
        max_pages = (min(self._shareable_pages(req.input_ids, st["length"]),
                         (st["length"] - 1) // ps) // per) * per
        st["shared"] = []
        if max_pages <= 0:
            return st
        shared = self.prefix_cache.lookup(np.asarray(req.input_ids), max_pages,
                                          salt=self._pc_salt(req))
        keep = (len(shared) // per) * per
        if keep < len(shared):  # the chain must stay chunk-aligned to skip chunks
            self.allocator.release(shared[keep:])
            # Only pages truly reused count.
            self.prefix_cache.pages_reused -= len(shared) - keep
            if keep == 0:
                self.prefix_cache.hits -= 1
            shared = shared[:keep]
        if not shared:
            return st
        pk, pv = _gather_prefix(self.kp, self.vp, self.ksp, self.vsp,
                                torch.as_tensor(shared, dtype=torch.int64, device=self.device),
                                num_layers=self.cfg.decoder.num_layers)
        _warm_scratch(st["cache"], pk, pv)
        st["chunk"] = len(shared) * ps // C
        st["shared"] = shared
        return st

    def _finish(self, slot: int) -> None:
        """Let go of the slot's pages (a page that the cache or another slot
        still holds stays), and of its snapshot when it was cancelled while
        parked."""
        if self.slot_pages[slot]:
            self.allocator.release(self.slot_pages[slot])
            self.slot_pages[slot] = []
            _clear_row(self.page_table, slot)
        self._swapped.pop(slot, None)
        super()._finish(slot)

    # -- lazy allocation and host swap ----------------------------------------------

    def _before_admission(self) -> None:
        """Parked slots resume before new admissions take pages."""
        self._try_swap_in()

    def _before_round(self) -> None:
        """Every active slot has its growth page-backed before the round."""
        self._ensure_growth_capacity()

    def _swap_idx(self, pages: List[int]) -> torch.Tensor:
        """Pool axis-0 entries of `pages` in every layer: l·num_pages + page.
        (The JAX function pads the page count to a power of two to bound its
        retraces; nothing is traced here, so nothing is padded.)"""
        L = self.cfg.decoder.num_layers
        idx = (np.arange(L, dtype=np.int64)[:, None] * self.num_pages
               + np.asarray(pages, np.int64)[None, :]).ravel()
        return torch.as_tensor(idx, device=self.device)

    def _swap_out(self, slot: int) -> None:
        """Preempt `slot`: copy its raw pool rows (and scale rows) to host
        memory, release its pages, clear its table row and deactivate it.
        The host state of the slot (history, penalties, budget, draft rows)
        stays as it is. The pending token is saved: a step writes the pad
        token into inactive slots' `token` entries."""
        pages = self.slot_pages[slot]
        idx = self._swap_idx(pages)
        snap = {"n": len(pages), "token": int(self.token[slot])}
        for name in ("kp", "vp", "ksp", "vsp"):
            pool = getattr(self, name)
            if pool is not None:
                snap[name] = _pool_rows_get(pool, idx).cpu()
        self.allocator.release(pages)
        self.slot_pages[slot] = []
        _clear_row(self.page_table, slot)
        self.active[slot] = False
        self._swapped[slot] = snap
        if self.metrics is not None:
            self.metrics.preempt_swap_out += 1

    def _swap_in(self, slot: int, pages: List[int]) -> None:
        """Restore a parked slot into `pages` (at least its snapshot's; the
        rest is growth) and reactivate it. The table row, the pending token
        and the pools are written in place: the captured steps read them."""
        snap = self._swapped.pop(slot)
        idx = self._swap_idx(pages[:snap["n"]])
        for name in ("kp", "vp", "ksp", "vsp"):
            pool = getattr(self, name)
            if pool is not None:
                _pool_rows_set(pool, idx, snap[name])
        row = np.zeros((self.pages_per_seq,), np.int32)
        row[:len(pages)] = pages
        self.page_table[slot] = torch.as_tensor(row, device=self.device)
        self.token[slot] = snap["token"]
        self.slot_pages[slot] = list(pages)
        self.active[slot] = True
        if self.metrics is not None:
            self.metrics.preempt_swap_in += 1

    def _try_swap_in(self) -> None:
        """Resume parked slots first-in, first-out as pages free up. It never
        preempts a running slot, and a blocked head blocks the queue so that
        younger slots cannot starve it. A slot cancelled while parked is
        finished here."""
        while self._swapped:
            slot = next(iter(self._swapped))
            req = self.slot_req[slot]
            if req is None or req.cancelled:
                self._finish(slot)  # drops the snapshot
                continue
            need = min(max(self._swapped[slot]["n"],
                           -(-(int(self.slot_len[slot]) + self._headroom) // self.page_size)),
                       self.pages_per_seq)
            pages = self.allocator.alloc(need)
            if pages is None and self.prefix_cache is not None:
                if self.prefix_cache.evict(need - self.allocator.available):
                    pages = self.allocator.alloc(need)
            if pages is None:
                return
            self._swap_in(slot, pages)

    def _ensure_growth_capacity(self) -> None:
        """Top up every active slot's pages to one round's growth; under pool
        pressure preempt the youngest slot until the pages fit. No-op
        without `lazy_alloc`."""
        if not self.lazy_alloc:
            return
        for slot in range(self.max_slots):
            if not self.active[slot]:
                continue
            # Clamped to the row's width: near cache_len the headroom can ask
            # for a page the row cannot hold; the budget stops a slot before
            # cache_len, so rows past it are never read.
            need = min(-(-(int(self.slot_len[slot]) + self._headroom) // self.page_size),
                       self.pages_per_seq)
            have = len(self.slot_pages[slot])
            if have >= need:
                continue
            pages = self._alloc_or_preempt(need - have, protect=slot)
            if pages is None:
                # Nothing left to preempt: park this slot too; finishing
                # requests will free the pages it needs.
                self._swap_out(slot)
                continue
            self.page_table[slot, have:need] = torch.as_tensor(pages, dtype=torch.int32,
                                                               device=self.device)
            self.slot_pages[slot].extend(pages)

    def _alloc_or_preempt(self, n: int, protect: int) -> Optional[List[int]]:
        """`n` pages, evicting idle cached prefixes and then swapping out the
        youngest other active slots until they fit; None when no slot is
        left to swap out."""
        while True:
            pages = self.allocator.alloc(n)
            if pages is not None:
                return pages
            if self.prefix_cache is not None and self.prefix_cache.evict(
                    n - self.allocator.available):
                continue
            victims = [s for s in range(self.max_slots) if self.active[s] and s != protect]
            if not victims:
                return None
            self._swap_out(max(victims, key=lambda s: self.slot_seq[s]))

    def _burst_device(self, n: int, overrides, penalties, lp_out):
        """The device side of a burst: `_paged_multi_step` over the pools."""
        return _paged_multi_step(
            self.model, self.kp, self.vp, (self.ksp, self.vsp), self.page_table, self.lengths,
            self.token, self._active_dev, self._left_dev, self.generator, self.cfg,
            self.sampling, n=n, graphs=self.graphs, sample_overrides=overrides,
            penalties=penalties, lp_out=lp_out, mlora=self.mlora, adapter_idx=self._slot_aidx())

    def _verify_device(self, toks: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """The paged verify: all S rows of every slot are written (rows past
        the accepted prefix are rolled back by `_verify_rollback`); `valid`
        only drives the host's acceptance loop. The candidates and `active`
        go into fixed buffers (`verify_buffers`), which the step captured on
        the card reads; the greedy tokens come back in one copy."""
        toks_dev, active_dev = self.verify_buffers(toks.shape[1])
        toks_dev.copy_(torch.from_numpy(toks))
        active_dev.copy_(torch.from_numpy(self.active))
        greedy, self.last_logits = _paged_verify_step(
            self.model, self.kp, self.vp, (self.ksp, self.vsp), self.page_table, self.lengths,
            toks_dev, active_dev, self.cfg, graphs=self.graphs, mlora=self.mlora,
            adapter_idx=self._slot_aidx())
        return greedy.cpu().numpy()

    def verify_buffers(self, S: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The verify step's fixed inputs for S rows a slot: candidates
        [max_slots, S] int64 and `active` [max_slots] bool on the device."""
        B, dev = self.max_slots, self.device
        return self.graphs.buffers(("verify", B, S), lambda: (
            torch.zeros((B, S), dtype=torch.int64, device=dev),
            torch.zeros((B,), dtype=torch.bool, device=dev)))

    def _verify_rollback(self) -> None:
        self.lengths.copy_(torch.as_tensor(self.slot_len.astype(np.int32), device=self.device))
