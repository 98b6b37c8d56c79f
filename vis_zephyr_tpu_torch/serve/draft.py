"""Draft-model speculative proposer for the continuous batchers.

Port of `vis_zephyr_tpu/serve/draft.py`. Prompt-lookup speculation (the
default) only pays on outputs that copy their context; a small draft LM
proposes on any text. A second, much smaller decoder plugs into the
batchers' verify machinery: each scheduler step the draft greedily decodes
up to `span` candidate tokens a slot, the TARGET model verifies every
slot's candidates in its one multi-token append (`_step_verify`), and the
host accepts the matching prefix, so the tokens equal plain greedy
decoding's whatever the draft proposes (a bad draft only wastes proposals).

- The draft conditions on VOCABULARY tokens only (the batchers' per-slot
  `slot_hist`, which drops image sentinels): a multimodal prompt degrades
  the draft's proposals, never the output.
- The draft keeps its own DENSE cache [L_d, slots, cache_len, Hkv_d, D_d]
  on the batcher's slot indices, whatever the target's cache. Between
  scheduler rounds it holds the slot's history EXCEPT the pending token,
  the first input of the next round.
- After the target's verdict the draft's lengths roll back to the committed
  prefix (`commit`, then one `rollback` a round); rejected rows are dead
  and the next round overwrites them.

A round's span + 1 greedy steps are one burst (`batching._batch_multi_step`
over the draft's cache, EOS off, each slot frozen once its own budget runs
out): on the card every step is a replay of the step captured over the
draft's fixed buffers (`serve/graphs.py`), one copy of the proposals back
at the end; on the CPU, and inside `_kernels.plain_versions()`, the same
step runs eagerly. The JAX object rebinds `cache["length"]` each round; here
the host's mirror is copied into the same tensors (lengths, pending tokens,
the burst's active set and budgets), which the captured step reads.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..config import VisZephyrConfig
from ..models.mistral import init_cache
from ..models.vis_zephyr import VisZephyr
from .batching import _admit, _batch_multi_step, _prefill_kv
from .generate import SamplingConfig
from .graphs import StepGraphs


class DraftModel:
    """Batched draft proposer over the batcher's slot space.

    `model` / `cfg`: a (small) VisZephyr model; only its decoder runs.
    `cache_len` bounds the draftable history; slots whose history outgrows
    it are declined (the batcher falls back to prompt lookup for them).
    Exactly one thread (the batcher's) may call it: the cache is updated in
    place.
    """

    # Greedy, EOS off: a slot drafts its whole allowed span.
    SAMPLING = SamplingConfig(temperature=0.0, eos_token_id=-1)

    def __init__(self, model: VisZephyr, cfg: VisZephyrConfig, max_slots: int,
                 cache_len: int = 2048):
        self.model = model
        self.cfg = cfg
        self.max_slots = B = max_slots
        self.cache_len = cache_len
        dev = self.device = model.device
        self.cache = init_cache(cfg.decoder, max_slots, cache_len, dtype=model.dtype, device=dev)
        # Host mirror of the committed draft length per slot (== len(hist) - 1
        # between rounds; 0 = slot not draftable).
        self.len = np.zeros(max_slots, np.int64)
        self._drafted = np.zeros(max_slots, bool)  # fed this round
        # The burst's fixed inputs: pending tokens, drafting slots, their budgets.
        self.token = torch.zeros((B,), dtype=torch.int64, device=dev)
        self._active_dev = torch.zeros((B,), dtype=torch.bool, device=dev)
        self._left_dev = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.graphs = StepGraphs()
        self.admissions = 0  # prefills run (a decoder pass each)
        self.steps = 0       # draft decode steps run (span + 1 a round)

    # -- slot lifecycle -------------------------------------------------------

    def admit(self, slot: int, hist: List[int]) -> bool:
        """Prefill the draft on a slot's text history MINUS the pending
        token (`hist[:-1]`; `hist[-1]` is the batcher's pending token).
        Returns False when the slot can't be drafted (history too long).
        Rows of a prefill padded past `cache_len` lie past its length and
        are dropped (`_admit`)."""
        ids = np.asarray(hist[:-1], np.int64)
        if len(ids) == 0 or len(ids) + 1 >= self.cache_len:
            self.len[slot] = 0
            return False
        _, k, v, length = _prefill_kv(self.model, torch.as_tensor(ids, device=self.device)[None],
                                      None, None, self.cfg)
        _admit(self.cache, k, v, length, slot)
        self.len[slot] = length
        self.admissions += 1
        return True

    def release(self, slot: int) -> None:
        self.len[slot] = 0

    # -- per-round propose / commit ------------------------------------------

    def propose(self, active: np.ndarray, pending: np.ndarray,
                caps: np.ndarray, span: int) -> List[Optional[np.ndarray]]:
        """Greedy-decode up to `span` candidates for every draftable slot
        in one burst of span + 1 batched draft steps (the extra step feeds
        the last candidate, so a fully accepted round needs no special
        case). `pending`: the batcher's pending token per slot; `caps`:
        per-slot proposal budget (0 = don't propose). A slot whose draft
        cache can't hold the FULL span drafts a shorter one (rows needed
        next round = len + allowed + 2 <= cache_len) instead of being
        declined. Returns per-slot proposal arrays (None where not
        drafting); only each slot's first `allowed` rows are read, so a
        frozen slot's later rows (pad tokens here, its last token in JAX)
        are never proposals."""
        allowed = np.minimum(np.minimum(caps, span), self.cache_len - self.len - 2)
        allowed = np.where(active & (self.len > 0), np.maximum(allowed, 0), 0)
        drafting = allowed > 0
        self._drafted = drafting
        if not drafting.any():
            return [None] * self.max_slots
        # Align the device lengths with the committed mirror (rolls back the
        # rows the last round rejected), then one burst and one copy back.
        self.cache["length"].copy_(torch.from_numpy(self.len.astype(np.int32)))
        self.token.copy_(torch.from_numpy(np.where(drafting, pending, 0).astype(np.int64)))
        self._active_dev.copy_(torch.from_numpy(drafting))
        self._left_dev.copy_(torch.from_numpy((allowed + drafting).astype(np.int32)))
        out = self._burst(span + 1)[:span].cpu().numpy().T  # [slots, span]
        self.steps += span + 1
        return [out[s, : allowed[s]] if drafting[s] else None
                for s in range(self.max_slots)]

    def _burst(self, n: int) -> torch.Tensor:
        """The device side of a round: `n` chained greedy steps over the
        draft's cache from `token`, slot s alive while it has steps left
        (`_left_dev`); returns toks [n, slots] on the device."""
        toks, _, _ = _batch_multi_step(self.model, self.cache, self.token, self._active_dev,
                                       self._left_dev, None, self.cfg, self.SAMPLING, n=n,
                                       graphs=self.graphs)
        return toks

    def commit(self, slot: int, n_emitted: int) -> None:
        """Advance the committed mirror by the round's emitted tokens
        (pending + accepted proposals; the corrected token becomes the new
        pending and stays out of the draft cache per the invariant). A
        slot that was ACTIVE but skipped this round (cap exhausted, window
        full) never fed its pending row: its draft state is stale, so it
        stops being drafted rather than desynchronize."""
        if self.len[slot] <= 0:
            return
        if self._drafted[slot]:
            self.len[slot] += n_emitted
        else:
            self.len[slot] = 0

    def rollback(self) -> None:
        """Write the committed mirror into the device lengths (once a round,
        after all commits), in place."""
        self.cache["length"].copy_(torch.from_numpy(self.len.astype(np.int32)))
