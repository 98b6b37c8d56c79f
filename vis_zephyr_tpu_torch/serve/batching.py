"""Continuous batching: the slot scheduler shared by the batchers.

Port of `vis_zephyr_tpu/serve/batching.py` as far as the paged batcher
(`serve/paged.py::PagedBatcher`) inherits it: requests, the pending queue,
whole-prompt and chunked prefill admission, first-token sampling on
activation, emit / finish / cancel, and the host side of prompt-lookup
speculation (`lookahead`: per-slot lookup histories and `_step_verify`, the
acceptance loop around the subclass's `_verify_device`).

- a fixed pool of `max_slots` sequence slots shares one batched KV store,
- new requests prefill individually (B = 1) between decode steps, whole or in
  chunks of `prefill_chunk` tokens, one chunk per scheduler step,
- one decode step advances ALL active slots; inactive slots emit pad tokens
  and their lengths do not grow,
- finished slots (EOS / budget / cancel) are free at once.

The JAX batcher is functional (its jitted programs return new caches). Here
the device state is updated in place, so exactly one thread may call `step`.
`active`, `budget`, `slot_len` stay on the host as numpy, as there.

The host side of multi-step bursts is here too (`_has_admission_work`,
`_process_burst`); the paged batcher runs the burst on the device.

Not ported yet, each raising `NotImplementedError` when asked for: the dense
batcher's own device step (`ContinuousBatcher` itself, its multi-step burst
included), meshes, metrics, multi-LoRA adapters, per-request sampling
overrides, grammars, logprobs, penalties and a draft model.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Iterator, List, Optional

import numpy as np
import torch

from ..config import VisZephyrConfig
from ..models.mistral import embed, init_cache, mistral_forward
from ..models.vis_zephyr import VisZephyr, prepare_multimodal, vis_zephyr_forward
from .generate import LookupHistory, SamplingConfig, _sample


def not_ported(what: str, step: str):
    """The error every left-out option raises: what it is and the ROADMAP
    entry that brings it."""
    return NotImplementedError(f"{what} is not ported to PyTorch yet (ROADMAP.md, {step})")


@torch.no_grad()
def _prefill_kv(model: VisZephyr, input_ids, images, patch_valid, cfg: VisZephyrConfig):
    """Single-request prefill → (last_logits [V], k/v [L, T, Hkv, D], length).
    On a CUDA device the spliced length is padded to a multiple of 128, the
    flash kernel's tile."""
    pad_mult = 128 if input_ids.device.type == "cuda" else None
    logits, aux = vis_zephyr_forward(model, input_ids, images, patch_valid, cfg,
                                     return_kv=True, pad_to_multiple=pad_mult)
    k, v = aux["kv"]
    length = int(aux["lengths"][0])
    return logits[0, length - 1], k[:, 0], v[:, 0], length


@torch.no_grad()
def _splice_embeds(model: VisZephyr, input_ids, images, patch_valid, cfg: VisZephyrConfig,
                   pad_to: int = 128):
    """Vision encode + Q-Former + splice WITHOUT the decoder pass: the front
    half of prefill, used by chunked admission. Returns (embeds [1, T, D],
    valid, positions, lengths) with T padded to `pad_to` so that chunks stay
    whole."""
    if images is None:
        B, T = input_ids.shape
        dev = input_ids.device
        embeds = embed(model.decoder, input_ids)
        valid = torch.ones((B, T), dtype=torch.bool, device=dev)
        positions = torch.arange(T, dtype=torch.int32, device=dev)[None].repeat(B, 1)
        lengths = torch.full((B,), T, dtype=torch.int32, device=dev)
        pad = (-T) % pad_to
        if pad:
            embeds = torch.nn.functional.pad(embeds, (0, 0, 0, pad))
            valid = torch.nn.functional.pad(valid, (0, pad))
            positions = torch.nn.functional.pad(positions, (0, pad))
        return embeds, valid, positions, lengths
    prepared = prepare_multimodal(model, input_ids, images, patch_valid, cfg,
                                  pad_to_multiple=pad_to)
    return (prepared["embeds"], prepared["valid"], prepared["positions"],
            prepared["lengths"])


@torch.no_grad()
def _chunk_extend(decoder, embeds, positions, valid, cache, cfg: VisZephyrConfig):
    """Append one prefill chunk to a B = 1 scratch cache (the decoder's
    cache-extension mode: the chunk attends causally over all earlier
    chunks). The cache is updated in place."""
    return mistral_forward(decoder, embeds, cfg.decoder, positions, attn_valid=valid,
                           cache=cache, logits_slice="all")


@dataclasses.dataclass
class _Request:
    request_id: int
    input_ids: np.ndarray
    images: Optional[np.ndarray]
    patch_valid: Optional[np.ndarray]
    max_new_tokens: int
    cancelled: bool = False  # set by cancel(); slot freed at the next step
    out: "queue.Queue[Optional[int]]" = dataclasses.field(default_factory=queue.Queue)
    # Wall-clock trace of the request.
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    n_tokens: int = 0


class ContinuousBatcher:
    """Host-side scheduler around the prefill / admit / step programs. The
    dense-cache device step of the JAX class is not ported: build a
    `serve.paged.PagedBatcher`."""

    def __init__(self, model: VisZephyr, cfg: VisZephyrConfig, max_slots: int = 8,
                 cache_len: int = 2048, sampling: SamplingConfig = SamplingConfig(),
                 seed: int = 0, **options):
        raise not_ported("the dense-cache continuous batcher (kv_cache='dense')",
                         "Queue A step 7b")

    def _init_scheduler(self, model: VisZephyr, cfg: VisZephyrConfig, max_slots: int,
                        cache_len: int, sampling: SamplingConfig, seed: int,
                        prefill_chunk: Optional[int], mesh=None, metrics=None,
                        lookahead: int = 0, draft=None, multi_step: int = 1,
                        mlora=None, adapter_names=None) -> None:
        for value, what, step in (
                (mesh, "a device mesh (tensor-parallel serving)", "Queue A step 13"),
                (metrics, "ServingMetrics", "Queue A step 10"),
                (draft, "a draft model", "Queue A step 9"),
                (mlora, "multi-LoRA serving", "Queue A step 10"),
                (adapter_names, "multi-LoRA serving", "Queue A step 10")):
            if value:
                raise not_ported(what, step)
        self.model = model
        self.cfg = cfg
        self.device = model.device
        self.max_slots = max_slots
        self.cache_len = cache_len
        self.sampling = sampling
        self.prefill_chunk = prefill_chunk
        # Speculation is greedy only: silently off when sampling (and
        # multi-step is ignored while it is on), as in the JAX batcher.
        self.lookahead = lookahead if sampling.temperature <= 0.0 else 0
        self.multi_step = max(1, int(multi_step)) if self.lookahead == 0 else 1
        self._prefilling = None
        self._reserved_slot = None
        self.token = torch.full((max_slots,), cfg.decoder.pad_token_id, dtype=torch.int64,
                                device=self.device)
        self.active = np.zeros(max_slots, bool)
        self.budget = np.zeros(max_slots, np.int64)
        self.slot_req: List[Optional[_Request]] = [None] * max_slots
        self.slot_len = np.zeros(max_slots, np.int64)
        # Per-slot token history for n-gram lookup (vocabulary tokens only).
        self.slot_hist: List[LookupHistory] = [LookupHistory() for _ in range(max_slots)]
        self.verify_steps = 0  # speculative scheduler steps run
        self.proposed = 0      # tokens proposed over those steps
        self.accepted = 0      # proposals accepted
        self.pending: "queue.Queue[_Request]" = queue.Queue()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._next_id = 0
        self._lock = threading.Lock()

    # -- public API ----------------------------------------------------------

    def submit(self, input_ids: np.ndarray, images: Optional[np.ndarray] = None,
               patch_valid: Optional[np.ndarray] = None,
               max_new_tokens: Optional[int] = None, adapter: Optional[str] = None,
               temperature: Optional[float] = None, top_p: Optional[float] = None,
               grammar=None, logprobs: Optional[int] = None,
               frequency_penalty: float = 0.0, presence_penalty: float = 0.0) -> _Request:
        """Queue a request. Returns a handle whose `.out` queue yields token
        ids and a final `None` sentinel. Sampling follows the batcher's one
        `SamplingConfig`."""
        if adapter is not None and adapter != "base":
            raise not_ported("a per-request adapter", "Queue A step 10")
        if temperature is not None or top_p is not None:
            raise not_ported("per-request temperature / top_p", "Queue A step 10")
        if grammar is not None:
            raise not_ported("structured output (grammar)", "Queue A step 10")
        if logprobs is not None:
            raise not_ported("logprobs", "Queue A step 10")
        if frequency_penalty or presence_penalty:
            raise not_ported("frequency / presence penalties", "Queue A step 10")
        with self._lock:
            rid = self._next_id
            self._next_id += 1
        req = _Request(
            rid,
            np.asarray(input_ids),
            images if images is None else np.asarray(images),
            patch_valid if patch_valid is None else np.asarray(patch_valid),
            (self.sampling.max_new_tokens if max_new_tokens is None
             else max_new_tokens),  # an explicit 0 means zero tokens
        )
        req.submitted_at = time.perf_counter()
        self.pending.put(req)
        return req

    def stream(self, req: _Request) -> Iterator[int]:
        try:
            while True:
                tok = req.out.get()
                if tok is None:
                    return
                yield tok
        finally:
            # Closed early (client gone): free the slot at the next scheduler
            # step instead of decoding to the budget.
            req.cancelled = True

    def cancel(self, req: _Request) -> None:
        """Stop generating for `req`: its slot (or queue entry) is released
        at the next scheduler step and its stream ends with the sentinel."""
        req.cancelled = True

    def _reap_cancelled(self) -> None:
        for slot in range(self.max_slots):
            req = self.slot_req[slot]
            if self.active[slot] and req is not None and req.cancelled:
                self._finish(slot)

    @property
    def has_work(self) -> bool:
        return (self.active.any() or not self.pending.empty()
                or self._prefilling is not None)

    # -- scheduler -----------------------------------------------------------

    def _slot_free(self, slot: int) -> bool:
        return not self.active[slot] and slot != self._reserved_slot

    def _next_request(self) -> Optional[_Request]:
        try:
            return self.pending.get_nowait()
        except queue.Empty:
            return None

    def _request_tensors(self, req: _Request):
        ids = torch.as_tensor(req.input_ids, device=self.device)[None]
        if req.images is None:
            return ids, None, None
        return (ids, torch.as_tensor(req.images, device=self.device)[None],
                torch.as_tensor(req.patch_valid, device=self.device)[None])

    def _install(self, req: _Request, slot: int, last_logits, k, v, length: int) -> bool:
        raise NotImplementedError

    def _activate(self, req: _Request, slot: int, last_logits: torch.Tensor) -> None:
        """Sample the request's first token from its prefill logits and open
        the slot. `max_new_tokens` of 0 or 1 and an EOS first token finish at
        once."""
        first = _sample(last_logits[None], self.generator, self.sampling)
        tok = int(first[0])
        self.slot_req[slot] = req
        self.active[slot] = True
        self.budget[slot] = req.max_new_tokens - 1
        self.token[slot] = tok
        # Lookup history: image sentinels (< 0) are placeholders, and an
        # n-gram crossing one is meaningless.
        self.slot_hist[slot] = LookupHistory([int(t) for t in req.input_ids if t >= 0] + [tok])
        if req.max_new_tokens <= 0:
            # Explicit zero-token request: prefill ran (and sampled), but
            # nothing is emitted, as on the serialized path.
            self._finish(slot)
        elif tok == self.sampling.eos_token_id:
            self._finish(slot)
        else:
            self._emit(req, tok)
            # max_new_tokens == 1: the first token exhausts the budget; finish
            # now, or the next step would emit a second token.
            if self.budget[slot] <= 0:
                self._finish(slot)

    # -- chunked prefill admission --------------------------------------------
    #
    # With `prefill_chunk` set, a long prompt does not stall active streams:
    # each scheduler step advances the in-flight prefill by ONE chunk (vision
    # and splice ran once up front), then decodes all active slots. The chunk
    # extends a B = 1 scratch cache; on completion the scratch K/V installs
    # through the same `_install` as whole-prompt admission.

    def _pump_prefill(self) -> None:
        st = self._prefilling
        if st is not None and st["req"].cancelled:
            st["req"].out.put(None)
            self._prefilling = None
            self._reserved_slot = None
            st = None
        if st is None:
            req = self._next_request()
            if req is None:
                return
            if req.cancelled:
                req.out.put(None)
                return
            slot = next((s for s in range(self.max_slots) if self._slot_free(s)), None)
            if slot is None:
                self.pending.put(req)  # no slot; retry later
                return
            st = self._begin_prefill(req, slot)
            if st is None:
                return  # rejected
            self._prefilling = st
            self._reserved_slot = slot
            return  # vision + splice was this step's admission work

        C = self.prefill_chunk
        if st["chunk"] < st["n_chunks"]:
            c = st["chunk"]
            sl = slice(c * C, (c + 1) * C)
            logits, st["cache"] = _chunk_extend(
                self.model.decoder, st["embeds"][:, sl], st["positions"][:, sl],
                st["valid"][:, sl], st["cache"], self.cfg)
            if (st["length"] - 1) // C == c:  # the chunk holding the last real token
                st["last_logits"] = logits[0, (st["length"] - 1) % C]
            st["chunk"] += 1
        if st["chunk"] >= st["n_chunks"]:
            k = st["cache"]["k"][:, 0]
            v = st["cache"]["v"][:, 0]
            if self._install(st["req"], st["slot"], st["last_logits"], k, v, st["length"]):
                self._prefilling = None
                self._reserved_slot = None
            # else: no pages free. Retry the install next step (the scratch
            # cache is complete; no chunk runs again).

    def _begin_prefill(self, req: _Request, slot: int):
        ids, images, pv = self._request_tensors(req)
        embeds, valid, positions, lengths = _splice_embeds(
            self.model, ids, images, pv, self.cfg, pad_to=self.prefill_chunk)
        length = int(lengths[0])
        if length + req.max_new_tokens > self.cache_len:
            req.out.put(None)
            return None
        T = embeds.shape[1]
        return {
            "req": req,
            "slot": slot,
            "embeds": embeds,
            "valid": valid,
            "positions": positions,
            "cache": init_cache(self.cfg.decoder, 1, T, dtype=self.model.dtype,
                                device=self.device),
            "chunk": 0,
            "n_chunks": -(-length // self.prefill_chunk),
            "length": length,
            "last_logits": None,
        }

    def _emit(self, req: _Request, tok: int) -> None:
        if req.first_token_at is None:
            req.first_token_at = time.perf_counter()
        req.n_tokens += 1
        req.out.put(tok)

    def _finish(self, slot: int) -> None:
        req = self.slot_req[slot]
        if req is not None:
            req.out.put(None)
        self.slot_req[slot] = None
        self.active[slot] = False

    def step(self) -> int:
        raise NotImplementedError

    # -- multi-step bursts --------------------------------------------------------

    def _has_admission_work(self) -> bool:
        """Whether a request waits to be admitted: a burst then yields to a
        burst of one, so that admission waits one decode step, not
        `multi_step`."""
        return self._prefilling is not None or not self.pending.empty()

    def _process_burst(self, toks: np.ndarray, alive: np.ndarray) -> int:
        """The host side of a burst: toks / alive [n, B], token (j, slot)
        counts iff the slot was alive entering step j. The same emit, EOS and
        budget transitions as single steps, which the device's alive and
        steps-left carry mirrors. Returns the slot steps taken."""
        stepped = 0
        for j in range(toks.shape[0]):
            for slot in range(self.max_slots):
                if not (self.active[slot] and alive[j, slot]):
                    continue
                stepped += 1
                tok = int(toks[j, slot])
                if tok == self.sampling.eos_token_id:
                    self._finish(slot)
                    continue
                self._emit(self.slot_req[slot], tok)
                self.slot_len[slot] += 1
                self.budget[slot] -= 1
                if self.budget[slot] <= 0:
                    self._finish(slot)
        return stepped

    # -- speculation ------------------------------------------------------------

    def _step_verify(self) -> int:
        """One speculative scheduler step: column 0 of the verify batch is
        every slot's pending token (what a decode step would have decoded),
        later columns that slot's prompt-lookup proposals, capped by its
        budget and the cache. All slots verify in one multi-token append;
        each commits its accepted prefix and carries the first mismatching
        greedy token as its next pending token, so the tokens equal plain
        greedy decoding's. Returns the number of active slots stepped."""
        S = self.lookahead + 1
        B = self.max_slots
        toks = np.full((B, S), self.cfg.decoder.pad_token_id, np.int64)
        # Column 0 is valid for EVERY slot (active or not); the host's
        # lengths overwrite below roll the inactive slots' rows back.
        valid = np.zeros((B, S), bool)
        valid[:, 0] = True
        token_host = self.token.cpu().numpy().copy()
        props: List[Optional[np.ndarray]] = [None] * B
        for slot in range(B):
            if not self.active[slot]:
                continue
            toks[slot, 0] = token_host[slot]
            cap = max(0, min(self.lookahead, int(self.budget[slot]) - 1,
                             self.cache_len - int(self.slot_len[slot]) - 1))
            if cap <= 0:
                continue
            prop = self.slot_hist[slot].propose(cap)
            if prop is None or not len(prop):
                continue
            prop = np.asarray(prop[:cap], np.int64)
            toks[slot, 1 : 1 + len(prop)] = prop
            valid[slot, 1 : 1 + len(prop)] = True
            props[slot] = prop

        greedy = self._verify_device(toks, valid)

        stepped = 0
        for slot in range(B):
            if not self.active[slot]:
                continue
            stepped += 1
            prop = props[slot] if props[slot] is not None else np.zeros(0, np.int64)
            n_ok = 0
            while n_ok < len(prop) and greedy[slot, n_ok] == prop[n_ok]:
                n_ok += 1
            self.proposed += len(prop)
            self.accepted += n_ok
            emitted = [int(t) for t in prop[:n_ok]] + [int(greedy[slot, n_ok])]
            # The pools now hold pending + accepted proposals; the last
            # emitted token is the NEW pending one (not yet written).
            self.slot_len[slot] += 1 + n_ok
            finished = False
            for t in emitted:
                if t == self.sampling.eos_token_id:
                    finished = True
                    break
                self._emit(self.slot_req[slot], t)
                self.slot_hist[slot].append(t)
                self.budget[slot] -= 1
                if self.budget[slot] <= 0:
                    finished = True
                    break
            if finished:
                self._finish(slot)
            else:
                token_host[slot] = emitted[-1]
        # The host is the source of truth for lengths: every slot rolls back
        # to its accepted prefix (and the inactive slots' dummy rows go).
        self._verify_rollback()
        self.token.copy_(torch.as_tensor(token_host, device=self.device))
        self.verify_steps += 1
        return stepped

    def _verify_device(self, toks: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """Append and verify `toks` [B, S] (`valid` marks real proposals);
        returns the greedy token of every position [B, S] on the host. The
        dense batcher's form is step 7b; `PagedBatcher` overrides it."""
        raise not_ported("the dense batcher's verify step", "Queue A step 7b")

    def _verify_rollback(self) -> None:
        """Set the device lengths to the host's committed `slot_len`."""
        raise not_ported("the dense batcher's verify step", "Queue A step 7b")

    def run_until_drained(self, max_steps: int = 100000) -> None:
        for _ in range(max_steps):
            if not self.has_work:
                return
            self.step()
