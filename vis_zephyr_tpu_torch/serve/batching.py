"""Continuous batching: the slot scheduler and the dense-cache batcher.

Port of `vis_zephyr_tpu/serve/batching.py`: requests, the pending queue,
whole-prompt and chunked prefill admission, first-token sampling on
activation, emit / finish / cancel, the per-slot sampling state (temperature
and top-p overrides, logprobs, frequency / presence penalties), multi-step
bursts, the host side of prompt-lookup speculation (`lookahead`: per-slot
lookup histories and `_step_verify`, the acceptance loop around the
batcher's `_verify_device`, with a draft model's proposals when one is given:
`serve/draft.py::DraftModel`), the `ServingMetrics` hooks (TTFT / TPOT at
finish, proposals and acceptance each verify step), multi-LoRA serving (a
pack of adapters, `ops/mlora.py`, and each slot's adapter index in a fixed
device buffer that every forward reads), and `ContinuousBatcher`
itself on one dense
cache `[L, slots, cache_len, Hkv, D]` (`_admit`, `_batch_step`,
`_batch_multi_step`, the dense verify step). The paged batcher
(`serve/paged.py::PagedBatcher`) inherits the scheduler.

- a fixed pool of `max_slots` sequence slots shares one batched KV store,
- new requests prefill individually (B = 1) between decode steps, whole or in
  chunks of `prefill_chunk` tokens, one chunk per scheduler step,
- one decode step advances ALL active slots; inactive slots emit pad tokens
  and their lengths do not grow,
- finished slots (EOS / budget / cancel) are free at once.

Every decode step runs in a burst (`_run_burst`: n steps with the EOS and
budget carry on the device, one copy to the host; n is one while admission
work waits or a slot wants logprobs or penalties). On the card each step of
a burst, and each verify step, is a replay of the step captured over the
batcher's fixed buffers (`serve/graphs.py`): the cache or pools, lengths,
tokens, the carry and the per-slot sampling operands (temperatures and
top-p [slots], frequency and presence [slots], counts [slots, V] f32, the
logprobs' outputs).

The JAX batcher is functional (its jitted programs return new caches). Here
the device state is updated in place, so exactly one thread may call `step`.
`active`, `budget`, `slot_len` stay on the host as numpy, as there.

Not ported yet, each raising `NotImplementedError` when asked for: meshes
and grammars.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from typing import Iterator, List, Optional

import numpy as np
import torch

from ..config import VisZephyrConfig
from ..models.mistral import embed, init_cache, mistral_forward
from ..models.vis_zephyr import VisZephyr, prepare_multimodal, vis_zephyr_forward
from ..ops import _kernels
from .generate import (LP_TOPK, LookupHistory, SamplingConfig, _logprobs, _logprobs_host,
                       _sample, _sample_tail, decode_step, not_ported, verify_step, weight_form)
from .graphs import StepGraphs, addresses, mlora_key

@torch.no_grad()
def _prefill_kv(model: VisZephyr, input_ids, images, patch_valid, cfg: VisZephyrConfig,
                mlora=None, adapter_idx=None):
    """Single-request prefill → (last_logits [V], k/v [L, T, Hkv, D], length).
    On a CUDA device the spliced length is padded to a multiple of 128, the
    flash kernel's tile; a text-only prompt too (pad tokens marked invalid),
    which is how a draft model's admission reaches the kernel. `mlora` /
    `adapter_idx` [1]: the request's multi-LoRA adapter, which shapes its
    prompt's K/V."""
    pad_mult = 128 if input_ids.device.type == "cuda" else None
    text_valid = None
    if images is None and pad_mult and input_ids.shape[1] % pad_mult:
        T = input_ids.shape[1]
        input_ids = torch.nn.functional.pad(input_ids, (0, (-T) % pad_mult),
                                            value=cfg.decoder.pad_token_id)
        text_valid = torch.arange(input_ids.shape[1], device=input_ids.device)[None] < T
    logits, aux = vis_zephyr_forward(model, input_ids, images, patch_valid, cfg,
                                     text_valid=text_valid, return_kv=True,
                                     pad_to_multiple=pad_mult, mlora=mlora,
                                     adapter_idx=adapter_idx)
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
def _chunk_extend(decoder, embeds, positions, valid, cache, cfg: VisZephyrConfig,
                  mlora=None, adapter_idx=None):
    """Append one prefill chunk to a B = 1 scratch cache (the decoder's
    cache-extension mode: the chunk attends causally over all earlier
    chunks), under the request's multi-LoRA adapter when `mlora` is given.
    The cache is updated in place."""
    return mistral_forward(decoder, embeds, cfg.decoder, positions, attn_valid=valid,
                           cache=cache, logits_slice="all", mlora=mlora,
                           adapter_idx=adapter_idx)


@torch.no_grad()
def _admit(cache, k, v, length: int, slot: int):
    """Copy a prefilled sequence's K/V [L, T, Hkv, D] into cache slot `slot`
    and set its length, in place (the JAX function's slot update). Rows past
    the cache, where a prefill was padded beyond `cache_len`, lie past
    `length` and are dropped."""
    T = min(k.shape[1], cache["k"].shape[2])
    cache["k"][:, slot, :T] = k[:, :T]
    cache["v"][:, slot, :T] = v[:, :T]
    cache["length"][slot] = int(length)
    return cache


@torch.no_grad()
def _batch_step(model: VisZephyr, cache, token, active, generator: Optional[torch.Generator],
                cfg: VisZephyrConfig, sampling: SamplingConfig, mlora=None, adapter_idx=None,
                sample_overrides=None, grammar=None, penalties=None):
    """One decode step over all slots of the dense cache; inactive slots are
    frozen (their row is written at their length, which does not grow).

    `sample_overrides`: optional (temps [B], top_ps [B]) per-slot sampling
    parameters (`generate._sample_per_slot`). `penalties`: optional (freq
    [B], pres [B], counts [B, V] f32) frequency / presence penalties over
    emitted tokens; the counts gain the step's tokens in place. `mlora` /
    `adapter_idx` [B]: each slot's multi-LoRA adapter. The JAX step's
    logprobs (`want_logprobs`) are `_logprobs` of the raw logits it returns,
    which `_run_burst` takes; its grammar argument comes with grammars
    (Queue A step 10).

    `cache` (lengths included) and `token` are updated IN PLACE. Returns
    (next_token [B], logits [B, V] f32)."""
    if grammar:
        raise not_ported("structured output (grammar)", "Queue A step 10")
    logits, _ = decode_step(model, cache, token, cfg, mlora=mlora, adapter_idx=adapter_idx)
    # The decode step advanced every slot's length; inactive slots keep theirs.
    cache["length"].sub_((~active).to(cache["length"].dtype))
    next_token = _sample_tail(logits, generator, sampling, active, cfg.decoder.pad_token_id,
                              sample_overrides, penalties)
    token.copy_(next_token)
    return next_token, logits


@torch.no_grad()
def _run_burst(step, key, token, active, steps_left, eos: int, n: int,
               graphs: Optional[StepGraphs], generator: Optional[torch.Generator],
               lp_out=None):
    """`n` chained decode steps (multi-step scheduling): the host's
    scheduling, the step's Python and the copy of its tokens are paid once a
    burst instead of once a token. `step(alive)` runs one step over the slots
    `alive` and returns (next_token [B], logits [B, V] f32), writing the
    token into `token` in place.

    Token-exact with single-stepping: the device carries `alive` (from
    `active`) and each slot's `steps_left` (the host's remaining budget,
    int32 [B]), so a slot that emits EOS or runs out of budget mid-burst is
    inactive from the next step on, as if the host had finished it between
    steps. With temperature > 0 the draws come from `generator` in the
    single-step order. `lp_out`: three tensors [n, B], [n, B, LP_TOPK] int32,
    [n, B, LP_TOPK] that take step j's `_logprobs` at row j.

    On a CUDA tensor (outside `_kernels.plain_versions()`) every step is a
    replay of the step captured under `key` (`graphs`, a `StepGraphs`; a
    throwaway one when None): whatever the step reads must keep its tensors
    for the graphs' life, and `key` names them. Elsewhere the same step runs
    eagerly. Returns (toks [n, B], entry_alive [n, B] bool, logits [B, V]
    f32 of the last step), all on the device: token (j, b) counts iff
    entry_alive[j, b]."""
    B = token.shape[0]
    dev = token.device
    graphed = _kernels.use_kernel(token)
    if graphed and graphs is None:
        graphs = StepGraphs()

    def make_carry():  # alive, steps left, alive entering the step
        return (torch.empty(B, dtype=torch.bool, device=dev),
                torch.empty(B, dtype=torch.int32, device=dev),
                torch.empty(B, dtype=torch.bool, device=dev))

    alive, left, entry = graphs.buffers(("carry", B), make_carry) if graphed else make_carry()
    alive.copy_(active)
    left.copy_(steps_left)

    def body():
        entry.copy_(alive)
        tok, logits = step(alive)
        left.sub_(1)
        alive.logical_and_((tok != eos) & (left > 0))
        return logits, (None if lp_out is None else _logprobs(logits, tok))

    toks = torch.empty((n, B), dtype=token.dtype, device=dev)
    entry_alive = torch.empty((n, B), dtype=torch.bool, device=dev)
    for j in range(n):
        logits, lp = graphs.run(key, body, dev, generator) if graphed else body()
        toks[j].copy_(token)
        entry_alive[j].copy_(entry)
        if lp_out is not None:
            for out, got in zip(lp_out, lp):
                out[j].copy_(got)
    return toks, entry_alive, logits


@torch.no_grad()
def _batch_multi_step(model: VisZephyr, cache, token, active, steps_left,
                      generator: Optional[torch.Generator], cfg: VisZephyrConfig,
                      sampling: SamplingConfig, n: int = 4, graphs: Optional[StepGraphs] = None,
                      sample_overrides=None, penalties=None, lp_out=None, mlora=None,
                      adapter_idx=None):
    """`n` chained `_batch_step`s in one burst (`_run_burst`): on the card
    each a replay of the step captured over the cache, `token`, the carry,
    the sampling operands and the multi-LoRA operands (`mlora` and the
    per-slot `adapter_idx` buffer), which must keep their tensors for the
    graphs' life. The cache and `token` are updated IN PLACE. Returns (toks
    [n, B], entry_alive [n, B], logits [B, V] f32 of the last step)."""
    def step(alive):
        return _batch_step(model, cache, token, alive, generator, cfg, sampling, mlora=mlora,
                           adapter_idx=adapter_idx, sample_overrides=sample_overrides,
                           penalties=penalties)

    key = ("dense", token.shape[0], weight_form(model), sampling.temperature, sampling.top_p,
           sampling.eos_token_id, generator, lp_out is not None, *mlora_key(mlora, adapter_idx),
           *addresses(cache["k"], cache["v"], cache["length"], token,
                  *(sample_overrides or (None, None)), *(penalties or (None, None, None))))
    return _run_burst(step, key, token, active, steps_left, sampling.eos_token_id, n, graphs,
                      generator, lp_out)


def _reset_count_row(counts: torch.Tensor, slot: int, tok: int) -> torch.Tensor:
    """A fresh activation in `slot`: zero its emitted-token counts and record
    the first token, in place."""
    counts[slot].zero_()
    counts[slot, tok] += 1.0
    return counts


@dataclasses.dataclass
class _Request:
    request_id: int
    input_ids: np.ndarray
    images: Optional[np.ndarray]
    patch_valid: Optional[np.ndarray]
    max_new_tokens: int
    adapter: int = 0  # multi-LoRA index (0 = the base model)
    # Per-request sampling overrides (None = the batcher's SamplingConfig).
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    # OpenAI frequency / presence penalties over emitted tokens (0 = off).
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    # OpenAI logprobs: None = off; N (0..LP_TOPK) = the chosen token's logprob
    # and the top alternatives of each emitted token, appended to `lp_log` as
    # (chosen_lp, top_ids, top_lps) BEFORE the token enters `out` (so a
    # consumer reading token i may index lp_log[i]).
    logprobs: Optional[int] = None
    lp_log: List[tuple] = dataclasses.field(default_factory=list)
    cancelled: bool = False  # set by cancel(); slot freed at the next step
    out: "queue.Queue[Optional[int]]" = dataclasses.field(default_factory=queue.Queue)
    # Wall-clock trace of the request.
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    n_tokens: int = 0


class ContinuousBatcher:
    """The slot scheduler and the dense-cache batcher: one cache
    [L, max_slots, cache_len, Hkv, D] holds every slot (at 8 slots of 2048
    in bf16, 2 GiB for Zephyr-7B: 128 KiB a slot a token).

    `prefill_chunk`: admit prompts in chunks of this many tokens, one chunk
    per scheduler step; None prefills a whole prompt at admission.
    `lookahead`: speculation, greedy only (`_step_verify` each scheduler
    step, the dense verify step `generate.verify_step`): proposals from
    `draft` (a `serve/draft.py::DraftModel`, kept only when lookahead > 0),
    else, and for the slots it declines, from prompt lookup. `metrics`: a
    `utils/metrics.py::ServingMetrics` that records each finished request's
    TTFT and TPOT and each verify step's proposals and acceptance.
    `multi_step`: a scheduler step with no admission work waiting, and no
    slot asking for logprobs or penalties, runs a burst of this many decode
    steps, else a burst of one (`_batch_multi_step`, replayed as CUDA
    graphs on the card); ignored under `lookahead`. Requests carry their
    own temperature, top-p, logprobs and penalties (`submit`).

    `mlora` / `adapter_names`: multi-LoRA serving, an `ops/mlora.py` pack and
    {name: index >= 1}; `submit(adapter=name)` picks a request's adapter
    (None or "base": the base model). Every forward of a slot (admission
    prefill, whole or chunked, decode steps and bursts, verify steps) adds
    its adapter's deltas, so each slot gives what the one-adapter model
    gives. The steps read the slots' indices from `slot_adapter`, a fixed
    device buffer [max_slots] int32 (0 while a slot is free), so a captured
    step serves any mix of adapters."""

    draft = None    # the proposer under `lookahead`, else prompt lookup alone
    metrics = None  # where finished requests and verify steps are recorded
    mlora = None    # the multi-LoRA pack, when adapters are served

    def __init__(self, model: VisZephyr, cfg: VisZephyrConfig, max_slots: int = 8,
                 cache_len: int = 2048, sampling: SamplingConfig = SamplingConfig(),
                 seed: int = 0, mesh=None, metrics=None, prefill_chunk: Optional[int] = None,
                 lookahead: int = 0, draft=None, multi_step: int = 1, mlora=None,
                 adapter_names=None):
        self._init_scheduler(model, cfg, max_slots, cache_len, sampling, seed, prefill_chunk,
                             mesh=mesh, metrics=metrics, lookahead=lookahead, draft=draft,
                             multi_step=multi_step, mlora=mlora, adapter_names=adapter_names)
        self.cache = init_cache(cfg.decoder, max_slots, cache_len, dtype=model.dtype,
                                device=self.device)

    def _init_scheduler(self, model: VisZephyr, cfg: VisZephyrConfig, max_slots: int,
                        cache_len: int, sampling: SamplingConfig, seed: int,
                        prefill_chunk: Optional[int], mesh=None, metrics=None,
                        lookahead: int = 0, draft=None, multi_step: int = 1,
                        mlora=None, adapter_names=None) -> None:
        if mesh:
            raise not_ported("a device mesh (tensor-parallel serving)", "Queue A step 13")
        self.model = model
        self.cfg = cfg
        self.device = dev = model.device
        self.max_slots = B = max_slots
        self.cache_len = cache_len
        self.sampling = sampling
        self.prefill_chunk = prefill_chunk
        # Speculation is greedy only: silently off when sampling (and
        # multi-step is ignored while it is on), as in the JAX batcher.
        self.lookahead = lookahead if sampling.temperature <= 0.0 else 0
        self.multi_step = max(1, int(multi_step)) if self.lookahead == 0 else 1
        self.draft = draft if self.lookahead > 0 else None
        self.metrics = metrics
        self.mlora = mlora
        self.adapter_names = dict(adapter_names or {})
        self.slot_adapter = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._prefilling = None
        self._reserved_slot = None
        self.token = torch.full((B,), cfg.decoder.pad_token_id, dtype=torch.int64, device=dev)
        self.active = np.zeros(B, bool)
        self.budget = np.zeros(B, np.int64)
        self.slot_req: List[Optional[_Request]] = [None] * B
        self.slot_len = np.zeros(B, np.int64)
        # Per-slot sampling state (the JAX batcher's): the host's arrays and
        # the sets of slots whose request set them, kept from one activation
        # to the next; while no active slot is in a set its operand is off
        # and the step pays nothing for it. The steps read the arrays from
        # one fixed device buffer (temperatures, top-p, frequency, presence),
        # refreshed before a burst that uses them.
        self.slot_temp = np.full(B, sampling.temperature, np.float32)
        self.slot_topp = np.full(B, sampling.top_p, np.float32)
        self.slot_freq = np.zeros(B, np.float32)
        self.slot_pres = np.zeros(B, np.float32)
        self._override_slots: set = set()
        self._lp_slots: set = set()
        self._penalty_slots: set = set()
        self._slot_params = torch.zeros((4, B), dtype=torch.float32, device=dev)
        # Emitted-token counts [B, V] f32, made with the first penalized
        # request; rows reset at activation.
        self.counts: Optional[torch.Tensor] = None
        # Per-slot token history for n-gram lookup (vocabulary tokens only).
        self.slot_hist: List[LookupHistory] = [LookupHistory() for _ in range(B)]
        self.verify_steps = 0  # speculative scheduler steps run
        self.proposed = 0      # tokens proposed over those steps
        self.accepted = 0      # proposals accepted
        self.pending: "queue.Queue[_Request]" = queue.Queue()
        self._requeued: deque = deque()  # head-of-queue retries (no pages free)
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        # The host's `active` and `budget` as the device steps read them:
        # fixed buffers, which a captured step keeps reading.
        self._active_dev = torch.zeros((B,), dtype=torch.bool, device=dev)
        self._left_dev = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.graphs = StepGraphs()  # the captured decode steps (one a key) and verify step
        # [max_slots, V] of the last decode step; [max_slots, S, V] of the
        # last verify step.
        self.last_logits: Optional[torch.Tensor] = None
        self.steps = 0          # decode steps run, in bursts too (verify steps: `verify_steps`)
        self.bursts = 0         # bursts of more than one decode step run
        self.slots_stepped = 0  # active slots summed over decode and verify steps
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
        ids and a final `None` sentinel.

        `temperature` / `top_p`: per-request sampling overrides (None = the
        batcher's SamplingConfig), ignored when the batcher speculates: its
        verify step commits greedy continuations. `logprobs`: None = off; N
        (0..LP_TOPK) = each emitted token's raw-distribution logprob and top
        alternatives in the handle's `lp_log`. `frequency_penalty` /
        `presence_penalty`: OpenAI penalties over the request's emitted
        tokens. Logprobs and penalties are refused under speculation (a
        ValueError, as in the JAX batcher). `adapter`: a multi-LoRA adapter
        name of `adapter_names` (None or "base": the base model); any other
        raises `KeyError`. Grammars are not ported (Queue A step 10)."""
        aidx = 0
        if adapter is not None and adapter != "base":
            if adapter not in self.adapter_names:
                raise KeyError(f"unknown adapter {adapter!r}; loaded: "
                               f"{sorted(self.adapter_names)} (plus 'base')")
            aidx = self.adapter_names[adapter]
        if grammar is not None:
            raise not_ported("structured output (grammar)", "Queue A step 10")
        if logprobs is not None and self.lookahead > 0:
            raise ValueError("logprobs are incompatible with speculative decoding "
                             "(--lookahead); serve logprobs from a non-speculative engine")
        if (frequency_penalty or presence_penalty) and self.lookahead > 0:
            raise ValueError("frequency/presence penalties are incompatible with "
                             "speculative decoding (--lookahead)")
        if self.lookahead > 0:
            temperature = top_p = None
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
            adapter=aidx,
            temperature=temperature,
            top_p=top_p,
            frequency_penalty=float(frequency_penalty or 0.0),
            presence_penalty=float(presence_penalty or 0.0),
            logprobs=logprobs,
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
        return (self.active.any() or not self.pending.empty() or bool(self._requeued)
                or self._prefilling is not None)

    # -- scheduler -----------------------------------------------------------

    def _slot_free(self, slot: int) -> bool:
        return not self.active[slot] and slot != self._reserved_slot

    def _next_request(self) -> Optional[_Request]:
        if self._requeued:
            return self._requeued.popleft()
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
            last_logits, k, v, length = _prefill_kv(self.model, ids, images, pv, self.cfg,
                                                    self.mlora, self._req_aidx(req))
            if length + req.max_new_tokens > self.cache_len:
                req.out.put(None)  # too long for a slot; reject
                continue
            if not self._install(req, slot, last_logits, k, v, length):
                # No room (the paged pools): retry once active requests release it.
                self._requeued.appendleft(req)
                return

    def _install(self, req: _Request, slot: int, last_logits, k, v, length: int) -> bool:
        """Put a prefilled request into `slot` (k / v [L, T, Hkv, D],
        last_logits [V]) and emit its first token. Returns whether it went
        in (the dense cache always has room)."""
        _admit(self.cache, k, v, length, slot)
        self.slot_len[slot] = int(length)
        self._activate(req, slot, last_logits)
        return True

    def _req_aidx(self, req: _Request) -> Optional[torch.Tensor]:
        """A request's adapter index [1] on the device for its admission
        prefill, or None without a pack."""
        if self.mlora is None:
            return None
        return torch.tensor([req.adapter], dtype=torch.int32, device=self.device)

    def _slot_aidx(self) -> Optional[torch.Tensor]:
        """Every slot's adapter index [max_slots] (the fixed buffer the steps
        read; free slots at 0, the base), or None without a pack."""
        return None if self.mlora is None else self.slot_adapter

    def _live(self, held: set) -> bool:
        """Whether an active slot is in `held`."""
        return any(self.active[slot] for slot in held)

    def _sample_overrides(self):
        """(temps [B], top_ps [B]) for the steps, or None while every active
        request samples as the batcher does."""
        if not self._live(self._override_slots):
            return None
        return self._slot_params[0], self._slot_params[1]

    def _penalty_operand(self):
        """(freq [B], pres [B], counts [B, V]) for the steps, or None while no
        active request is penalized."""
        if not self._live(self._penalty_slots):
            return None
        return self._slot_params[2], self._slot_params[3], self.counts

    def _set_slot_sampling(self, req: _Request, slot: int) -> None:
        self.slot_temp[slot] = (self.sampling.temperature if req.temperature is None
                                else req.temperature)
        self.slot_topp[slot] = self.sampling.top_p if req.top_p is None else req.top_p
        if req.temperature is not None or req.top_p is not None:
            self._override_slots.add(slot)
        else:
            self._override_slots.discard(slot)

    def _activate(self, req: _Request, slot: int, last_logits: torch.Tensor) -> None:
        """Open the slot: its sampling state, then its first token, sampled
        from its prefill logits at its own temperature and top-p (its
        logprobs from the host copy of those logits). `max_new_tokens` of 0
        or 1 and an EOS first token finish at once."""
        if self.mlora is not None:
            self.slot_adapter[slot] = req.adapter
        self._set_slot_sampling(req, slot)
        if req.logprobs is not None:
            self._lp_slots.add(slot)
        else:
            self._lp_slots.discard(slot)
        self.slot_freq[slot] = req.frequency_penalty
        self.slot_pres[slot] = req.presence_penalty
        if req.frequency_penalty or req.presence_penalty:
            self._penalty_slots.add(slot)
            if self.counts is None:
                self.counts = torch.zeros((self.max_slots, self.cfg.decoder.vocab_size),
                                          dtype=torch.float32, device=self.device)
        else:
            self._penalty_slots.discard(slot)
        overrides = None
        if slot in self._override_slots:
            overrides = tuple(torch.tensor([x[slot]], device=self.device)
                              for x in (self.slot_temp, self.slot_topp))
        first = _sample(last_logits[None], self.generator, self.sampling, overrides=overrides)
        tok = int(first[0])
        if req.logprobs is not None and tok != self.sampling.eos_token_id:
            req.lp_log.append(_logprobs_host(last_logits.float().cpu().numpy(), tok))
        self.slot_req[slot] = req
        self.active[slot] = True
        self.budget[slot] = req.max_new_tokens - 1
        self.token[slot] = tok
        if self.counts is not None:
            _reset_count_row(self.counts, slot, tok)
        # Lookup history: image sentinels (< 0) are placeholders, and an
        # n-gram crossing one is meaningless.
        self.slot_hist[slot] = LookupHistory([int(t) for t in req.input_ids if t >= 0] + [tok])
        if self.draft is not None:
            self.draft.admit(slot, self.slot_hist[slot].tokens)
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
            # Abandon the prefill; shared prefix pages (the paged batcher's
            # warm admission) go back to their other holders.
            if st.get("shared"):
                self.allocator.release(st["shared"])
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
                st["valid"][:, sl], st["cache"], self.cfg, self.mlora, self._req_aidx(st["req"]))
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
        """Free the slot and end its request's stream; `metrics` records the
        request before its stream ends (the JAX batcher records it just
        after), so a client that has read its reply finds it counted."""
        req = self.slot_req[slot]
        if req is not None:
            if self.metrics is not None and req.first_token_at is not None:
                now = time.perf_counter()
                ttft = (req.first_token_at - req.submitted_at) * 1e3
                tpot = ((now - req.first_token_at) / (req.n_tokens - 1) * 1e3
                        if req.n_tokens > 1 else 0.0)
                self.metrics.record_request(req.request_id, ttft, tpot, req.n_tokens)
            req.out.put(None)
        self.slot_req[slot] = None
        self.active[slot] = False
        if self.mlora is not None:
            self.slot_adapter[slot] = 0
        if self.draft is not None:
            self.draft.release(slot)

    def step(self) -> int:
        """Admit pending requests (one chunk's worth under chunked prefill),
        then advance every active slot: a speculative verify step under
        `lookahead`, else a burst of decode steps (`_step_burst`), of
        `multi_step` when no admission work waits and no slot wants logprobs
        or penalties (they need the host between steps), else of one.
        Returns the number of slot steps taken (a slot counts once a step it
        was alive in). `_before_admission` and `_before_round` are the paged
        batcher's hooks (swap-in, page growth)."""
        self._reap_cancelled()
        self._before_admission()
        if self.prefill_chunk:
            self._pump_prefill()
        else:
            self._admit_pending()
        self._before_round()
        if not self.active.any():
            return 0
        if self.lookahead > 0:
            stepped = self._step_verify()
            self.slots_stepped += stepped
            return stepped
        single = (self._has_admission_work() or self._live(self._lp_slots)
                  or self._live(self._penalty_slots))
        return self._step_burst(1 if single else self.multi_step)

    def _before_admission(self) -> None:
        """Runs each scheduler step after the cancelled slots are reaped and
        before admission; nothing on the dense cache."""

    def _before_round(self) -> None:
        """Runs each scheduler step after admission and before the slots are
        advanced; nothing on the dense cache."""

    # -- multi-step bursts --------------------------------------------------------

    def _has_admission_work(self) -> bool:
        """Whether a request waits to be admitted: a burst then yields to a
        burst of one, so that admission waits one decode step, not
        `multi_step`."""
        return (self._prefilling is not None or not self.pending.empty()
                or bool(self._requeued))

    def _step_burst(self, n: int) -> int:
        """A burst of `n` decode steps over the active slots
        (`_burst_device`: on the card every decode step, a burst of one too,
        is a replay of the captured step), one copy of its tokens (and
        logprobs) to the host, then the host's transitions
        (`_process_burst`)."""
        self._active_dev.copy_(torch.from_numpy(self.active))
        self._left_dev.copy_(torch.from_numpy(self.budget.astype(np.int32)))
        overrides, penalties = self._sample_overrides(), self._penalty_operand()
        if overrides is not None or penalties is not None:
            self._slot_params.copy_(torch.from_numpy(np.stack(
                (self.slot_temp, self.slot_topp, self.slot_freq, self.slot_pres))))
        lp_out = None
        if self._live(self._lp_slots):
            B, dev = self.max_slots, self.device
            lp_out = self.graphs.buffers(("logprobs", n, B), lambda: (
                torch.zeros((n, B), device=dev),
                torch.zeros((n, B, LP_TOPK), dtype=torch.int32, device=dev),
                torch.zeros((n, B, LP_TOPK), device=dev)))
        toks, alive, self.last_logits = self._burst_device(n, overrides, penalties, lp_out)
        host = torch.stack((toks, alive.to(toks.dtype))).cpu().numpy()
        lp_host = None if lp_out is None else [t.cpu().numpy().copy() for t in lp_out]
        stepped = self._process_burst(host[0], host[1].astype(bool), lp_host)
        self.steps += n
        self.bursts += int(n > 1)
        self.slots_stepped += stepped
        return stepped

    def _burst_device(self, n: int, overrides, penalties, lp_out):
        """The device side of a burst: (toks [n, B], entry_alive [n, B],
        logits [B, V]) of `_batch_multi_step` over the dense cache."""
        return _batch_multi_step(self.model, self.cache, self.token, self._active_dev,
                                 self._left_dev, self.generator, self.cfg, self.sampling, n=n,
                                 graphs=self.graphs, sample_overrides=overrides,
                                 penalties=penalties, lp_out=lp_out, mlora=self.mlora,
                                 adapter_idx=self._slot_aidx())

    def _process_burst(self, toks: np.ndarray, alive: np.ndarray, lp=None) -> int:
        """The host side of a burst: toks / alive [n, B], token (j, slot)
        counts iff the slot was alive entering step j. The same emit, EOS and
        budget transitions as single steps, which the device's alive and
        steps-left carry mirrors; `lp`, the burst's logprobs on the host,
        goes to the slots that asked. Returns the slot steps taken."""
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
                req = self.slot_req[slot]
                if lp is not None and slot in self._lp_slots:
                    req.lp_log.append((float(lp[0][j, slot]), lp[1][j, slot], lp[2][j, slot]))
                self._emit(req, tok)
                self.slot_len[slot] += 1
                self.budget[slot] -= 1
                if self.budget[slot] <= 0:
                    self._finish(slot)
        return stepped

    # -- speculation ------------------------------------------------------------

    def _step_verify(self) -> int:
        """One speculative scheduler step: column 0 of the verify batch is
        every slot's pending token (what a decode step would have decoded),
        later columns that slot's proposals, capped by its budget and the
        cache: the draft's (one burst for all slots), else prompt lookup's.
        All slots verify in one multi-token append; each commits its
        accepted prefix and carries the first mismatching greedy token as
        its next pending token, so the tokens equal plain greedy decoding's.
        Returns the number of active slots stepped."""
        S = self.lookahead + 1
        B = self.max_slots
        toks = np.full((B, S), self.cfg.decoder.pad_token_id, np.int64)
        # Column 0 is valid for EVERY slot (active or not); the host's
        # lengths overwrite below roll the inactive slots' rows back.
        valid = np.zeros((B, S), bool)
        valid[:, 0] = True
        token_host = self.token.cpu().numpy().copy()
        caps = np.zeros(B, np.int64)
        for slot in range(B):
            if self.active[slot]:
                caps[slot] = max(0, min(self.lookahead, int(self.budget[slot]) - 1,
                                        self.cache_len - int(self.slot_len[slot]) - 1))
        draft_props = (self.draft.propose(self.active, token_host, caps, self.lookahead)
                       if self.draft is not None else [None] * B)
        props: List[Optional[np.ndarray]] = [None] * B
        for slot in range(B):
            if not self.active[slot]:
                continue
            toks[slot, 0] = token_host[slot]
            cap = int(caps[slot])
            if cap <= 0:
                continue
            prop = draft_props[slot]
            if prop is None or not len(prop):
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
            if self.metrics is not None and len(prop):
                self.metrics.record_speculation(len(prop), n_ok)
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
                self._finish(slot)  # releases the draft's slot too
            else:
                token_host[slot] = emitted[-1]
                if self.draft is not None:
                    # The draft holds pending + accepted now; the corrected
                    # token is the new pending one, kept out of its cache.
                    self.draft.commit(slot, 1 + n_ok)
        # The host is the source of truth for lengths: every slot rolls back
        # to its accepted prefix (and the inactive slots' dummy rows go).
        self._verify_rollback()
        if self.draft is not None:
            self.draft.rollback()
        self.token.copy_(torch.as_tensor(token_host, device=self.device))
        self.verify_steps += 1
        return stepped

    def _verify_device(self, toks: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """Append and verify `toks` [B, S] (`valid` marks real proposals) in
        one cached forward over the dense cache (`generate.verify_step`: on
        the card a replay of the step captured over the cache and two fixed
        buffers); returns the greedy token of every position [B, S] on the
        host. `PagedBatcher` overrides it."""
        greedy, self.last_logits = verify_step(
            self.model, self.cache, torch.from_numpy(toks), torch.from_numpy(valid), self.cfg,
            self.graphs, mlora=self.mlora, adapter_idx=self._slot_aidx())
        return greedy.cpu().numpy()

    def _verify_rollback(self) -> None:
        """Set the device lengths to the host's committed `slot_len`."""
        self.cache["length"].copy_(torch.from_numpy(self.slot_len.astype(np.int32)))

    def run_until_drained(self, max_steps: int = 100000) -> None:
        for _ in range(max_steps):
            if not self.has_work:
                return
            self.step()
