"""Autoregressive generation: multimodal prefill + dense KV-cache decode.

Port of `vis_zephyr_tpu/serve/generate.py` for the single-request path:
`SamplingConfig`, `pad_to_bucket`, `_sample` (greedy, temperature, top-p),
`prefill`, `decode_step`, `decode_multi_step`, `decode_verify`,
`_propose_lookup`, `generate` (its decode loop is one burst) and
`generate_stream`'s burst loop (bursts of `multi_step` decode steps, of one
by default) and its prompt-lookup speculative loop (`lookahead`). On the
card a burst of n steps replays one captured step n times
(`serve/graphs.py`) over the model's fixed decode cache for the batch
(`burst_cache`), where the JAX package compiles its step and `lax.scan`
once per bucket, and each speculative verify replays one captured verify
step over the same cache (`verify_step`); on the CPU, and inside
`_kernels.plain_versions()`, the eager `decode_step` and `decode_verify`
run. Grammars, logprobs, penalties and beams are not ported yet.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..config import VisZephyrConfig

from ..models.mistral import embed, init_cache, mistral_forward
from ..models.vis_zephyr import VisZephyr, vis_zephyr_forward
from ..ops import _kernels
from .graphs import StepGraphs

# Speculation counts of the dense path in this process (reset by callers that
# count): verify calls, tokens proposed, proposals accepted. `verify_calls`
# is bumped inside the step, so the step graphs carry it across replays.
verify_calls = 0
proposed = 0
accepted = 0
_kernels.register_counters(__name__, "verify_calls")


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    max_new_tokens: int = 128
    temperature: float = 0.0  # 0 → greedy
    top_p: float = 1.0
    eos_token_id: int = 2


def pad_to_bucket(length: int, bucket: int = 128, minimum: int = 128) -> int:
    return max(minimum, ((length + bucket - 1) // bucket) * bucket)


def _sample(logits: torch.Tensor, generator: Optional[torch.Generator],
            sampling: SamplingConfig) -> torch.Tensor:
    """logits [B, V] → token [B] (first maximum under greedy)."""
    if sampling.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / sampling.temperature
    if sampling.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
        # Keep the smallest set with cumulative probability ≥ top_p.
        cutoff_idx = (cum < sampling.top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _cache_len(T: int, images, cfg: VisZephyrConfig, max_new_tokens: int,
               lookahead: int = 0) -> int:
    """The dense cache's slots: prompt, image tokens, budget and the verify
    step's `lookahead` rows past the last committed token."""
    n_img = 0 if images is None else (images.shape[1] * cfg.tokens_per_patch
                                      + cfg.max_extra_merge_tokens())
    return pad_to_bucket(T + n_img + max_new_tokens + lookahead)


@torch.no_grad()
def prefill(
    model: VisZephyr,
    input_ids: torch.Tensor,
    images: Optional[torch.Tensor],
    patch_valid: Optional[torch.Tensor],
    cfg: VisZephyrConfig,
    cache_len: int,
    text_valid: Optional[torch.Tensor] = None,
    cache: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
    """Run the multimodal prefill; the per-layer K/V it returns are copied
    into a fresh decode cache of `cache_len` slots, or into `cache` (a
    `burst_cache` buffer of at least that many: rows past the prompt keep
    what they held, which the decode mask never lets through). On a CUDA
    device the
    spliced length is padded to a multiple of 128, the flash kernel's tile.

    Returns (last_logits [B, V] f32, cache, lengths [B])."""
    B = input_ids.shape[0]
    pad_mult = 128 if input_ids.device.type == "cuda" else None
    logits, aux = vis_zephyr_forward(
        model, input_ids, images, patch_valid, cfg,
        text_valid=text_valid, return_kv=True, pad_to_multiple=pad_mult,
    )
    lengths = aux["lengths"]
    k, v = aux["kv"]  # [L, B, T, Hkv, D]
    T = k.shape[2]
    if cache_len < T:
        raise ValueError(f"cache_len={cache_len} < prefill length {T}")
    if cache is None:
        cache = init_cache(cfg.decoder, B, cache_len, dtype=model.dtype, device=k.device)
    elif cache["k"].shape[1] != B or cache["k"].shape[2] < cache_len:
        raise ValueError(f"cache of {tuple(cache['k'].shape[1:3])} (batch, slots) given for "
                         f"({B}, {cache_len})")
    cache["k"][:, :, :T] = k
    cache["v"][:, :, :T] = v
    cache["length"].copy_(lengths)
    last = logits[torch.arange(B, device=logits.device), lengths.long() - 1]
    return last, cache, lengths


@torch.no_grad()
def decode_step(
    model: VisZephyr,
    cache: Dict,
    token: torch.Tensor,  # [B]
    cfg: VisZephyrConfig,
) -> Tuple[torch.Tensor, Dict]:
    """One decode step; the cache is updated in place. Returns (logits
    [B, V], cache)."""
    positions = cache["length"][:, None]
    embeds = embed(model.decoder, token[:, None])
    logits, new_cache = mistral_forward(
        model.decoder, embeds, cfg.decoder, positions,
        cache=cache, logits_slice="last",
    )
    return logits[:, 0], new_cache


# The decode caches kept per model on the card: one a (batch, device), with
# its captured step.
_bursts: "weakref.WeakKeyDictionary[VisZephyr, Dict]" = weakref.WeakKeyDictionary()


def burst_cache(model: VisZephyr, cfg: VisZephyrConfig, batch: int, cache_len: int,
                like: torch.Tensor) -> Tuple[Optional[Dict], Optional[StepGraphs]]:
    """(cache, graphs) for a burst over `batch` rows of at least `cache_len`
    slots on the device of `like` (the prompt's ids).
    On the card: the model's one fixed dense cache for that batch, reused
    across requests so that they all replay one captured step, and its
    `StepGraphs`. A request that needs more slots than the cache has
    replaces it by one of `cache_len` slots (and a new capture), so the
    cache settles at the longest request served; decode attends the whole
    buffer, masked past each row's length. One generation at a time per
    model (the engine's serialized path holds its lock). Elsewhere, and
    inside `_kernels.plain_versions()`, (None, None): `prefill` makes a
    fresh cache of `cache_len` slots and the burst runs eagerly."""
    if not _kernels.use_kernel(like):
        return None, None
    caches = _bursts.setdefault(model, {})
    key = (batch, like.device)
    got = caches.get(key)
    if got is None or got[0]["k"].shape[2] < cache_len:
        caches.pop(key, None)  # the old cache and graph go before the new are made
        got = caches[key] = (init_cache(cfg.decoder, batch, cache_len, dtype=model.dtype,
                                        device=like.device), StepGraphs())
    return got


@torch.no_grad()
def decode_multi_step(
    model: VisZephyr,
    cache: Dict,
    token: torch.Tensor,  # [B]
    generator: Optional[torch.Generator],
    cfg: VisZephyrConfig,
    sampling: SamplingConfig,
    n: int,
    graphs: Optional[StepGraphs] = None,
) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
    """`n` chained `decode_step`s with sampling (the serialized path's
    multi-step burst): step j decodes the token step j − 1 sampled. Returns
    (toks [n, B] on the device, cache, last token); the caller copies toks
    to the host once and discards tokens past an EOS (the cache's rows past
    it are never read: the next request's prefill resets `length`).

    On a CUDA tensor (outside `_kernels.plain_versions()`) each step is a
    replay of one captured step (`graphs`, a `StepGraphs`; a throwaway one
    when None) over `cache` and a fixed token buffer, which the returned
    token is; `cache` must keep its tensors for the graphs' life
    (`burst_cache`). Elsewhere the same step runs eagerly. Under greedy
    decoding the tokens are those of n eager `decode_step`s; with
    temperature > 0 the draws come from `generator` in the same order."""
    B = token.shape[0]
    dev = token.device
    toks = torch.empty((n, B), dtype=torch.int64, device=dev)
    if not _kernels.use_kernel(token):
        for j in range(n):
            logits, cache = decode_step(model, cache, token, cfg)
            token = _sample(logits, generator, sampling)
            toks[j] = token
        return toks, cache, token
    if graphs is None:
        graphs = StepGraphs()
    buf = graphs.buffers(("token", B), lambda: torch.empty(B, dtype=torch.int64, device=dev))
    if token is not buf:
        buf.copy_(token)

    def step():
        logits = decode_step(model, cache, buf, cfg)[0]
        buf.copy_(_sample(logits, generator, sampling))
        return logits

    # The step reads the sampler's temperature and top-p, not the budget.
    key = ("decode", B, *(cache[name].data_ptr() for name in ("k", "v", "length")),
           sampling.temperature, sampling.top_p, generator)
    for j in range(n):
        graphs.run(key, step, dev, generator)
        toks[j].copy_(buf)
    return toks, cache, buf


@torch.no_grad()
def decode_verify(
    model: VisZephyr,
    cache: Dict,
    tokens: torch.Tensor,  # [B, S]
    valid: torch.Tensor,   # [B, S] bool: padded proposal slots are False
    cfg: VisZephyrConfig,
) -> Tuple[torch.Tensor, Dict]:
    """Speculative verify: append S tokens (the pending accepted token plus
    S − 1 proposed) in ONE cached forward (K2 writes the S rows of each
    layer) and return per-position logits [B, S, V] f32. The caller rolls
    `cache["length"]` back to the accepted prefix; rejected rows hold K/V
    that the next append overwrites (attention masks keys off `length`)."""
    global verify_calls
    positions = cache["length"][:, None] + torch.cumsum(valid.to(torch.int32), dim=1) - 1
    embeds = embed(model.decoder, tokens)
    logits, new_cache = mistral_forward(
        model.decoder, embeds, cfg.decoder, positions,
        attn_valid=valid, cache=cache, logits_slice="all",
    )
    verify_calls += 1
    return logits, new_cache


@torch.no_grad()
def verify_step(
    model: VisZephyr,
    cache: Dict,
    tokens: torch.Tensor,  # [B, S]
    valid: torch.Tensor,   # [B, S] bool
    cfg: VisZephyrConfig,
    graphs: Optional[StepGraphs] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`decode_verify` with the greedy token of every position: returns
    (greedy [B, S], logits [B, S, V] f32) on the cache's device, and
    `cache["length"]` advanced in place by the valid tokens.

    On a CUDA cache (outside `_kernels.plain_versions()`) the step is a
    replay of the one captured over `cache` and two fixed buffers that
    `tokens` and `valid` (host or device tensors) are copied into
    (`graphs`, a `StepGraphs`; a throwaway one when None); `cache` must keep
    its tensors for the graphs' life (`burst_cache`), and the returned
    tensors are the graph's, overwritten by its next replay. Elsewhere
    `decode_verify` runs eagerly."""
    length = cache["length"]
    dev = length.device
    if not _kernels.use_kernel(length):
        logits, _ = decode_verify(model, cache, tokens.to(dev), valid.to(dev), cfg)
        return torch.argmax(logits, dim=-1), logits
    if graphs is None:
        graphs = StepGraphs()
    B, S = tokens.shape
    tok_buf, valid_buf = graphs.buffers(("verify", B, S), lambda: (
        torch.zeros((B, S), dtype=torch.int64, device=dev),
        torch.zeros((B, S), dtype=torch.bool, device=dev)))
    tok_buf.copy_(tokens)
    valid_buf.copy_(valid)

    def step():
        logits = decode_verify(model, cache, tok_buf, valid_buf, cfg)[0]
        return torch.argmax(logits, dim=-1), logits

    key = ("verify", B, S, *(cache[name].data_ptr() for name in ("k", "v", "length")))
    return graphs.run(key, step, dev)


class LookupHistory:
    """A sequence's token history that proposes as `_propose_lookup(history,
    ngram=2, span)` does, in constant time a call where the function scans
    the whole history: a 32-slot verify step of long prompts spent most of
    its host time in those scans, with the card idle.

    Each bigram keeps the start of its last two occurrences. The trailing
    bigram's last occurrence is the tail itself, so the one before it is the
    scan's most recent match, and its continuation is never empty.
    `np.asarray(history)` and `list(history)` give the tokens."""

    def __init__(self, tokens=()):
        self.tokens: List[int] = []
        self._starts: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for t in tokens:
            self.append(t)

    def append(self, token: int) -> None:
        self.tokens.append(int(token))
        if len(self.tokens) >= 2:
            key = (self.tokens[-2], self.tokens[-1])
            self._starts[key] = (len(self.tokens) - 2, self._starts.get(key, (-1,))[0])

    def propose(self, span: int) -> Optional[np.ndarray]:
        """`_propose_lookup(np.asarray(self), ngram=2, span=span)`."""
        if len(self.tokens) < 3:
            return None
        earlier = self._starts[(self.tokens[-2], self.tokens[-1])][1]
        if earlier < 0:
            return None
        return np.asarray(self.tokens[earlier + 2: earlier + 2 + span], np.int64)

    def __len__(self) -> int:
        return len(self.tokens)

    def __iter__(self):
        return iter(self.tokens)

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.tokens, dtype or np.int64)


def _propose_lookup(history: np.ndarray, ngram: int = 2, span: int = 8):
    """Prompt-lookup proposal (speculation without a draft model): find the
    most recent earlier occurrence of the trailing `ngram` tokens in the
    sequence so far and propose the tokens that followed it."""
    n = len(history)
    if n < ngram + 1:
        return None
    tail = history[-ngram:]
    body = history[: n - 1]  # allow overlap up to the penultimate token
    windows = np.lib.stride_tricks.sliding_window_view(body, ngram)
    matches = np.flatnonzero((windows == tail).all(axis=1))
    # Most recent match whose continuation has at least one known token.
    for i in matches[::-1]:
        cont = history[i + ngram : i + ngram + span]
        if len(cont):
            return cont
    return None


@torch.no_grad()
def generate(
    model: VisZephyr,
    input_ids: torch.Tensor,
    images: Optional[torch.Tensor],
    patch_valid: Optional[torch.Tensor],
    cfg: VisZephyrConfig,
    sampling: SamplingConfig = SamplingConfig(),
    text_valid: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> np.ndarray:
    """Batch generation. Returns [B, max_new_tokens] token ids, EOS-padded
    after each row stops. The decode loop (JAX `_decode_loop`) is one burst
    of `max_new_tokens − 1` steps (`decode_multi_step`); a row's tokens
    after its first EOS are replaced by EOS on the host."""
    B = input_ids.shape[0]
    cache_len = _cache_len(input_ids.shape[1], images, cfg, sampling.max_new_tokens)
    fixed, graphs = burst_cache(model, cfg, B, cache_len, input_ids)
    last_logits, cache, _ = prefill(model, input_ids, images, patch_valid, cfg, cache_len,
                                    text_valid=text_valid, cache=fixed)
    token = _sample(last_logits, generator, sampling)
    tokens = [token[None]]
    if sampling.max_new_tokens > 1:
        tokens.append(decode_multi_step(model, cache, token, generator, cfg, sampling,
                                        sampling.max_new_tokens - 1, graphs)[0])
    out = torch.cat(tokens).T.cpu().numpy()
    eos = sampling.eos_token_id
    return np.where(np.cumsum(out == eos, axis=1) > 0, eos, out)


@torch.no_grad()
def generate_stream(
    model: VisZephyr,
    input_ids: torch.Tensor,
    images: Optional[torch.Tensor],
    patch_valid: Optional[torch.Tensor],
    cfg: VisZephyrConfig,
    sampling: SamplingConfig = SamplingConfig(),
    generator: Optional[torch.Generator] = None,
    lookahead: int = 0,
    multi_step: int = 1,
) -> Iterator[int]:
    """Single-sequence streaming generation: yields token ids until EOS or
    the budget is exhausted, one decode step per token, in bursts
    (`decode_multi_step`) with one device-to-host copy each.

    `lookahead > 0` turns on prompt-lookup speculative decoding (greedy
    only; off when `sampling.temperature > 0`): up to `lookahead` tokens
    proposed from the sequence's own n-gram structure are verified in one
    multi-token cache append (`verify_step`, over the same fixed cache as
    the bursts on the card), with the same tokens as plain greedy decoding
    and fewer decoder passes.

    `multi_step` (ignored while speculation is on): the bursts' size, which
    ramps 1→2→4→n so that the first tokens come no later; tokens past an
    in-burst EOS are discarded. Under greedy decoding the tokens do not
    depend on it."""
    global proposed, accepted
    if input_ids.shape[0] != 1:
        raise ValueError(f"streaming path is single-sequence, got batch {input_ids.shape[0]}")
    speculate = lookahead > 0 and sampling.temperature <= 0.0
    cache_len = _cache_len(input_ids.shape[1], images, cfg, sampling.max_new_tokens, lookahead)
    fixed, graphs = burst_cache(model, cfg, 1, cache_len, input_ids)
    logits, cache, _ = prefill(model, input_ids, images, patch_valid, cfg, cache_len,
                               cache=fixed)
    if speculate:
        # Image sentinels (< 0) are placeholders, not vocabulary: keep them
        # out of the lookup history (an n-gram crossing one is meaningless).
        history = LookupHistory(t for t in input_ids[0].tolist() if t >= 0)
        budget = sampling.max_new_tokens
        tok = int(torch.argmax(logits, dim=-1)[0])
        # `tok` is pending: emitted to the caller, not yet in the cache.
        if tok == sampling.eos_token_id:
            return
        yield tok
        history.append(tok)
        budget -= 1
        S = lookahead + 1
        while budget > 0:
            prop = history.propose(lookahead)
            if prop is None:
                prop = np.zeros((0,), np.int64)
            n_prop = len(prop)
            toks = np.full((1, S), cfg.decoder.pad_token_id, np.int64)
            toks[0, 0] = tok
            toks[0, 1 : 1 + n_prop] = prop
            valid = np.zeros((1, S), bool)
            valid[0, : 1 + n_prop] = True
            base_len = cache["length"].clone()  # the verify advances it in place
            greedy = verify_step(model, cache, torch.from_numpy(toks), torch.from_numpy(valid),
                                 cfg, graphs)[0][0].tolist()  # the verify's one copy to the host
            n_ok = 0
            while n_ok < n_prop and greedy[n_ok] == prop[n_ok]:
                n_ok += 1
            proposed += n_prop
            accepted += n_ok
            emitted = [int(t) for t in prop[:n_ok]] + [int(greedy[n_ok])]
            # Roll back to the accepted prefix: `tok` and the accepted
            # proposals are real cache rows; the new pending token is not.
            cache["length"].copy_(base_len + 1 + n_ok)
            for t in emitted[:budget]:
                if t == sampling.eos_token_id:
                    return
                yield t
                history.append(t)
            budget -= len(emitted[:budget])
            tok = emitted[-1] if budget > 0 else None
        return
    # Bursts of decode steps (bursts of one when multi_step is 1).
    token = _sample(logits, generator, sampling)
    tok = int(token[0])
    if tok == sampling.eos_token_id:
        return
    yield tok
    remaining = sampling.max_new_tokens - 1
    ramp = [1, 2, 4]
    while remaining > 0:
        n = min(ramp.pop(0) if ramp else multi_step, multi_step, remaining)
        toks, cache, token = decode_multi_step(model, cache, token, generator, cfg,
                                               sampling, n, graphs)
        for t in toks[:, 0].tolist():  # the burst's one copy to the host
            if t == sampling.eos_token_id:
                return
            yield t
            remaining -= 1
