"""Autoregressive generation: multimodal prefill + dense KV-cache decode.

Port of `vis_zephyr_tpu/serve/generate.py` for the single-request path:
`SamplingConfig`, `pad_to_bucket`, `_sample` (greedy, temperature, top-p,
per-slot overrides), the batched steps' sampling operands
(`_sample_per_slot`, `LP_TOPK`, `_apply_penalties`, `_count_token`,
`_logprobs`, `_logprobs_host`), `prefill`, `decode_step`,
`decode_multi_step`, `decode_verify`, `_propose_lookup`, `generate` (its
decode loop is one burst) and `generate_stream`'s burst loop (bursts of
`multi_step` decode steps, of one by default), its prompt-lookup
speculative loop (`lookahead`) and its logprobs (`lp_sink`) and penalties.
On the card a burst of n steps replays one captured step n times
(`serve/graphs.py`) over the model's fixed decode cache for the batch
(`burst_cache`), where the JAX package compiles its step and `lax.scan`
once per bucket, and each speculative verify replays one captured verify
step over the same cache (`verify_step`); on the CPU, and inside
`_kernels.plain_versions()`, the eager `decode_step` and `decode_verify`
run.

A sampled token is drawn by the exponential race (`_draw`): the argmax of
p / E with E ~ Exp(1) from the step's generator, the categorical
distribution that `torch.multinomial` draws, without its host-side check
of the probabilities, so that a captured step replays the draw. The JAX
package draws through Gumbel noise: sampled tokens are the same
distribution, not the same bits.

Grammars (structured output, `serve/structured.py`): `_sample` drops the
tokens a bool `mask` [B, V] rules out before any selection, and
`generate_stream` masks every step with its grammar's row (single steps,
the state advanced on the host); on the card the row is copied into a fixed
buffer that the captured step reads.

Beam search (`beam_search`, `beam_hypotheses`; evaluation's `--num-beams`):
the JAX function's HF `BeamSearchScorer` semantics and host bookkeeping,
with the candidates ranked by the same numpy call. On the card each beam
step is a replay of one captured step (decode and the per-beam top-2K) over
`burst_cache`'s fixed K-row cache, into which the B = 1 prefill is expanded
and the parents' rows are reordered in place; on the CPU, and inside
`_kernels.plain_versions()`, the steps run eagerly on gathered caches, as
the JAX function's do.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..config import VisZephyrConfig

from ..models.mistral import embed, init_cache, mistral_forward
from ..models.vis_zephyr import VisZephyr, vis_zephyr_forward
from ..ops import _kernels
from .graphs import StepGraphs, addresses, grammar_key, mlora_key

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


def not_ported(what: str, step: str):
    """The error every left-out option raises: what it is and the ROADMAP
    entry that brings it."""
    return NotImplementedError(f"{what} is not ported to PyTorch yet (ROADMAP.md, {step})")


def _draw(probs: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One categorical draw a row, probs [B, V] → [B]: the exponential race
    argmax(p / E), E ~ Exp(1) from `generator` (what `torch.multinomial(probs,
    1)` computes, with no host sync, so a captured step replays it). E is
    kept above 0 so that a zero probability never wins."""
    e = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return torch.argmax(probs / e.clamp_(min=torch.finfo(probs.dtype).tiny), dim=-1)


def _top_p_cut(scaled: torch.Tensor, top_p) -> torch.Tensor:
    """-inf outside each row's nucleus: the smallest set of the sorted tokens
    whose cumulative probability reaches top_p (a float, or [B, 1])."""
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
    cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp_(max=scaled.shape[-1] - 1)
    cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
    return scaled.masked_fill(scaled < cutoff, float("-inf"))


def _sample(logits: torch.Tensor, generator: Optional[torch.Generator],
            sampling: SamplingConfig, overrides=None, mask=None) -> torch.Tensor:
    """logits [B, V] → token [B] (first maximum under greedy).

    `overrides`: optional (temps [B], top_ps [B]) per-slot parameters
    (`_sample_per_slot`), which take precedence over `sampling`'s scalars.
    `mask`: optional bool [B, V] grammar mask (`serve/structured.py`): the
    tokens it rules out are dropped before greedy OR sampled selection, so
    every emitted token keeps its row inside its grammar."""
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    if overrides is not None:
        return _sample_per_slot(logits, generator, overrides[0], overrides[1])
    if sampling.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / sampling.temperature
    if sampling.top_p < 1.0:
        logits = _top_p_cut(logits, sampling.top_p)
    return _draw(torch.softmax(logits, dim=-1), generator)


def _sample_per_slot(logits: torch.Tensor, generator: Optional[torch.Generator],
                     temps: torch.Tensor, top_ps: torch.Tensor) -> torch.Tensor:
    """Per-row sampling: logits [B, V], temps / top_ps [B] → token [B]. Row b
    is greedy (its first maximum) where temps[b] <= 0, else drawn from its
    own nucleus at its own temperature. Fixed-shape: every row is scaled,
    cut and drawn, and `torch.where` picks, so a captured step never
    branches on the data."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    sampled = _draw(torch.softmax(_top_p_cut(scaled, top_ps[:, None]), dim=-1), generator)
    return torch.where(temps <= 0.0, greedy, sampled)


# OpenAI caps `top_logprobs` at 20; one static K keeps a single captured step
# (requests asking for fewer slice on the host).
LP_TOPK = 20


def _apply_penalties(logits: torch.Tensor, counts: torch.Tensor, freq: torch.Tensor,
                     pres: torch.Tensor) -> torch.Tensor:
    """OpenAI frequency / presence penalties over OUTPUT tokens (the vLLM
    convention): logits [B, V], counts [B, V] (per-slot emitted-token
    counts), freq / pres [B] → penalized logits."""
    return logits - freq[:, None] * counts - pres[:, None] * (counts > 0).to(logits.dtype)


def _count_token(counts: torch.Tensor, token: torch.Tensor,
                 active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Record this step's token per active slot (every slot when `active` is
    None): counts [B, V] f32 gains one at (b, token[b]), IN PLACE. Returns
    counts."""
    rows = torch.arange(counts.shape[0], device=counts.device)
    add = (torch.ones_like(token, dtype=counts.dtype) if active is None
           else active.to(counts.dtype))
    return counts.index_put_((rows, token), add, accumulate=True)


def _logprobs(logits: torch.Tensor, token: torch.Tensor):
    """Per-token logprobs from the RAW model distribution (f32 log-softmax of
    the unscaled logits: before temperature, top-p and penalties, the OpenAI
    convention): logits [B, V], token [B] → (chosen [B], top_ids [B, LP_TOPK]
    int32, top_lps [B, LP_TOPK])."""
    lsm = torch.log_softmax(logits.float(), dim=-1)
    chosen = torch.gather(lsm, -1, token[:, None].long())[:, 0]
    top_lps, top_ids = torch.topk(lsm, LP_TOPK, dim=-1)
    return chosen, top_ids.to(torch.int32), top_lps


def _logprobs_host(logits_row: np.ndarray, token: int):
    """numpy twin of `_logprobs` for one row (first tokens, sampled from the
    admission logits)."""
    x = np.asarray(logits_row, np.float32)
    lsm = x - (np.max(x) + np.log(np.sum(np.exp(x - np.max(x)))))
    top = np.argpartition(-lsm, LP_TOPK)[:LP_TOPK]
    top = top[np.argsort(-lsm[top])]
    return float(lsm[token]), top.astype(np.int32), lsm[top]


def _sample_tail(logits: torch.Tensor, generator: Optional[torch.Generator],
                 sampling: SamplingConfig, active: Optional[torch.Tensor] = None,
                 pad_id: int = 0, overrides=None, penalties=None,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A decode step's sampling, the JAX steps' tail: logits [B, V] f32 →
    next token [B]. Penalties (freq [B], pres [B], counts [B, V]) shape the
    sampled logits, then the grammar `mask` [B, V] bool drops tokens; rows
    not `active` take `pad_id`; the counts gain the active rows' tokens in
    place."""
    if penalties is not None:
        logits = _apply_penalties(logits, penalties[2], penalties[0], penalties[1])
    token = _sample(logits, generator, sampling, overrides=overrides, mask=mask)
    if active is not None:
        token = torch.where(active, token, torch.full_like(token, pad_id))
    if penalties is not None:
        _count_token(penalties[2], token, active)
    return token


def weight_form(model: VisZephyr) -> str:
    """The decoder's weight form as a captured step's key names it: the
    class of its first projection (`Linear`, `QuantLinear`, `QuantLinear4`)."""
    return type(model.decoder.model.layers[0].self_attn.q_proj).__name__


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
    device the spliced length is padded to a multiple of 128, the flash
    kernel's tile; a text-only prompt too (pad tokens invalid), as the
    batchers' admission pads it (`batching._prefill_kv`).

    Returns (last_logits [B, V] f32, cache, lengths [B])."""
    B = input_ids.shape[0]
    pad_mult = 128 if input_ids.device.type == "cuda" else None
    if images is None and pad_mult and input_ids.shape[1] % pad_mult:
        pad = (-input_ids.shape[1]) % pad_mult
        valid = (torch.ones(input_ids.shape, dtype=torch.bool, device=input_ids.device)
                 if text_valid is None else text_valid.bool())
        input_ids = torch.nn.functional.pad(input_ids, (0, pad), value=cfg.decoder.pad_token_id)
        text_valid = torch.nn.functional.pad(valid, (0, pad))
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
    mlora=None,
    adapter_idx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict]:
    """One decode step; the cache is updated in place. `mlora` /
    `adapter_idx`: each row's multi-LoRA adapter (`mistral_forward`).
    Returns (logits [B, V], cache)."""
    positions = cache["length"][:, None]
    embeds = embed(model.decoder, token[:, None])
    logits, new_cache = mistral_forward(
        model.decoder, embeds, cfg.decoder, positions,
        cache=cache, logits_slice="last", mlora=mlora, adapter_idx=adapter_idx,
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
    overrides=None,
    penalties=None,
    lp_out=None,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
    """`n` chained `decode_step`s with sampling (the serialized path's
    multi-step burst): step j decodes the token step j − 1 sampled. Returns
    (toks [n, B] on the device, cache, last token); the caller copies toks
    to the host once and discards tokens past an EOS (the cache's rows past
    it are never read: the next request's prefill resets `length`).

    The sampling operands (`_sample_tail`): `overrides` (temps [B], top_ps
    [B]), `penalties` (freq [B], pres [B], counts [B, V] f32, counted in
    place), `lp_out`, three tensors [n, B], [n, B, LP_TOPK] int32,
    [n, B, LP_TOPK] that take step j's `_logprobs` at row j, and `mask`, a
    grammar mask [B, V] bool (its rows are rewritten between steps, so a
    masked burst is one step); each is a fixed buffer that a captured step
    reads or writes, and a masked step is its own capture.

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
    graphed = _kernels.use_kernel(token)
    if graphed and graphs is None:
        graphs = StepGraphs()
    buf = (graphs.buffers(("token", B), lambda: torch.empty(B, dtype=torch.int64, device=dev))
           if graphed else torch.empty_like(token))
    if token is not buf:
        buf.copy_(token)

    def step():
        logits = decode_step(model, cache, buf, cfg)[0]
        nxt = _sample_tail(logits, generator, sampling, overrides=overrides,
                           penalties=penalties, mask=mask)
        buf.copy_(nxt)
        return None if lp_out is None else _logprobs(logits, nxt)

    # The step reads the sampler's temperature and top-p and its operands'
    # buffers, not the budget.
    key = ("decode", B, weight_form(model), sampling.temperature, sampling.top_p, generator,
           lp_out is not None, *addresses(cache["k"], cache["v"], cache["length"],
                                          *(overrides or (None, None)),
                                          *(penalties or (None, None, None))),
           *grammar_key(mask))
    for j in range(n):
        lp = graphs.run(key, step, dev, generator) if graphed else step()
        toks[j].copy_(buf)
        if lp_out is not None:
            for out, got in zip(lp_out, lp):
                out[j].copy_(got)
    return toks, cache, buf


@torch.no_grad()
def decode_verify(
    model: VisZephyr,
    cache: Dict,
    tokens: torch.Tensor,  # [B, S]
    valid: torch.Tensor,   # [B, S] bool: padded proposal slots are False
    cfg: VisZephyrConfig,
    mlora=None,
    adapter_idx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict]:
    """Speculative verify: append S tokens (the pending accepted token plus
    S − 1 proposed) in ONE cached forward (K2 writes the S rows of each
    layer) and return per-position logits [B, S, V] f32. The caller rolls
    `cache["length"]` back to the accepted prefix; rejected rows hold K/V
    that the next append overwrites (attention masks keys off `length`).
    `mlora` / `adapter_idx`: each row's multi-LoRA adapter."""
    global verify_calls
    positions = cache["length"][:, None] + torch.cumsum(valid.to(torch.int32), dim=1) - 1
    embeds = embed(model.decoder, tokens)
    logits, new_cache = mistral_forward(
        model.decoder, embeds, cfg.decoder, positions,
        attn_valid=valid, cache=cache, logits_slice="all", mlora=mlora,
        adapter_idx=adapter_idx,
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
    mlora=None,
    adapter_idx: Optional[torch.Tensor] = None,
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
    `decode_verify` runs eagerly. `mlora` / `adapter_idx`: each row's
    multi-LoRA adapter, `adapter_idx` a fixed device buffer that the
    captured step reads (the continuous batcher's `slot_adapter`)."""
    length = cache["length"]
    dev = length.device
    if not _kernels.use_kernel(length):
        logits, _ = decode_verify(model, cache, tokens.to(dev), valid.to(dev), cfg, mlora,
                                  adapter_idx)
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
        logits = decode_verify(model, cache, tok_buf, valid_buf, cfg, mlora, adapter_idx)[0]
        return torch.argmax(logits, dim=-1), logits

    key = ("verify", B, S, *mlora_key(mlora, adapter_idx),
           *addresses(cache["k"], cache["v"], cache["length"]))
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


def _beam_expand(cache: Dict, n: int, rows: Optional[int] = None) -> Dict:
    """B = 1 prefill cache → n identical beams. Without `rows`, a new cache:
    K / V repeated on the batch axis, lengths broadcast (the JAX function).
    With `rows`, in place in an n-row cache whose row 0 holds the prefill
    (`burst_cache`'s, which a captured step reads at fixed addresses): row
    0's first `rows` slots and its length are copied into rows 1 to n − 1
    (slots past the length are never attended)."""
    if rows is None:
        return {"k": cache["k"].repeat_interleave(n, dim=1),
                "v": cache["v"].repeat_interleave(n, dim=1),
                "length": cache["length"].repeat_interleave(n, dim=0)}
    for name in ("k", "v"):
        t = cache[name][:, :, :rows]
        t[:, 1:].copy_(t[:, :1].expand_as(t[:, 1:]))
    cache["length"][1:].copy_(cache["length"][:1].expand(n - 1))
    return cache


def _beam_reorder(cache: Dict, beam_idx: List[int], rows: Optional[int] = None) -> Dict:
    """Continue beam b from its parent `beam_idx[b]`'s cache row. Without
    `rows`, a new cache gathered on the batch axis (the JAX function). With
    `rows`, in place in the fixed cache: the beams whose parent is another row
    take the parent's first `rows` slots and length (every beam has the same
    length, and no slot past it is attended)."""
    dev = cache["length"].device
    if rows is None:
        idx = torch.tensor(beam_idx, dtype=torch.int64, device=dev)
        return {"k": cache["k"].index_select(1, idx), "v": cache["v"].index_select(1, idx),
                "length": cache["length"].index_select(0, idx)}
    moved = [b for b, parent in enumerate(beam_idx) if parent != b]
    if moved:
        dst = torch.tensor(moved, dtype=torch.int64, device=dev)
        src = torch.tensor([beam_idx[b] for b in moved], dtype=torch.int64, device=dev)
        for name in ("k", "v"):
            t = cache[name][:, :, :rows]
            t.index_copy_(1, dst, t.index_select(1, src))
        cache["length"].index_copy_(0, dst, cache["length"].index_select(0, src))
    return cache


def _beam_topk(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-beam log-softmax top-2k candidates (the HF beam-search pool: 2k
    lets EOS candidates retire without starving the k live beams), in
    `lax.top_k`'s order: by value, the lower token id first among equal
    values (a stable descending sort)."""
    lsm = torch.log_softmax(logits.float(), dim=-1)
    vals, ids = torch.sort(lsm, dim=-1, descending=True, stable=True)
    return vals[:, :2 * k], ids[:, :2 * k]


@torch.no_grad()
def beam_hypotheses(
    model: VisZephyr,
    input_ids: torch.Tensor,
    images: Optional[torch.Tensor],
    patch_valid: Optional[torch.Tensor],
    cfg: VisZephyrConfig,
    num_beams: int = 4,
    max_new_tokens: int = 64,
    eos_token_id: int = 2,
    length_penalty: float = 1.0,
    cache_len: Optional[int] = None,
    eager: bool = False,
    stats: Optional[Dict] = None,
) -> List[Tuple[float, List[int]]]:
    """HF-semantics beam search (the reference's `num_beams > 1` path, `model.
    generate` via HF `BeamSearchScorer`; the JAX `beam_search`): `num_beams`
    live hypotheses; each step ranks the 2k best (beam, token) continuations,
    retires EOS candidates to the finished pool scored `logprob_sum /
    len**length_penalty`, and keeps the k best live. Returns the finished
    pool, best first: (normalized score, new token ids without EOS).

    On a CUDA tensor (outside `_kernels.plain_versions()`, and unless
    `eager`) the beams live in `burst_cache`'s fixed K-row cache: the B = 1
    prefill writes its row 0, `_beam_expand` copies it into the others, each
    step replays one captured step (decode and `_beam_topk` into fixed
    outputs) and `_beam_reorder` moves the parents' rows in place. Elsewhere,
    and with `eager`, the steps run eagerly on a fresh cache gathered anew
    each step. Greedy ties aside, both give the same hypotheses; on one cache
    shape (`cache_len`) the same bits. `stats`, when given, counts the decode
    steps (`steps`) and gathers the host seconds of each step that goes on
    to the next (`step_s`: the decode, the top-2K's copy to the host, the
    ranking and the reorder)."""
    if input_ids.shape[0] != 1:
        raise ValueError(f"beam search takes one prompt, got batch {input_ids.shape[0]}")
    K = num_beams
    if cache_len is None:
        cache_len = _cache_len(input_ids.shape[1], images, cfg, max_new_tokens)
    dev = input_ids.device
    fixed, graphs = (None, None) if eager else burst_cache(model, cfg, K, cache_len, input_ids)
    if fixed is None:
        last_logits, cache, lengths = prefill(model, input_ids, images, patch_valid, cfg,
                                              cache_len)
        cache = _beam_expand(cache, K)
    else:
        row0 = {"k": fixed["k"][:, :1], "v": fixed["v"][:, :1], "length": fixed["length"][:1]}
        last_logits, _, lengths = prefill(model, input_ids, images, patch_valid, cfg, cache_len,
                                          cache=row0)
        cache = _beam_expand(fixed, K, rows=int(lengths[0]))
    length = int(lengths[0])  # every beam's, advanced by each step

    # First expansion from the shared prefix: draw from a 2K candidate
    # pool like every later step (HF BeamSearchScorer semantics) — an EOS
    # among the top K retires to the finished pool WITHOUT consuming one
    # of the K live beam slots.
    lsm0 = torch.log_softmax(last_logits[0].float(), dim=-1)
    pool0 = min(2 * K, lsm0.shape[-1])
    vals0, ids0 = (t[:pool0].cpu().numpy()
                   for t in torch.sort(lsm0, descending=True, stable=True))
    finished: List[tuple] = []                   # (normalized score, seq)

    def norm(s: float, length: int) -> float:
        return s / (max(length, 1) ** length_penalty)

    live: List[tuple] = []                       # (logprob sum, token)
    for v, t in zip(vals0, ids0):
        if int(t) == eos_token_id:
            # The prompt's best continuation is to end immediately.
            finished.append((norm(float(v), 1), []))
        elif len(live) < K:
            live.append((float(v), int(t)))
    while len(live) < K:  # degenerate tiny-vocab case: pad with dead beams
        live.append((-1e30, live[0][1] if live else 0))
    scores = np.asarray([v for v, _ in live], np.float64)
    seqs: List[List[int]] = [[t] for _, t in live]
    tokens = np.asarray([t for _, t in live], np.int64)

    if fixed is not None:
        tok_buf = graphs.buffers(("beam", K), lambda: torch.zeros(K, dtype=torch.int64,
                                                                  device=dev))

        def step():
            return _beam_topk(decode_step(model, cache, tok_buf, cfg)[0], K)

        key = ("beam", K, weight_form(model),
               *addresses(cache["k"], cache["v"], cache["length"]))
    for _ in range(max_new_tokens - 1):
        if all(s and s[-1] == eos_token_id for s in seqs):
            break
        t0 = time.perf_counter()
        if fixed is None:
            logits, cache = decode_step(model, cache, torch.from_numpy(tokens).to(dev), cfg)
            vals, ids = _beam_topk(logits, K)
        else:
            tok_buf.copy_(torch.from_numpy(tokens))
            vals, ids = graphs.run(key, step, dev)
        length += 1
        if stats is not None:
            stats["steps"] = stats.get("steps", 0) + 1
        vals, ids = vals.cpu().numpy(), ids.cpu().numpy()
        cand = scores[:, None] + vals            # [K, 2K]
        order = np.argsort(-cand, axis=None)
        next_beams: List[tuple] = []             # (parent, token, score)
        for flat in order:
            b, j = divmod(int(flat), 2 * K)
            if seqs[b] and seqs[b][-1] == eos_token_id:
                continue                         # parent already retired
            tok = int(ids[b, j])
            if tok == eos_token_id:
                finished.append((norm(float(cand[b, j]), len(seqs[b])),
                                 list(seqs[b])))
                continue
            next_beams.append((b, tok, float(cand[b, j])))
            if len(next_beams) == K:
                break
        if not next_beams:
            break                                # every continuation ended
        # Early stop (HF early_stopping=False heuristic): no live beam can
        # beat the worst kept finished hypothesis.
        if len(finished) >= K:
            worst_kept = sorted(finished, reverse=True)[K - 1][0]
            best_live = norm(next_beams[0][2], len(seqs[next_beams[0][0]]) + 1)
            if best_live < worst_kept:
                break
        beam_idx = [b for b, _, _ in next_beams]
        tokens = np.asarray([t for _, t, _ in next_beams], np.int64)
        scores = np.asarray([s for _, _, s in next_beams], np.float64)
        seqs = [seqs[b] + [t] for b, t, _ in next_beams]
        cache = _beam_reorder(cache, beam_idx, rows=None if fixed is None else length)
        if stats is not None:
            stats.setdefault("step_s", []).append(time.perf_counter() - t0)

    for s, seq in zip(scores, seqs):
        if not (seq and seq[-1] == eos_token_id):
            finished.append((norm(float(s), len(seq)), list(seq)))
    finished.sort(key=lambda x: -x[0])
    return finished


def beam_search(model: VisZephyr, input_ids: torch.Tensor, images: Optional[torch.Tensor],
                patch_valid: Optional[torch.Tensor], cfg: VisZephyrConfig, num_beams: int = 4,
                max_new_tokens: int = 64, eos_token_id: int = 2, length_penalty: float = 1.0,
                cache_len: Optional[int] = None) -> List[int]:
    """The best hypothesis of `beam_hypotheses`: its new token ids, EOS
    excluded (the JAX `beam_search`)."""
    return beam_hypotheses(model, input_ids, images, patch_valid, cfg, num_beams=num_beams,
                           max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
                           length_penalty=length_penalty, cache_len=cache_len)[0][1]


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
    grammar=None,
    lp_sink: Optional[list] = None,
    penalties: Optional[Tuple[float, float]] = None,
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
    depend on it.

    `lp_sink`: when not None, one `(chosen_lp, top_ids, top_lps)` entry
    (`_logprobs`, the raw distribution) is appended per yielded token, before
    it is yielded. `penalties`: optional (frequency_penalty,
    presence_penalty) over this stream's emitted tokens. `grammar` (a
    `serve/structured.py::TokenGrammar`): every step masks the logits to the
    tokens legal from the grammar's current state (`grammar.mask[state]`),
    which advances on the host. Each of the three turns speculation and
    bursts off, as in the JAX function (their steps need the host between
    tokens); on the card their counts, outputs and mask row are the
    captured step's fixed buffers."""
    global proposed, accepted
    if input_ids.shape[0] != 1:
        raise ValueError(f"streaming path is single-sequence, got batch {input_ids.shape[0]}")
    if grammar is not None or lp_sink is not None or penalties is not None:
        lookahead, multi_step = 0, 1
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
    if sampling.max_new_tokens <= 0:
        return  # a zero budget yields no token, as the JAX function's step loop
    # Bursts of decode steps (bursts of one when multi_step is 1).
    dev, V = logits.device, cfg.decoder.vocab_size
    gstate = 0
    table = None if grammar is None else grammar.mask_on(dev)
    token = _sample(logits, generator, sampling, mask=None if table is None else table[:1])
    tok = int(token[0])
    if tok == sampling.eos_token_id:
        return
    if grammar is not None:
        gstate = grammar.advance(gstate, tok)
    if lp_sink is not None:
        chosen, ids, lps = (t.cpu().numpy() for t in _logprobs(logits, token))
        lp_sink.append((float(chosen[0]), ids[0], lps[0]))
    yield tok

    def fixed(key, make):  # a captured step's buffers outlive the request
        return make() if graphs is None else graphs.buffers(key, make)

    pen = lp_out = mask = None
    if grammar is not None:
        mask = fixed(("grammar", 1), lambda: torch.zeros((1, V), dtype=torch.bool, device=dev))
    if penalties is not None:
        pen = fixed(("penalties", 1), lambda: (
            torch.zeros(1, device=dev), torch.zeros(1, device=dev),
            torch.zeros((1, V), device=dev)))
        pen[0].fill_(float(penalties[0]))
        pen[1].fill_(float(penalties[1]))
        pen[2].zero_()
        pen[2][0, tok] = 1.0
    if lp_sink is not None:
        lp_out = fixed(("logprobs", 1, 1), lambda: (
            torch.zeros((1, 1), device=dev),
            torch.zeros((1, 1, LP_TOPK), dtype=torch.int32, device=dev),
            torch.zeros((1, 1, LP_TOPK), device=dev)))
    remaining = sampling.max_new_tokens - 1
    ramp = [1, 2, 4]
    while remaining > 0:
        n = min(ramp.pop(0) if ramp else multi_step, multi_step, remaining)
        if mask is not None:
            mask[0].copy_(table[gstate])
        toks, cache, token = decode_multi_step(model, cache, token, generator, cfg,
                                               sampling, n, graphs, penalties=pen,
                                               lp_out=lp_out, mask=mask)
        lp_host = None if lp_out is None else [t.cpu().numpy().copy() for t in lp_out]
        for j, t in enumerate(toks[:, 0].tolist()):  # the burst's one copy to the host
            if t == sampling.eos_token_id:
                return
            if grammar is not None:
                gstate = grammar.advance(gstate, t)
            if lp_host is not None:
                lp_sink.append((float(lp_host[0][j, 0]), lp_host[1][j, 0], lp_host[2][j, 0]))
            yield t
            remaining -= 1
