"""Autoregressive generation: multimodal prefill + dense KV-cache decode.

Port of `vis_zephyr_tpu/serve/generate.py` for the single-request path:
`SamplingConfig`, `pad_to_bucket`, `_sample` (greedy, temperature, top-p),
`prefill`, `decode_step`, `decode_verify`, `_propose_lookup`, `generate` and
`generate_stream`'s single-step loop and its prompt-lookup speculative loop
(`lookahead`). PyTorch runs eagerly, so each decode step is one Python call
over the layer stack. Multi-step bursts, grammars, logprobs, penalties and
beams are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..config import VisZephyrConfig

from ..models.mistral import embed, init_cache, mistral_forward
from ..models.vis_zephyr import VisZephyr, vis_zephyr_forward

# Speculation counts of the dense path in this process (reset by callers that
# count): verify calls, tokens proposed, proposals accepted.
verify_calls = 0
proposed = 0
accepted = 0


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
) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
    """Run the multimodal prefill; the per-layer K/V it returns are copied
    into a fresh decode cache of `cache_len` slots. On a CUDA device the
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
    cache = init_cache(cfg.decoder, B, cache_len, dtype=model.dtype, device=k.device)
    cache["k"][:, :, :T] = k
    cache["v"][:, :, :T] = v
    cache["length"] = lengths.to(torch.int32)
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
    after each row stops."""
    cache_len = _cache_len(input_ids.shape[1], images, cfg, sampling.max_new_tokens)
    last_logits, cache, _ = prefill(model, input_ids, images, patch_valid, cfg, cache_len,
                                    text_valid=text_valid)
    token = _sample(last_logits, generator, sampling)
    done = token == sampling.eos_token_id
    tokens = [token]
    for _ in range(sampling.max_new_tokens - 1):
        logits, cache = decode_step(model, cache, token, cfg)
        token = _sample(logits, generator, sampling)
        token = torch.where(done, sampling.eos_token_id, token)
        done = done | (token == sampling.eos_token_id)
        tokens.append(token)
    return torch.stack(tokens, dim=1).cpu().numpy()


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
) -> Iterator[int]:
    """Single-sequence streaming generation: yields token ids until EOS or
    the budget is exhausted, one decode step per token.

    `lookahead > 0` turns on prompt-lookup speculative decoding (greedy
    only; off when `sampling.temperature > 0`): up to `lookahead` tokens
    proposed from the sequence's own n-gram structure are verified in one
    multi-token cache append, with the same tokens as plain greedy decoding
    and fewer decoder passes."""
    global proposed, accepted
    if input_ids.shape[0] != 1:
        raise ValueError(f"streaming path is single-sequence, got batch {input_ids.shape[0]}")
    cache_len = _cache_len(input_ids.shape[1], images, cfg, sampling.max_new_tokens, lookahead)
    logits, cache, _ = prefill(model, input_ids, images, patch_valid, cfg, cache_len)
    if lookahead > 0 and sampling.temperature <= 0.0:
        # Image sentinels (< 0) are placeholders, not vocabulary: keep them
        # out of the lookup history (an n-gram crossing one is meaningless).
        history = [int(t) for t in input_ids[0].tolist() if t >= 0]
        budget = sampling.max_new_tokens
        tok = int(torch.argmax(logits, dim=-1)[0])
        # `tok` is pending: emitted to the caller, not yet in the cache.
        if tok == sampling.eos_token_id:
            return
        yield tok
        history.append(tok)
        budget -= 1
        S = lookahead + 1
        dev = input_ids.device
        while budget > 0:
            prop = _propose_lookup(np.asarray(history), span=lookahead)
            if prop is None:
                prop = np.zeros((0,), np.int64)
            n_prop = len(prop)
            toks = np.full((1, S), cfg.decoder.pad_token_id, np.int64)
            toks[0, 0] = tok
            toks[0, 1 : 1 + n_prop] = prop
            valid = np.zeros((1, S), bool)
            valid[0, : 1 + n_prop] = True
            base_len = cache["length"]
            logits, cache = decode_verify(model, cache, torch.as_tensor(toks, device=dev),
                                          torch.as_tensor(valid, device=dev), cfg)
            greedy = torch.argmax(logits[0], dim=-1).tolist()
            n_ok = 0
            while n_ok < n_prop and greedy[n_ok] == prop[n_ok]:
                n_ok += 1
            proposed += n_prop
            accepted += n_ok
            emitted = [int(t) for t in prop[:n_ok]] + [int(greedy[n_ok])]
            # Roll back to the accepted prefix: `tok` and the accepted
            # proposals are real cache rows; the new pending token is not.
            cache["length"] = base_len + 1 + n_ok
            for t in emitted[:budget]:
                if t == sampling.eos_token_id:
                    return
                yield t
                history.append(t)
            budget -= len(emitted[:budget])
            tok = emitted[-1] if budget > 0 else None
        return
    token = None
    for _ in range(sampling.max_new_tokens):
        if token is not None:
            logits, cache = decode_step(model, cache, token, cfg)
        token = _sample(logits, generator, sampling)
        tok = int(token[0])
        if tok == sampling.eos_token_id:
            return
        yield tok
