"""Autoregressive generation: multimodal prefill + dense KV-cache decode.

Port of `vis_zephyr_tpu/serve/generate.py` for the single-request path:
`SamplingConfig`, `pad_to_bucket`, `_sample` (greedy, temperature, top-p),
`prefill`, `decode_step`, `generate` and `generate_stream`'s plain
single-step loop. PyTorch runs eagerly, so each decode step is one Python
call over the layer stack. Lookahead, multi-step bursts, grammars, logprobs,
penalties and beams are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from vis_zephyr_tpu.config import VisZephyrConfig

from ..models.mistral import embed, init_cache, mistral_forward
from ..models.vis_zephyr import VisZephyr, vis_zephyr_forward


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


def _cache_len(T: int, images, cfg: VisZephyrConfig, max_new_tokens: int) -> int:
    n_img = 0 if images is None else (images.shape[1] * cfg.tokens_per_patch
                                      + cfg.max_extra_merge_tokens())
    return pad_to_bucket(T + n_img + max_new_tokens)


@torch.no_grad()
def prefill(
    model: VisZephyr,
    input_ids: torch.Tensor,
    images: Optional[torch.Tensor],
    patch_valid: Optional[torch.Tensor],
    cfg: VisZephyrConfig,
    cache_len: int,
    text_valid: Optional[torch.Tensor] = None,
    use_flash: Optional[bool] = None,
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
        use_flash=use_flash,
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
    pallas_cache: bool = True,
) -> Tuple[torch.Tensor, Dict]:
    """One decode step; the cache is updated in place. Returns (logits
    [B, V], cache). `pallas_cache=False` appends with K2's plain version
    instead of the kernel."""
    positions = cache["length"][:, None]
    embeds = embed(model.decoder, token[:, None])
    logits, new_cache = mistral_forward(
        model.decoder, embeds, cfg.decoder, positions,
        cache=cache, logits_slice="last", pallas_cache_update=pallas_cache,
    )
    return logits[:, 0], new_cache


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
) -> Iterator[int]:
    """Single-sequence streaming generation: yields token ids until EOS or
    the budget is exhausted, one decode step per token."""
    if input_ids.shape[0] != 1:
        raise ValueError(f"streaming path is single-sequence, got batch {input_ids.shape[0]}")
    cache_len = _cache_len(input_ids.shape[1], images, cfg, sampling.max_new_tokens)
    logits, cache, _ = prefill(model, input_ids, images, patch_valid, cfg, cache_len)
    token = None
    for _ in range(sampling.max_new_tokens):
        if token is not None:
            logits, cache = decode_step(model, cache, token, cfg)
        token = _sample(logits, generator, sampling)
        tok = int(token[0])
        if tok == sampling.eos_token_id:
            return
        yield tok
