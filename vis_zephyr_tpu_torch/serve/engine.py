"""ChatEngine: session/conversation state + streaming generation for the CLI
and the HTTP server.

Port of `vis_zephyr_tpu/serve/engine.py`. Two modes:

- the default: serialized generation (one request decodes at a time, under a
  lock) over a dense KV cache;
- `continuous_batching=True`: requests of different sessions share decode
  steps in a `ContinuousBatcher` over one dense cache (`kv_cache="dense"`,
  the default) or a `PagedBatcher` (`kv_cache="paged"`), advanced by one
  background pump thread.

`lookahead` (prompt-lookup speculation, greedy only) and `multi_step`
(bursts of decode steps, replayed as CUDA graphs on the card; ignored under
`lookahead`) reach every mode; a draft model (`draft_model`, `draft_cfg`:
`serve/draft.py::DraftModel`) proposes for both batchers under
`lookahead`. A session's image is preprocessed once and kept on the device.
`generate_request` is the session-free entry of the OpenAI endpoints
(`serve/openai_api.py`): per-request budget, temperature, top-p, logprobs
and penalties on every mode. `metrics` (a `ServingMetrics`) is what GET
/metrics reads; the batchers record into it. `drain` refuses new requests
(`EngineDraining`) and waits for those in flight. The paged batcher's
prefix cache (`prefix_cache`) and lazy allocation with host swap
(`lazy_alloc`, paged continuous batching only) reach it from here, as
multi-LoRA serving does (`mlora`, `adapter_names`: either batcher; `chat`'s
and `generate_request`'s `adapter` names a request's adapter, and the
serialized path refuses any but the base with the JAX `ValueError`). Not
ported yet, each raising `NotImplementedError` when asked for: meshes and
grammars.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..config import VisZephyrConfig
from ..constants import DEFAULT_IMAGE_TOKEN
from ..conversation import templates
from ..data import anyres
from ..data.tokenization import tokenize_with_images

from ..data.image_pipeline import anyres_preprocess_host, preprocess_mode_host
from ..models.vis_zephyr import VisZephyr
from .batching import ContinuousBatcher, not_ported
from .generate import SamplingConfig, generate_stream


class EngineDraining(RuntimeError):
    """Raised for NEW requests while the engine is draining for shutdown
    (in-flight requests run to completion); the HTTP layer maps it to
    503."""


class ChatEngine:
    def __init__(
        self,
        model: VisZephyr,
        cfg: VisZephyrConfig,
        tokenizer,
        conv_mode: str = "zephyr_v1",
        temperature: float = 0.0,
        max_new_tokens: int = 512,
        continuous_batching: bool = False,
        max_slots: int = 8,
        cache_len: int = 2048,
        kv_cache: str = "dense",  # "dense" | "paged"
        kv_quant: bool = False,
        num_pages: Optional[int] = None,
        mesh=None,
        metrics=None,
        prefill_chunk: Optional[int] = None,
        lookahead: int = 0,
        draft_model=None,
        draft_cfg=None,
        multi_step: int = 1,
        kv_fused: bool = False,
        prefix_cache: bool = False,
        page_size: int = 128,
        mlora=None,
        adapter_names=None,
        lazy_alloc: bool = False,
    ):
        self.model = model
        self.cfg = cfg
        self.metrics = metrics
        self.tokenizer = tokenizer
        self.conv_mode = conv_mode
        self.device = model.device
        # Prefer the tokenizer's EOS id (custom tokenizers may disagree with
        # the model config; for Zephyr both are 2).
        eos = getattr(tokenizer, "eos_token_id", None)
        self.sampling = SamplingConfig(
            max_new_tokens=max_new_tokens,
            temperature=temperature,
            eos_token_id=cfg.decoder.eos_token_id if eos is None else int(eos),
        )
        # Prompt-lookup speculation and multi-step bursts: the serialized
        # path and the paged batcher.
        self.lookahead = lookahead
        self.multi_step = max(1, int(multi_step))
        self.sessions: Dict[str, Dict] = {}
        self._sessions_lock = threading.Lock()
        self._lock = threading.Lock()  # one generation at a time
        self._draining = False
        self._inflight = 0
        self._inflight_lock = threading.Lock()

        # Optional continuous batching: concurrent requests share decode
        # steps instead of serializing on the lock.
        self.batcher = None
        self._pump = None
        self._pump_stop = False
        self._pump_lock = threading.Lock()
        if kv_cache not in ("dense", "paged"):
            raise ValueError(f"kv_cache must be 'dense' or 'paged', got {kv_cache!r}")
        if lazy_alloc and (not continuous_batching or kv_cache != "paged"):
            raise ValueError("lazy_alloc requires continuous batching with kv_cache='paged'")
        if continuous_batching:
            draft = None
            if draft_model is not None and lookahead > 0:
                from .draft import DraftModel

                # The draft's own dense cache proposes for every slot,
                # whatever the target's cache layout.
                draft = DraftModel(draft_model, draft_cfg, max_slots=max_slots,
                                   cache_len=cache_len)
            if kv_cache == "paged":
                from .paged import PagedBatcher

                self.batcher = PagedBatcher(
                    model, cfg, max_slots=max_slots, cache_len=cache_len,
                    sampling=self.sampling, num_pages=num_pages, mesh=mesh, metrics=metrics,
                    prefill_chunk=prefill_chunk, kv_quant=kv_quant, lookahead=lookahead,
                    draft=draft, multi_step=multi_step, kv_fused=kv_fused,
                    prefix_cache=prefix_cache, page_size=page_size, mlora=mlora,
                    adapter_names=adapter_names, lazy_alloc=lazy_alloc)
            else:
                self.batcher = ContinuousBatcher(
                    model, cfg, max_slots=max_slots, cache_len=cache_len,
                    sampling=self.sampling, mesh=mesh, metrics=metrics,
                    prefill_chunk=prefill_chunk, lookahead=lookahead, draft=draft,
                    multi_step=multi_step, mlora=mlora, adapter_names=adapter_names)
        else:
            # The serialized path records no metrics (as in the JAX engine:
            # the batchers do), takes no draft model (the server refuses
            # --draft-model without --continuous-batching) and, as in JAX,
            # ignores a pack: its requests refuse adapters.
            if mesh:
                raise not_ported("a device mesh", "Queue A step 13")

    def _ensure_pump(self) -> None:
        """Background thread advancing the batcher while work exists. Exactly
        ONE pump may run: the batcher updates its pools in place."""
        with self._pump_lock:
            if self._pump is not None and self._pump.is_alive():
                return

            def pump():
                idle = 0
                while not self._pump_stop:
                    if self.batcher.has_work:
                        idle = 0
                        self.batcher.step()
                        continue
                    idle += 1
                    time.sleep(0.001)
                    if idle >= 2000:  # ~2 s of no work → try to exit
                        # Decide under _pump_lock: a request submitted after
                        # the last has_work check would otherwise see a live
                        # pump in _ensure_pump and be orphaned when it dies.
                        with self._pump_lock:
                            if self.batcher.has_work:
                                idle = 0
                                continue
                            self._pump = None
                            return

            self._pump = threading.Thread(target=pump, daemon=True)
            self._pump.start()

    def close(self) -> None:
        """Stop the background pump and wait for it to exit. Call when
        retiring an engine while the process lives on: the pump idles ~2 s
        past the last request before exiting on its own."""
        self._pump_stop = True
        pump = self._pump
        if pump is not None and pump.is_alive():
            pump.join(timeout=30)
        if pump is not None and pump.is_alive():
            # Wedged pump: leave the stop flag SET so that it can never step
            # the pools again under a successor engine.
            warnings.warn("ChatEngine.close(): pump thread did not exit within 30s; "
                          "leaving stop flag set")
            return
        self._pump = None
        self._pump_stop = False

    # -- session management -------------------------------------------------

    def get_session(self, session_id: str) -> Dict:
        with self._sessions_lock:
            if session_id not in self.sessions:
                self.sessions[session_id] = {
                    "conversation": templates[self.conv_mode].copy(),
                    "images": None,
                    "patch_valid": None,
                    "image_size": None,
                    # Serializes same-session requests, which would otherwise
                    # interleave their turns in the prompt history.
                    "lock": threading.Lock(),
                }
            return self.sessions[session_id]

    def preprocess_image(self, pil_image):
        """Anyres/square preprocess → (pixels [P, S, S, 3], valid [P])."""
        if self.cfg.image_aspect_ratio == "anyres":
            return anyres_preprocess_host(pil_image, self.cfg.mm_grid_pinpoints,
                                          target_size=self.cfg.vision.image_size)
        one = preprocess_mode_host(pil_image, self.cfg.image_aspect_ratio,
                                   self.cfg.vision.image_size)
        pins = anyres.parse_grid_pinpoints(self.cfg.mm_grid_pinpoints)
        P = anyres.max_anyres_patches(pins, self.cfg.vision.image_size)
        pixels = np.zeros((P,) + one.shape, np.float32)
        pixels[0] = one
        return pixels, np.arange(P) < 1

    def attach_pixels(self, session_id: str, pixels: np.ndarray, valid: np.ndarray,
                      image_size) -> None:
        """Keep preprocessed pixels [P, S, S, 3] and their validity [P] on the
        device as the session's image."""
        sess = self.get_session(session_id)
        sess["images"] = torch.as_tensor(pixels, device=self.device)[None]
        sess["patch_valid"] = torch.as_tensor(valid, device=self.device)[None]
        sess["image_size"] = tuple(image_size)

    def attach_image(self, session_id: str, pil_image) -> None:
        """Preprocess and keep the session image (first request only)."""
        pixels, valid = self.preprocess_image(pil_image)
        self.attach_pixels(session_id, pixels, valid, pil_image.size)

    # -- generation ----------------------------------------------------------

    def prompt_ids(self, question: str, conv=None) -> list:
        """Append the user turn and an open assistant turn to `conv` (a fresh
        conversation of this engine's template when None) and return the
        prompt's token ids, the image sentinel standing for <image>."""
        if conv is None:
            conv = templates[self.conv_mode].copy()
        conv.append_message(conv.roles[0], question)
        conv.append_message(conv.roles[1], None)
        return tokenize_with_images(conv.get_prompt(), self.tokenizer)

    def chat(self, session_id: str, question: str, pil_image=None,
             adapter: Optional[str] = None) -> Iterator[str]:
        """Append the user turn, stream back the assistant reply text. The
        request is counted in flight at once (`EngineDraining` raises here
        while the engine drains), before the stream is first read.
        `adapter`: the request's multi-LoRA adapter name (continuous
        batching only; None or "base": the base model)."""
        self._admit_inflight()
        return self._chat_stream(session_id, question, pil_image, adapter)

    def _chat_stream(self, session_id: str, question: str, pil_image,
                     adapter: Optional[str]) -> Iterator[str]:
        try:
            sess = self.get_session(session_id)
            with sess["lock"]:
                yield from self._chat_locked(sess, session_id, question, pil_image, adapter)
        finally:
            self._release_inflight()

    def _chat_locked(self, sess, session_id: str, question: str, pil_image,
                     adapter: Optional[str] = None) -> Iterator[str]:
        if self.batcher is None:
            _refuse_serialized_adapter(adapter)  # before the turn is recorded
        conv = sess["conversation"]
        if pil_image is not None and sess["images"] is None:
            self.attach_image(session_id, pil_image)
            question = (DEFAULT_IMAGE_TOKEN + "\n"
                        + question.replace(DEFAULT_IMAGE_TOKEN, "").strip())

        ids = self.prompt_ids(question, conv)
        input_ids = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)[None]

        produced: list[int] = []
        emitted_text = ""
        if self.batcher is not None:
            images = sess["images"]
            handle = self.batcher.submit(
                np.asarray(ids, np.int64),
                None if images is None else images[0].cpu().numpy(),
                None if images is None else sess["patch_valid"][0].cpu().numpy(),
                adapter=adapter)
            self._ensure_pump()
            stream = self.batcher.stream(handle)
        else:
            self._lock.acquire()
            stream = generate_stream(self.model, input_ids, sess["images"],
                                     sess["patch_valid"], self.cfg, self.sampling,
                                     lookahead=self.lookahead, multi_step=self.multi_step)
        try:
            for tok in stream:
                produced.append(tok)
                text = self.tokenizer.decode(produced, skip_special_tokens=True)
                # Emit only the stable prefix delta (the last token may merge).
                delta = text[len(emitted_text):]
                if delta:
                    emitted_text = text
                    yield delta
        finally:
            if self.batcher is None:
                self._lock.release()
            # Record the (possibly partial) reply even when the consumer
            # closes the stream early: a None assistant turn would corrupt
            # the next turn's prompt.
            conv.messages[-1][1] = emitted_text

    def chat_text(self, session_id: str, question: str, pil_image=None,
                  adapter: Optional[str] = None) -> str:
        return "".join(self.chat(session_id, question, pil_image, adapter=adapter))

    def _admit_inflight(self) -> None:
        """Register a request EAGERLY and atomically with the draining
        check: a request accepted before `drain()` flips the flag is always
        counted, so `drain()` never reports idle while an accepted request
        has not started streaming yet."""
        with self._inflight_lock:
            if self._draining:
                raise EngineDraining("engine is draining; not accepting requests")
            self._inflight += 1

    def _release_inflight(self) -> None:
        with self._inflight_lock:
            self._inflight -= 1

    def _track(self, it: Iterator[int]) -> Iterator[int]:
        """Stream `it`, releasing this request's in-flight registration
        (taken eagerly by `_admit_inflight`) when the iterator is exhausted
        or closed."""
        try:
            yield from it
        finally:
            self._release_inflight()

    def drain(self, timeout: float = 120.0) -> bool:
        """Graceful shutdown, phase 1: refuse NEW requests (`chat` and
        `generate_request` raise `EngineDraining`; the HTTP layer maps it
        to 503) and wait for every in-flight request (streaming iterators
        and batcher slots) to finish, up to `timeout` seconds. Returns True
        when fully drained. Call `close()` afterwards to retire the pump."""
        self._draining = True
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            busy = self._inflight > 0 or (self.batcher is not None and self.batcher.has_work)
            if not busy:
                return True
            time.sleep(0.05)
        return False

    # -- stateless generation (the OpenAI endpoints) ---------------------------

    def token_strings(self) -> List[bytes]:
        """The raw bytes each vocabulary id contributes to decoded text (cached),
        for the logprobs' `bytes`."""
        if not hasattr(self, "_token_strings"):
            self._token_strings = token_strings_from_tokenizer(self.tokenizer,
                                                               self.cfg.decoder.vocab_size)
        return self._token_strings

    def token_bytes(self, tok: int) -> bytes:
        blobs = self.token_strings()
        return blobs[tok] if 0 <= tok < len(blobs) else b""

    def token_text(self, tok: int) -> str:
        # Lossy display form: a byte-fallback token may hold a partial UTF-8
        # sequence; `token_bytes` has the exact bytes.
        return self.token_bytes(tok).decode("utf-8", errors="replace")

    def generate_request(
        self,
        prompt: str,
        pil_image=None,
        max_new_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
        top_p: Optional[float] = None,
        adapter: Optional[str] = None,
        grammar=None,
        logprobs: Optional[int] = None,
        lp_sink: Optional[list] = None,
        frequency_penalty: float = 0.0,
        presence_penalty: float = 0.0,
    ) -> Iterator[int]:
        """Session-free generation from a fully rendered prompt: yields raw
        token ids until EOS or the budget. It drives /v1/chat/completions and
        /v1/completions, whose requests each carry their whole context.

        Per-request `max_new_tokens` / `temperature` / `top_p` override the
        engine's defaults; under continuous batching they apply per slot in
        the shared step (`generate._sample_per_slot`); a speculative batcher
        serves greedy only and ignores them. `logprobs` (top-N) with
        `lp_sink`: one `(chosen_lp, top_ids, top_lps)` entry a token,
        appended before the token is yielded. Submission is eager: under
        continuous batching the request is queued before this returns (so
        several calls decode together: the OpenAI `n`), and refusals raise
        here, `EngineDraining` too while the engine drains. `adapter`: the
        request's multi-LoRA adapter name (an unknown one raises `KeyError`;
        the serialized path refuses any but the base with `ValueError`).
        Grammars are not ported (Queue A step 10)."""
        if grammar is not None:
            raise not_ported("structured output (grammar)", "Queue A step 10")
        self._admit_inflight()
        try:
            return self._track(self._start_request(
                prompt, pil_image, max_new_tokens, temperature, top_p, logprobs, lp_sink,
                frequency_penalty, presence_penalty, adapter))
        except BaseException:
            self._release_inflight()  # refused before streaming started
            raise

    def _start_request(self, prompt, pil_image, max_new_tokens, temperature, top_p, logprobs,
                       lp_sink, frequency_penalty, presence_penalty,
                       adapter: Optional[str] = None) -> Iterator[int]:
        if self.batcher is None:
            _refuse_serialized_adapter(adapter)
        images = patch_valid = None
        if pil_image is not None:
            if DEFAULT_IMAGE_TOKEN not in prompt:
                prompt = DEFAULT_IMAGE_TOKEN + "\n" + prompt
            images, patch_valid = self.preprocess_image(pil_image)
        ids = np.asarray(tokenize_with_images(prompt, self.tokenizer), np.int64)
        if self.batcher is not None:
            handle = self.batcher.submit(
                ids, images, patch_valid, max_new_tokens=max_new_tokens,
                adapter=adapter, temperature=temperature, top_p=top_p, logprobs=logprobs,
                frequency_penalty=frequency_penalty, presence_penalty=presence_penalty)
            self._ensure_pump()
            return self._stream_handle(handle, logprobs, lp_sink)
        overrides = {name: value for name, value in (
            ("max_new_tokens", max_new_tokens), ("temperature", temperature), ("top_p", top_p))
            if value is not None}
        sampling = dataclasses.replace(self.sampling, **overrides)
        penalties = ((frequency_penalty, presence_penalty)
                     if (frequency_penalty or presence_penalty) else None)
        return self._generate_serialized(ids, images, patch_valid, sampling,
                                         lp_sink if logprobs is not None else None, penalties)

    def _stream_handle(self, handle, logprobs, lp_sink) -> Iterator[int]:
        if logprobs is None or lp_sink is None:
            yield from self.batcher.stream(handle)
            return
        # lp_log[i] is appended before token i enters the queue, so indexing
        # by consumption order is race-free.
        for i, tok in enumerate(self.batcher.stream(handle)):
            lp_sink.append(handle.lp_log[i])
            yield tok

    def _generate_serialized(self, ids, images, patch_valid, sampling, lp_sink,
                             penalties=None) -> Iterator[int]:
        with self._lock:
            dev = self.device
            yield from generate_stream(
                self.model, torch.as_tensor(ids, device=dev)[None],
                None if images is None else torch.as_tensor(images, device=dev)[None],
                None if patch_valid is None else torch.as_tensor(patch_valid, device=dev)[None],
                self.cfg, sampling, lookahead=self.lookahead, multi_step=self.multi_step,
                lp_sink=lp_sink, penalties=penalties)

    def stream_text(self, token_iter: Iterator[int]) -> Iterator[str]:
        """Detokenize a token stream into stable text deltas, re-decoding only
        a sliding window (the vLLM detokenizer's structure): `prefix..read`
        is context already emitted, kept so that the decoder renders the
        piece boundary as a full decode would, and `read..end` the pending
        tail, held back while it renders incomplete (ending in U+FFFD, a
        split UTF-8 sequence)."""
        produced: List[int] = []
        prefix = 0  # window start: context tokens already fully emitted
        read = 0    # tokens emitted as text (prefix..read renders context)
        for tok in token_iter:
            produced.append(tok)
            ctx = self.tokenizer.decode(produced[prefix:read], skip_special_tokens=True)
            full = self.tokenizer.decode(produced[prefix:], skip_special_tokens=True)
            if len(full) <= len(ctx) or full.endswith("\ufffd"):
                continue  # tail incomplete (mid-codepoint or a merged piece)
            yield full[len(ctx):]
            prefix = max(read, len(produced) - 8)
            read = len(produced)
        # Stream over: flush any tail still held back.
        if read < len(produced):
            ctx = self.tokenizer.decode(produced[prefix:read], skip_special_tokens=True)
            full = self.tokenizer.decode(produced[prefix:], skip_special_tokens=True)
            if len(full) > len(ctx):
                yield full[len(ctx):]


def token_strings_from_tokenizer(tokenizer, vocab_size: Optional[int] = None) -> List[bytes]:
    """The RAW BYTES each vocabulary id contributes to decoded text (the port's
    copy of `vis_zephyr_tpu/serve/structured.py::token_strings_from_tokenizer`).

    HF sentencepiece-style tokenizers: `convert_ids_to_tokens` with the
    ``▁`` → space and ``<0xNN>`` → byte conventions; other tokenizers: a
    `decode` per id. Bytes, not str: a byte-fallback token ``<0xC3>`` is the
    single byte 0xC3."""
    V = vocab_size or getattr(tokenizer, "vocab_size", None) or len(tokenizer.get_vocab())
    conv = getattr(tokenizer, "convert_ids_to_tokens", None)
    out: List[bytes] = []
    if conv is not None:
        for t in conv(list(range(V))):
            if t is None:
                out.append(b"")
            elif len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                out.append(bytes([int(t[3:5], 16)]))
            elif t.startswith("<") and t.endswith(">"):
                out.append(b"")  # special tokens contribute no text
            else:
                out.append(t.replace("\u2581", " ").encode("utf-8"))
        return out
    for i in range(V):
        try:
            out.append(tokenizer.decode([i], skip_special_tokens=True).encode("utf-8"))
        except Exception:  # noqa: BLE001 — an id the tokenizer cannot decode adds nothing
            out.append(b"")
    return out


def _refuse_serialized_adapter(adapter: Optional[str]) -> None:
    """The serialized path serves the base only (the JAX engine's refusal)."""
    if adapter is not None and adapter != "base":
        raise ValueError("per-request adapters need --continuous-batching "
                         "(serialized engines merge one adapter at load)")
