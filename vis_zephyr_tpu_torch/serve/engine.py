"""ChatEngine: session/conversation state + streaming generation for the CLI
and the HTTP server.

Port of `vis_zephyr_tpu/serve/engine.py`. Two modes:

- the default: serialized generation (one request decodes at a time, under a
  lock) over a dense KV cache;
- `continuous_batching=True` with `kv_cache="paged"`: requests of different
  sessions share decode steps in a `PagedBatcher`, advanced by one
  background pump thread.

`lookahead` (prompt-lookup speculation, greedy only) and `multi_step`
(bursts of decode steps, replayed as CUDA graphs on the card; ignored under
`lookahead`) reach both. A session's image is preprocessed once and kept on
the device. Not ported yet, each raising `NotImplementedError` when asked
for: the dense batcher (`kv_cache="dense"` under continuous batching), a
draft model, meshes, adapters, metrics, the prefix cache and lazy
allocation; draining and the OpenAI endpoints are not ported either.
"""

from __future__ import annotations

import threading
import time
import warnings
from typing import Dict, Iterator, Optional

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
        draft_params=None,
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
        if draft_params is not None or draft_cfg is not None:
            raise not_ported("a draft model", "Queue A step 9")
        if continuous_batching:
            if kv_cache == "paged":
                from .paged import PagedBatcher

                self.batcher = PagedBatcher(
                    model, cfg, max_slots=max_slots, cache_len=cache_len,
                    sampling=self.sampling, num_pages=num_pages, mesh=mesh, metrics=metrics,
                    prefill_chunk=prefill_chunk, kv_quant=kv_quant, lookahead=lookahead,
                    multi_step=multi_step, kv_fused=kv_fused, prefix_cache=prefix_cache,
                    page_size=page_size, mlora=mlora, adapter_names=adapter_names,
                    lazy_alloc=lazy_alloc)
            else:
                self.batcher = ContinuousBatcher(
                    model, cfg, max_slots=max_slots, cache_len=cache_len,
                    sampling=self.sampling, mesh=mesh, metrics=metrics,
                    prefill_chunk=prefill_chunk, lookahead=lookahead, multi_step=multi_step,
                    mlora=mlora, adapter_names=adapter_names)
        else:
            # The serialized path has none of these; say so instead of ignoring them.
            for value, what, step in (
                    (mesh, "a device mesh", "Queue A step 13"),
                    (metrics, "ServingMetrics", "Queue A step 10"),
                    (mlora, "multi-LoRA serving", "Queue A step 10")):
                if value:
                    raise not_ported(what, step)

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

    def chat(self, session_id: str, question: str, pil_image=None) -> Iterator[str]:
        """Append the user turn, stream back the assistant reply text."""
        sess = self.get_session(session_id)
        with sess["lock"]:
            yield from self._chat_locked(sess, session_id, question, pil_image)

    def _chat_locked(self, sess, session_id: str, question: str, pil_image) -> Iterator[str]:
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
                None if images is None else sess["patch_valid"][0].cpu().numpy())
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

    def chat_text(self, session_id: str, question: str, pil_image=None) -> str:
        return "".join(self.chat(session_id, question, pil_image))
