"""ChatEngine: session/conversation state + streaming generation for the CLI
and the HTTP server.

Port of `vis_zephyr_tpu/serve/engine.py` in its default mode: serialized
generation (one request decodes at a time, under a lock) over a dense KV
cache. A session's image is preprocessed once and kept on the device.
Continuous batching, paged caches, speculation, multi-step bursts, meshes,
adapters, metrics, draining and the OpenAI endpoints are not ported yet.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator

import numpy as np
import torch

from vis_zephyr_tpu.config import VisZephyrConfig
from vis_zephyr_tpu.constants import DEFAULT_IMAGE_TOKEN
from vis_zephyr_tpu.conversation import templates
from vis_zephyr_tpu.data import anyres
from vis_zephyr_tpu.data.tokenization import tokenize_with_images

from ..data.image_pipeline import anyres_preprocess_host, preprocess_mode_host
from ..models.vis_zephyr import VisZephyr
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
        self.sessions: Dict[str, Dict] = {}
        self._sessions_lock = threading.Lock()
        self._lock = threading.Lock()  # one generation at a time

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
        with self._lock:
            try:
                for tok in generate_stream(self.model, input_ids, sess["images"],
                                           sess["patch_valid"], self.cfg, self.sampling):
                    produced.append(tok)
                    text = self.tokenizer.decode(produced, skip_special_tokens=True)
                    # Emit only the stable prefix delta (the last token may merge).
                    delta = text[len(emitted_text):]
                    if delta:
                        emitted_text = text
                        yield delta
            finally:
                # Record the (possibly partial) reply even when the consumer
                # closes the stream early: a None assistant turn would corrupt
                # the next turn's prompt.
                conv.messages[-1][1] = emitted_text

    def chat_text(self, session_id: str, question: str, pil_image=None) -> str:
        return "".join(self.chat(session_id, question, pil_image))
