"""OpenAI-compatible completion endpoints on top of `ChatEngine`.

Port of `vis_zephyr_tpu/serve/openai_api.py`:

- ``POST /v1/chat/completions``: messages (with image data-URL content
  parts), streaming SSE or one JSON body, per-request ``max_tokens`` /
  ``temperature`` / ``top_p`` / ``stop`` strings, ``n`` choices,
  ``logprobs`` / ``top_logprobs`` and frequency / presence penalties;
- ``POST /v1/completions``: a bare prompt, the same knobs (legacy integer
  ``logprobs``);
- ``GET /v1/models``: the base model and every loaded LoRA adapter.

The ``model`` field routes multi-LoRA serving: an adapter's name selects it,
``base`` or the served model id the base weights.

Requests are stateless: each carries its whole message history. Left out,
each refused with an error that names its ROADMAP.md step (never ignored):
``tools`` / ``tool_choice`` and ``response_format``, which need the
grammars of `serve/structured.py`. An image data URL is decoded with PIL; where PIL is not installed
the request is refused with a 400 that says so.

Transport-agnostic: `chat_completion` / `completion` return an error or
either a response dict or an SSE event-string iterator; `serve/api.py` wires
them into the stdlib HTTP handler.
"""

from __future__ import annotations

import itertools
import json
import time
import uuid
from typing import Iterator, List, Optional, Tuple

from ..constants import DEFAULT_IMAGE_TOKEN
from ..conversation import templates
from ..data.tokenization import tokenize_with_images
from .generate import LP_TOPK

MODEL_ID = "vis-zephyr-tpu"
STEP_10 = "ROADMAP.md, Queue A step 10"


class StopMatcher:
    """Incremental stop-string scanner: holds back the longest possible
    partial match so a stop sequence split across deltas is never emitted."""

    def __init__(self, stops: Optional[List[str]]):
        self.stops = [s for s in (stops or []) if s]
        self._buf = ""
        self.stopped = False

    def _held(self) -> int:
        """Length of the longest buffer suffix that is a proper prefix of
        some stop string — the only text that must be withheld."""
        best = 0
        for s in self.stops:
            for k in range(min(len(s) - 1, len(self._buf)), best, -1):
                if self._buf.endswith(s[:k]):
                    best = k
                    break
        return best

    def feed(self, delta: str) -> str:
        """Add a text delta; return the text that is safe to emit."""
        if not self.stops or self.stopped:
            return "" if self.stopped else delta
        self._buf += delta
        hits = [i for i in (self._buf.find(s) for s in self.stops) if i >= 0]
        if hits:
            out = self._buf[: min(hits)]
            self._buf = ""
            self.stopped = True
            return out
        emit = self._buf[: len(self._buf) - self._held()]
        self._buf = self._buf[len(emit):]
        return emit

    def flush(self) -> str:
        """End of stream: release any held-back tail (it never completed a
        stop sequence)."""
        out, self._buf = self._buf, ""
        return "" if self.stopped else out


def _decode_data_url(url: str):
    """data:image/...;base64,... → PIL image. Remote URLs are refused: the
    server fetches nothing for its clients."""
    import base64
    import io

    if not url.startswith("data:"):
        raise ValueError("only data: image URLs are supported (no server-side fetch)")
    try:
        from PIL import Image
    except ImportError as e:
        raise ValueError("image input needs PIL, which is not installed on this server") from e
    try:
        b64 = url.split(",", 1)[1]
        return Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB")
    except Exception as e:  # noqa: BLE001 — any decode failure is a bad request
        raise ValueError(f"failed to decode image data URL: {e}") from e


def render_chat_prompt(messages: List[dict], conv_mode: str) -> Tuple[str, object]:
    """OpenAI `messages` → (rendered prompt in the engine's template, PIL
    image | None).

    `system` messages replace the template's system prompt; `user` /
    `assistant` turns append in order. Content may be a string or OpenAI
    content parts (`{"type": "text"}` / `{"type": "image_url"}` with a data
    URL). One image a request; the turn that carries it gets the ``<image>``
    sentinel, as `ChatEngine.chat` does. Earlier tool-calling turns render
    into the two roles as the JAX module renders them: an assistant message
    with `tool_calls` as the call JSON, a `tool` result as a user turn."""
    conv = templates[conv_mode].copy()
    image = None
    for msg in messages:
        role = msg.get("role")
        content = msg.get("content", "")
        if isinstance(content, list):
            text_parts: List[str] = []
            for part in content:
                ptype = part.get("type")
                if ptype == "text":
                    text_parts.append(part.get("text", ""))
                elif ptype == "image_url":
                    if image is not None:
                        raise ValueError("only one image per request is supported")
                    url = part.get("image_url")
                    if isinstance(url, dict):
                        url = url.get("url", "")
                    image = _decode_data_url(url)
                    text_parts.append(DEFAULT_IMAGE_TOKEN)
                else:
                    raise ValueError(f"unsupported content part type {ptype!r}")
            text = "\n".join(t for t in text_parts if t)
        else:
            text = "" if content is None else str(content)
        if role == "system":
            conv.system = text
        elif role == "user":
            conv.append_message(conv.roles[0], text)
        elif role == "assistant":
            calls = msg.get("tool_calls")
            if calls:
                rendered = "\n".join(
                    json.dumps({"name": c["function"]["name"],
                                "arguments": json.loads(c["function"].get("arguments") or "{}")})
                    for c in calls)
                text = f"{text}\n{rendered}".strip() if text else rendered
            conv.append_message(conv.roles[1], text)
        elif role == "tool":
            name = msg.get("name", "")
            conv.append_message(conv.roles[0],
                                f"[tool result{' ' + name if name else ''}] {text}")
        else:
            raise ValueError(f"unsupported message role {role!r}")
    conv.append_message(conv.roles[1], None)  # the assistant's turn
    return conv.get_prompt(), image


def _resolve_adapter(engine, model: Optional[str]):
    """The OpenAI `model` field routes multi-LoRA: an adapter name selects
    that adapter; 'base', None and the served id select the base weights.
    Returns (adapter, error)."""
    if not model or model in ("base", "vis-zephyr", MODEL_ID):
        return None, None
    names = getattr(getattr(engine, "batcher", None), "adapter_names", None) or {}
    if model in names:
        return model, None
    return None, f"unknown model {model!r}; available: {[MODEL_ID] + sorted(names)}"


def _refusal(payload: dict, chat: bool) -> Optional[str]:
    """The error for a field this port does not serve yet, naming its step."""
    if chat and payload.get("tools") and payload.get("tool_choice", "auto") != "none":
        return f"tools / tool_choice (function calling) are not ported to PyTorch yet ({STEP_10})"
    if chat and payload.get("tool_choice") not in (None, "none", "auto"):
        return f"tool_choice is not ported to PyTorch yet ({STEP_10})"
    rf = payload.get("response_format")
    if rf and not (isinstance(rf, dict) and rf.get("type") in (None, "text")):
        return f"response_format (structured output) is not ported to PyTorch yet ({STEP_10})"
    return None


def _parse_request(engine, payload: dict, chat: bool):
    """Shared validation → (dict of generation arguments, None), or (None,
    error)."""
    adapter, err = _resolve_adapter(engine, payload.get("model"))
    err = err or _refusal(payload, chat)
    if err:
        return None, err
    try:
        if chat:
            messages = payload.get("messages")
            if not isinstance(messages, list) or not messages:
                return None, "messages must be a non-empty list"
            prompt, image = render_chat_prompt(messages, engine.conv_mode)
        else:
            prompt = payload.get("prompt")
            if not isinstance(prompt, str) or not prompt:
                return None, "prompt must be a non-empty string"
            image = None
    except ValueError as e:
        return None, str(e)
    stop = payload.get("stop")
    if isinstance(stop, str):
        stop = [stop]
    elif stop is not None and not isinstance(stop, list):
        return None, "stop must be a string or list of strings"
    max_tokens = payload.get("max_tokens", payload.get("max_completion_tokens"))
    temperature = payload.get("temperature")
    top_p = payload.get("top_p")
    freq_pen = payload.get("frequency_penalty")
    pres_pen = payload.get("presence_penalty")
    for name, v in (("max_tokens", max_tokens), ("temperature", temperature),
                    ("top_p", top_p), ("frequency_penalty", freq_pen),
                    ("presence_penalty", pres_pen)):
        if v is not None and not isinstance(v, (int, float)):
            return None, f"{name} must be a number"
    for name, v in (("frequency_penalty", freq_pen), ("presence_penalty", pres_pen)):
        if v is not None and not -2.0 <= v <= 2.0:
            return None, f"{name} must be in [-2, 2]"
    # logprobs: chat = bool `logprobs` + int `top_logprobs`; legacy
    # completions = int `logprobs` (top-N; the chosen token is always
    # reported). Capped at LP_TOPK, the OpenAI limit and the step's top-k.
    lp_n = None
    if chat:
        if payload.get("logprobs"):
            tl = payload.get("top_logprobs", 0)
            if not isinstance(tl, int) or not 0 <= tl <= LP_TOPK:
                return None, f"top_logprobs must be an int in [0, {LP_TOPK}]"
            lp_n = tl
    else:
        lp = payload.get("logprobs")
        if lp is not None:
            if not isinstance(lp, int) or not 0 <= lp <= LP_TOPK:
                return None, f"logprobs must be an int in [0, {LP_TOPK}]"
            lp_n = lp
    return {
        "prompt": prompt,
        "image": image,
        "adapter": adapter,
        "stop": stop,
        "max_new_tokens": None if max_tokens is None else int(max_tokens),
        "temperature": None if temperature is None else float(temperature),
        "top_p": None if top_p is None else float(top_p),
        "logprobs": lp_n,
        "frequency_penalty": float(freq_pen or 0.0),
        "presence_penalty": float(pres_pen or 0.0),
    }, None


def _run(engine, spec):
    """Start generation; returns (token iterator, prompt token count,
    effective max_new_tokens, lp_sink | None)."""
    ids = tokenize_with_images(spec["prompt"], engine.tokenizer)
    budget = spec["max_new_tokens"] or engine.sampling.max_new_tokens
    lp_sink = [] if spec["logprobs"] is not None else None
    tokens = engine.generate_request(
        spec["prompt"], pil_image=spec["image"], max_new_tokens=spec["max_new_tokens"],
        temperature=spec["temperature"], top_p=spec["top_p"], adapter=spec["adapter"],
        logprobs=spec["logprobs"],
        lp_sink=lp_sink, frequency_penalty=spec["frequency_penalty"],
        presence_penalty=spec["presence_penalty"])
    return tokens, len(ids), budget, lp_sink


def _lp_token_entry(engine, tok: int, logprob: float) -> dict:
    return {"token": engine.token_text(int(tok)), "logprob": float(logprob),
            "bytes": list(engine.token_bytes(int(tok)))}


def _format_logprobs(engine, tokens, entries, n: int, chat: bool, text_offset0: int = 0):
    """(token ids, lp_log entries, top-N) → the OpenAI `logprobs` object:
    chat = {"content": [{token, logprob, bytes, top_logprobs}...]};
    completions = the legacy parallel-array form."""
    if chat:
        content = []
        for tok, (chosen, ids, lps) in zip(tokens, entries):
            e = _lp_token_entry(engine, tok, chosen)
            e["top_logprobs"] = [_lp_token_entry(engine, int(i), float(v))
                                 for i, v in zip(ids[:n], lps[:n])]
            content.append(e)
        return {"content": content}
    toks, tlps, tops, offs = [], [], [], []
    off = text_offset0
    for tok, (chosen, ids, lps) in zip(tokens, entries):
        text = engine.token_text(int(tok))
        toks.append(text)
        tlps.append(float(chosen))
        tops.append({engine.token_text(int(i)): float(v) for i, v in zip(ids[:n], lps[:n])}
                    if n else None)
        offs.append(off)
        off += len(text)
    return {"tokens": toks, "token_logprobs": tlps, "top_logprobs": tops if n else None,
            "text_offset": offs}


class _CountingIter:
    """Wrap a token iterator, recording yields and forwarding close() (so a
    stop-string match cancels the batcher slot like a client disconnect)."""

    def __init__(self, it: Iterator[int]):
        self._it = it
        self.tokens: List[int] = []

    @property
    def count(self) -> int:
        return len(self.tokens)

    def __iter__(self):
        return self

    def __next__(self):
        tok = next(self._it)
        self.tokens.append(tok)
        return tok

    def close(self):
        close = getattr(self._it, "close", None)
        if close:
            close()


class _ChoiceState:
    """One choice's streaming machinery: token recorder, text-delta iterator,
    stop-string matcher, logprob cursor."""

    def __init__(self, engine, spec, index: int):
        tokens, self.n_prompt, self.budget, self.lp_sink = _run(engine, spec)
        self.index = index
        self.counted = _CountingIter(tokens)
        self.deltas = engine.stream_text(self.counted)
        self.matcher = StopMatcher(spec["stop"])
        self.lp_done = 0
        self.stopped = False
        self.done = False

    def next_emit(self) -> Optional[str]:
        """Advance one text delta; return the emitted text ('' possible), or
        None when this choice just finished (sets `done`)."""
        try:
            delta = next(self.deltas)
        except StopIteration:
            self.done = True
            return None
        emit = self.matcher.feed(delta)
        if self.matcher.stopped:
            self.stopped = True
            self.done = True
            self.counted.close()
        return emit

    def tail(self) -> str:
        return "" if self.stopped else self.matcher.flush()

    def finish_reason(self) -> str:
        return "stop" if (self.stopped or self.counted.count < self.budget) else "length"

    def take_lp(self, engine, lp_n, chat):
        """Logprob entries for the tokens consumed since the last take."""
        if self.lp_sink is None:
            return None
        lo, hi = self.lp_done, self.counted.count
        self.lp_done = hi
        return _format_logprobs(engine, self.counted.tokens[lo:hi], self.lp_sink[lo:hi],
                                lp_n, chat)


def _completion_events(engine, spec, rid: str, created: int, model: str, chat: bool, n: int):
    """Yield SSE event strings for a streaming completion with `n` choices.

    Under continuous batching the choices decode together (submission is
    eager) and their chunks interleave; on a serialized engine they drain
    one after another (the engine's lock is held for a generation's
    lifetime). Chunks carry `index`, so both orders are valid SSE."""
    lp_n = spec["logprobs"]
    states = [_ChoiceState(engine, spec, i) for i in range(n)]
    kind = "chat.completion.chunk" if chat else "text_completion"

    def event(payload: dict) -> str:
        return f"data: {json.dumps(payload)}\n\n"

    def chunk(state, delta_obj: dict, finish: Optional[str], lp=None) -> dict:
        choice = {"index": state.index, "finish_reason": finish}
        if chat:
            choice["delta"] = delta_obj
        else:
            choice["text"] = delta_obj.get("content", "")
        if lp is not None:
            choice["logprobs"] = lp
        return {"id": rid, "object": kind, "created": created, "model": model,
                "choices": [choice]}

    def drain_one(state):
        """Advance `state` one delta, yielding its chunk(s)."""
        emit = state.next_emit()
        if emit:
            yield event(chunk(state, {"content": emit}, None,
                              lp=state.take_lp(engine, lp_n, chat)))
        if state.done:
            tail = state.tail()
            if tail:
                yield event(chunk(state, {"content": tail}, None,
                                  lp=state.take_lp(engine, lp_n, chat)))
            yield event(chunk(state, {}, state.finish_reason()))

    if chat:
        for state in states:
            yield event(chunk(state, {"role": "assistant", "content": ""}, None))
    if engine.batcher is not None:
        while any(not s.done for s in states):
            for state in states:
                if not state.done:
                    yield from drain_one(state)
    else:
        for state in states:
            while not state.done:
                yield from drain_one(state)

    n_out = sum(s.counted.count for s in states)
    yield event({"id": rid, "object": kind, "created": created, "model": model,
                 "choices": [],
                 "usage": {"prompt_tokens": states[0].n_prompt, "completion_tokens": n_out,
                           "total_tokens": states[0].n_prompt + n_out}})
    yield "data: [DONE]\n\n"


def chat_completion(engine, payload: dict):
    """POST /v1/chat/completions → (error | None, response dict | SSE
    iterator). Streaming when `payload["stream"]` is truthy."""
    return _completion(engine, payload, chat=True)


def completion(engine, payload: dict):
    """POST /v1/completions → the same contract as `chat_completion`."""
    return _completion(engine, payload, chat=False)


def _error(message: str) -> dict:
    return {"error": {"message": message, "type": "invalid_request_error"}}


def _completion(engine, payload: dict, chat: bool):
    try:
        spec, err = _parse_request(engine, payload, chat=chat)
    except (TypeError, KeyError, AttributeError, ValueError) as e:
        # Malformed payload shapes (string content parts, dict arguments,
        # missing keys, ...) are a 400 like every validated field.
        err = f"invalid request: {type(e).__name__}: {e}"
    if err:
        return _error(err), None
    n = payload.get("n", 1)
    if not isinstance(n, int) or not 1 <= n <= 16:
        return _error("n must be an int in [1, 16]"), None
    rid = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:20]
    created = int(time.time())
    model = payload.get("model") or MODEL_ID
    if payload.get("stream"):
        try:
            events = _completion_events(engine, spec, rid, created, model, chat, n)
            first = next(events)
        except ValueError as e:  # an engine-level refusal (speculation)
            return _error(str(e)), None
        return None, itertools.chain([first], events)

    # Start every choice before draining any: under continuous batching they
    # decode together; a serialized engine drains them one at a time.
    choices = []
    n_out = 0
    try:
        states = [_ChoiceState(engine, spec, i) for i in range(n)]
        for state in states:
            parts: List[str] = []
            while not state.done:
                emit = state.next_emit()
                if emit:
                    parts.append(emit)
            parts.append(state.tail())
            text = "".join(parts)
            n_out += state.counted.count
            choice = {"index": state.index, "finish_reason": state.finish_reason()}
            if chat:
                choice["message"] = {"role": "assistant", "content": text}
            else:
                choice["text"] = text
            if state.lp_sink is not None:
                choice["logprobs"] = _format_logprobs(engine, state.counted.tokens,
                                                      state.lp_sink, spec["logprobs"], chat)
            choices.append(choice)
    except ValueError as e:  # an engine-level refusal (speculation)
        return _error(str(e)), None
    n_prompt = states[0].n_prompt
    return None, {
        "id": rid,
        "object": "chat.completion" if chat else "text_completion",
        "created": created,
        "model": model,
        "choices": choices,
        "usage": {"prompt_tokens": n_prompt, "completion_tokens": n_out,
                  "total_tokens": n_prompt + n_out},
    }


def list_models(engine) -> dict:
    """GET /v1/models: the base model plus every loaded LoRA adapter."""
    created = int(time.time())
    names = getattr(getattr(engine, "batcher", None), "adapter_names", None) or {}
    data = [{"id": MODEL_ID, "object": "model", "created": created, "owned_by": MODEL_ID}]
    for name in sorted(names):
        data.append({"id": name, "object": "model", "created": created, "owned_by": MODEL_ID,
                     "parent": MODEL_ID})
    return {"object": "list", "data": data}
