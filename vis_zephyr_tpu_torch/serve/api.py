"""Streaming HTTP chat server (stdlib `ThreadingHTTPServer`).

Port of `vis_zephyr_tpu/serve/api.py`'s stdlib server: POST /chat with
``{"session_id": str, "image_base64": str?, "question": str}`` → chunked
text/plain stream of the reply (the first request of a session must carry
the image unless one is already attached), and the OpenAI endpoints
(`serve/openai_api.py`): POST /v1/chat/completions, POST /v1/completions
(one JSON body, or SSE with ``"stream": true``) and GET /v1/models. With
`--continuous-batching` requests share decode steps: over one dense cache
(`--kv-cache dense`, the default) or over paged KV pools (`--kv-cache paged`
with `--kv-quant`, `--kv-fused`, `--page-size`, `--num-pages`, the prefix
cache `--prefix-cache` and lazy allocation with host swap `--lazy-alloc`),
with `--max-slots` and `--prefill-chunk`, defaults as in the JAX server.
`--lookahead N` (prompt-lookup speculation) and `--multi-step N` (bursts of
N decode steps) reach every path; `--draft-model DIR` gives both batchers a
second, smaller decoder's proposals (bf16, whatever the target's weights).
`--load-8bit` / `--load-4bit` serve int8 / int4 weights. `--device` (the
port's own; default `cuda`) runs it on the CPU when asked.

Observability, as in the JAX server: GET /health (200 "ok", 503 "draining"),
GET /metrics (`ServingMetrics.summary()`: TTFT and TPOT histograms,
speculation's proposals and acceptance, lazy allocation's swap counts, and
the prefix cache's hits and reused pages; `--metrics-path` adds a JSONL row a
request), GET /debug/profile?seconds=N (with `--profile-dir`: a
`torch.profiler` Chrome trace of live traffic written there; 409 while a
capture runs), and SIGTERM / SIGINT drain: new requests get 503 while those
in flight finish (`--drain-timeout`), then the server exits.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from . import openai_api
from .engine import ChatEngine, EngineDraining


def decode_base64_image(b64: str):
    from PIL import Image

    try:
        return Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB")
    except Exception as e:  # noqa: BLE001 — any decode failure is a bad request
        raise ValueError(f"Failed to decode base64 image: {e}") from e


def _handle_chat(engine: ChatEngine, payload: dict):
    """Validate a /chat payload → (error dict | None, chunk iterator | None)."""
    session_id = payload.get("session_id")
    question = payload.get("question")
    image_b64 = payload.get("image_base64")
    if not session_id or not question:
        return {"error": "Missing session_id or question"}, None

    sess = engine.get_session(session_id)
    image = None
    if sess["images"] is None:
        if not image_b64:
            return {"error": "Missing image_base64 for first request"}, None
        try:
            image = decode_base64_image(image_b64)
        except ValueError as e:
            return {"error": str(e)}, None
    adapter = payload.get("adapter")  # multi-LoRA adapter name (optional)
    if adapter and adapter != "base":
        # Checked here: engine.chat is a generator, which would raise only
        # once streaming starts, after the 200 header.
        names = getattr(getattr(engine, "batcher", None), "adapter_names", None) or {}
        if adapter not in names:
            return {"error": f"unknown adapter {adapter!r}; loaded: "
                             f"{sorted(names)} (plus 'base')"}, None
    return None, engine.chat(session_id, question, pil_image=image, adapter=adapter)


class ChatHandler(BaseHTTPRequestHandler):
    engine: ChatEngine = None  # injected by serve()
    profile_dir: Optional[str] = None  # enables GET /debug/profile
    _profile_lock = threading.Lock()  # one capture at a time, process-wide

    def log_message(self, *args):  # quiet
        pass

    def do_POST(self):
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, json.JSONDecodeError):
            self._json(400, {"error": "invalid JSON"})
            return
        if self.engine._draining:
            self._json(503, {"error": {"message": "server is draining for shutdown",
                                       "type": "unavailable"}})
            return
        path = self.path.rstrip("/")
        if path in ("/v1/chat/completions", "/v1/completions"):
            self._openai(path, payload)
            return
        if path != "/chat":
            self.send_error(404)
            return
        try:
            error, stream = _handle_chat(self.engine, payload)
        except EngineDraining as e:  # the drain began after the check above
            self._json(503, {"error": str(e)})
            return
        if error is not None:
            self._json(400, error)
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; charset=utf-8")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Access-Control-Allow-Origin", "*")
        self.end_headers()
        self._stream_chunked(stream)

    def do_GET(self):
        """GET /health, /metrics, /v1/models and (with a profile dir)
        /debug/profile?seconds=N."""
        path = self.path.split("?", 1)[0].rstrip("/")
        if path == "/health":
            # Load balancers take a draining replica out of rotation.
            draining = self.engine._draining
            self._json(503 if draining else 200, {"status": "draining" if draining else "ok"})
        elif path == "/v1/models":
            self._json(200, openai_api.list_models(self.engine))
        elif path == "/metrics":
            metrics = self.engine.metrics
            out = metrics.summary() if metrics is not None else {}
            cache = getattr(self.engine.batcher, "prefix_cache", None)
            if cache is not None:
                out["prefix_cache"] = {"hits": cache.hits, "pages_reused": cache.pages_reused}
            self._json(200, out)
        elif path == "/debug/profile":
            self._profile()
        else:
            self.send_error(404)

    def _profile(self):
        """GET /debug/profile?seconds=N: record live serving traffic for N
        seconds (2 by default, at most 60) with `torch.profiler` into a
        Chrome trace file in `profile_dir`, named in the answer. Opt-in
        with --profile-dir (404 without): an unauthenticated endpoint with
        side effects stays off by default. One capture at a time; a
        concurrent call gets 409."""
        if not self.profile_dir:
            self.send_error(404)
            return
        from urllib.parse import parse_qs, urlparse

        query = parse_qs(urlparse(self.path).query)
        try:
            seconds = float(query.get("seconds", ["2"])[0])
        except ValueError:
            seconds = float("nan")
        if not seconds >= 0.0:  # rejects negatives and NaN
            self._json(400, {"error": "seconds must be a number in [0, 60]"})
            return
        seconds = min(seconds, 60.0)
        if not self._profile_lock.acquire(blocking=False):
            self._json(409, {"error": "a profile capture is already running"})
            return
        try:
            from ..utils.profiling import profile_to

            with profile_to(self.profile_dir) as trace:
                time.sleep(seconds)
            self._json(200, {"trace_dir": self.profile_dir, "trace_file": trace["path"],
                             "seconds": seconds})
        except Exception as e:  # noqa: BLE001 — report, don't drop the connection
            self._json(500, {"error": f"{type(e).__name__}: {e}"})
        finally:
            self._profile_lock.release()

    def _stream_chunked(self, stream):
        try:
            for chunk in stream:
                data = chunk.encode("utf-8")
                self.wfile.write(f"{len(data):X}\r\n".encode())
                self.wfile.write(data + b"\r\n")
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            stream.close()  # client gone: stop decoding now

    def _openai(self, path: str, payload: dict):
        """The OpenAI endpoints: one JSON body, or an SSE stream."""
        fn = (openai_api.chat_completion if path == "/v1/chat/completions"
              else openai_api.completion)
        try:
            error, result = fn(self.engine, payload)
        except EngineDraining as e:  # the drain began mid-request
            self._json(503, {"error": {"message": str(e), "type": "unavailable"}})
            return
        except Exception as e:  # noqa: BLE001 — a handler fault must give an HTTP
            # error body, never a dropped connection.
            self._json(500, {"error": {"message": f"{type(e).__name__}: {e}",
                                       "type": "internal_error"}})
            return
        if error is not None:
            self._json(400, error)
            return
        if isinstance(result, dict):
            self._json(200, result)
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Access-Control-Allow-Origin", "*")
        self.end_headers()
        self._stream_chunked(result)

    def _json(self, code: int, obj: dict):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class ChatServer(ThreadingHTTPServer):
    # The stdlib's listen backlog of 5 resets connections when a batch of
    # clients arrives at once, which is what a batching server is for.
    request_queue_size = 128


def serve(engine: ChatEngine, host: str = "0.0.0.0", port: int = 8000,
          profile_dir: Optional[str] = None) -> ThreadingHTTPServer:
    """The server for `engine`; with `profile_dir`, GET /debug/profile. Call
    it from the main thread: it initialises the profiler's tracing there."""
    if profile_dir:
        from ..utils.profiling import init_tracing

        init_tracing()
    handler = type("BoundChatHandler", (ChatHandler,),
                   {"engine": engine, "profile_dir": profile_dir})
    server = ChatServer((host, port), handler)
    # Handler threads must not block interpreter exit (a client that never
    # drains its stream would otherwise pin a thread).
    server.daemon_threads = True
    return server


def add_engine_args(p) -> None:
    """The flags that shape the `ChatEngine`, with the JAX server's defaults."""
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--max-new-tokens", type=int, default=512)
    p.add_argument("--continuous-batching", action="store_true")
    p.add_argument("--max-slots", type=int, default=8)
    p.add_argument("--kv-cache", choices=["dense", "paged"], default="dense",
                   help="under --continuous-batching: dense, one cache of --max-slots x "
                        "cache_len rows; paged, shared page pools (memory follows the tokens "
                        "in flight)")
    p.add_argument("--num-pages", type=int, default=None,
                   help="paged pool size per layer (default: half the dense footprint)")
    p.add_argument("--page-size", type=int, default=128, help="tokens per KV page (paged only)")
    p.add_argument("--kv-quant", action="store_true",
                   help="int8 KV pools (paged only): per-row absmax scales")
    p.add_argument("--prefill-chunk", type=int, default=256,
                   help="admit prompts in chunks of N tokens, interleaved with decode "
                        "steps; 0 for whole-prompt admission")
    p.add_argument("--kv-fused", action=argparse.BooleanOptionalAction, default=True,
                   help="fused KV pool layout (paged only): a page holds its K rows then "
                        "its V rows; --no-kv-fused for split pools")
    p.add_argument("--lookahead", type=int, default=0,
                   help="speculative decoding span (greedy only; 0 disables): prompt lookup on "
                        "the serialized path and both continuous batchers, or --draft-model's "
                        "proposals on the batchers")
    p.add_argument("--draft-model", default=None,
                   help="model dir of a SMALL draft model: its decoder proposes --lookahead "
                        "tokens a slot each step for the batchers (it beats prompt lookup on "
                        "text that copies nothing); needs --continuous-batching; --lookahead "
                        "defaults to 4 with it")
    p.add_argument("--metrics-path", default=None,
                   help="JSONL file for per-request TTFT/TPOT rows; aggregate histograms at "
                        "GET /metrics")
    p.add_argument("--prefix-cache", action="store_true",
                   help="automatic prefix caching (paged only): requests sharing a page-aligned "
                        "prompt prefix (system prompts, multi-turn continuations) reuse its pool "
                        "pages and prefill only the suffix; needs --prefill-chunk (on by default)")
    p.add_argument("--lazy-alloc", action="store_true",
                   help="incremental page allocation (paged only): slots reserve pages as they "
                        "grow instead of their full max-tokens span, raising concurrency; under "
                        "pool pressure the youngest slot is preempted to host memory (bit-exact "
                        "KV swap) and resumes FIFO")
    p.add_argument("--multi-step", type=int, default=1,
                   help="decode steps per burst (multi-step scheduling): the serialized path "
                        "ramps 1, 2, 4, N; the paged batcher bursts when no admission work "
                        "waits; one copy to the host a burst, each step a CUDA-graph replay "
                        "on the card; token-exact under greedy. Ignored with --lookahead")
    p.add_argument("--lora-adapters", default=None,
                   help="multi-LoRA serving: comma-separated name=dir peft adapter dirs served "
                        "concurrently on the one base model; requests pick one via the /chat "
                        "'adapter' field or the OpenAI 'model' field (default: base). Requires "
                        "--continuous-batching")


def check_engine_args(p: argparse.ArgumentParser, a) -> None:
    """The flags' checks before anything loads (the JAX server's): a draft
    model that the engine would drop is an argument error, and
    `--draft-model` without `--lookahead` takes 4. `--lora-adapters` needs a
    batcher too (the serialized path serves the base only)."""
    if a.lora_adapters and not a.continuous_batching:
        p.error("--lora-adapters requires --continuous-batching")
    if a.draft_model:
        if not a.continuous_batching:
            p.error("--draft-model requires --continuous-batching")
        if a.lookahead <= 0:
            a.lookahead = 4
            print("--draft-model without --lookahead: defaulting to --lookahead 4")


def load_draft(a, device):
    """--draft-model's (model, cfg), loaded by the builder in bf16 on
    `device` whatever the target's weight form (only its decoder runs), or
    (None, None) without the flag."""
    if not a.draft_model:
        return None, None
    import torch

    from ..models.builder import load_pretrained_model

    _, model, cfg, _ = load_pretrained_model(a.draft_model, dtype=torch.bfloat16, device=device)
    return model, cfg


def load_adapters(a, cfg, device):
    """--lora-adapters' (pack, {name: index}) in bf16 on `device`
    (`models/builder.py::load_lora_pack`), or (None, None) without the flag."""
    if not a.lora_adapters:
        return None, None
    import torch

    from ..models.builder import load_lora_pack

    dirs = dict(pair.split("=", 1) for pair in a.lora_adapters.split(","))
    pack, names = load_lora_pack(dirs, cfg, dtype=torch.bfloat16, device=device)
    print(f"multi-LoRA: serving adapters {sorted(names)} + base")
    return pack, names


def engine_from_args(model, cfg, tokenizer, a, draft=(None, None),
                     adapters=(None, None)) -> ChatEngine:
    """The `ChatEngine` the parsed flags `a` ask for, with a fresh
    `ServingMetrics` (and its JSONL rows under `--metrics-path`), the draft
    (model, cfg) that `load_draft` gave and the multi-LoRA (pack, names)
    that `load_adapters` gave."""
    from ..utils.metrics import MetricsLogger, ServingMetrics

    metrics = ServingMetrics(MetricsLogger(a.metrics_path, echo=False) if a.metrics_path
                             else None)
    return ChatEngine(model, cfg, tokenizer, temperature=a.temperature,
                      max_new_tokens=a.max_new_tokens,
                      continuous_batching=a.continuous_batching, max_slots=a.max_slots,
                      kv_cache=a.kv_cache, kv_quant=a.kv_quant, num_pages=a.num_pages,
                      metrics=metrics, prefill_chunk=a.prefill_chunk or None,
                      kv_fused=a.kv_fused, page_size=a.page_size, lookahead=a.lookahead,
                      draft_model=draft[0], draft_cfg=draft[1], multi_step=a.multi_step,
                      prefix_cache=a.prefix_cache, lazy_alloc=a.lazy_alloc,
                      mlora=adapters[0], adapter_names=adapters[1])


def main(args=None):
    import signal

    import torch

    from ..models.builder import load_pretrained_model

    p = argparse.ArgumentParser(description="Vis-Zephyr HTTP server (PyTorch)")
    p.add_argument("--model-path", required=True)
    p.add_argument("--model-base", default=None)
    p.add_argument("--vision-tower", default=None)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--load-8bit", action="store_true", help="int8 weight-only decoder and Q-Former")
    p.add_argument("--load-4bit", action="store_true",
                   help="int4 weight-only decoder (group-128 scales), int8 Q-Former")
    p.add_argument("--device", default="cuda",
                   help="where the model runs: the card (default) or, when asked, cpu")
    p.add_argument("--profile-dir", default=None,
                   help="enable GET /debug/profile?seconds=N: a torch.profiler trace of live "
                        "traffic written into this directory (Chrome trace format)")
    p.add_argument("--drain-timeout", type=float, default=120.0,
                   help="graceful-shutdown budget (s): on SIGTERM/SIGINT the server stops "
                        "accepting requests (503 and /health 'draining') and waits this long "
                        "for those in flight before exiting")
    add_engine_args(p)
    a = p.parse_args(args)
    check_engine_args(p, a)

    tokenizer, model, cfg, _ = load_pretrained_model(
        a.model_path, model_base=a.model_base, vision_tower_path=a.vision_tower,
        dtype=torch.bfloat16, device=a.device, load_8bit=a.load_8bit, load_4bit=a.load_4bit,
    )
    if tokenizer is None:
        raise SystemExit("could not load a tokenizer; pass --model-base or a "
                         "--model-path with tokenizer files")
    engine = engine_from_args(model, cfg, tokenizer, a, load_draft(a, a.device),
                              load_adapters(a, cfg, a.device))
    server = serve(engine, a.host, a.port, profile_dir=a.profile_dir)
    print(f"serving on {a.host}:{a.port}")

    def graceful(signum, frame):
        # Flag first (handlers answer 503 at once), then stop serve_forever
        # from ANOTHER thread: shutdown() joins the serve loop, which this
        # handler interrupts on the main thread, so calling it here would
        # deadlock.
        engine._draining = True
        print(f"signal {signum}: draining (<= {a.drain_timeout:.0f} s for in-flight requests)")
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, graceful)
    signal.signal(signal.SIGINT, graceful)
    server.serve_forever()
    # Close the LISTENING socket now: shutdown() only stops the accept loop,
    # and a backlog that completes handshakes during the drain would leave
    # clients hanging instead of refused.
    server.server_close()
    clean = engine.drain(timeout=a.drain_timeout)
    engine.close()
    print("drained cleanly" if clean else "drain timeout: exiting with requests still in flight")


if __name__ == "__main__":
    main()
