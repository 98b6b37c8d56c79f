"""Streaming HTTP chat server (stdlib `ThreadingHTTPServer`).

Port of the `/chat` endpoint of `vis_zephyr_tpu/serve/api.py`: POST /chat
with ``{"session_id": str, "image_base64": str?, "question": str}`` →
chunked text/plain stream of the reply; the first request of a session must
carry the image unless one is already attached. With
`--continuous-batching --kv-cache paged` requests of different sessions share
decode steps over paged KV pools (`--kv-quant`, `--kv-fused`, `--page-size`,
`--num-pages`, `--max-slots`, `--prefill-chunk`, defaults as in the JAX
server). `--lookahead N` (prompt-lookup speculation) and `--multi-step N`
(bursts of N decode steps) reach both paths. `--load-8bit` serves int8
weights on either path. The OpenAI
endpoints, health, metrics, profiling and draining are not ported yet.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .engine import ChatEngine


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
    return None, engine.chat(session_id, question, pil_image=image)


class ChatHandler(BaseHTTPRequestHandler):
    engine: ChatEngine = None  # injected by serve()

    def log_message(self, *args):  # quiet
        pass

    def do_POST(self):
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, json.JSONDecodeError):
            self._json(400, {"error": "invalid JSON"})
            return
        if self.path.rstrip("/") != "/chat":
            self.send_error(404)
            return
        error, stream = _handle_chat(self.engine, payload)
        if error is not None:
            self._json(400, error)
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; charset=utf-8")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Access-Control-Allow-Origin", "*")
        self.end_headers()
        try:
            for chunk in stream:
                data = chunk.encode("utf-8")
                self.wfile.write(f"{len(data):X}\r\n".encode())
                self.wfile.write(data + b"\r\n")
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            stream.close()  # client gone: stop decoding now

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


def serve(engine: ChatEngine, host: str = "0.0.0.0", port: int = 8000) -> ThreadingHTTPServer:
    handler = type("BoundChatHandler", (ChatHandler,), {"engine": engine})
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
                   help="paged: shared page pools (memory follows the tokens in flight)")
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
                   help="prompt-lookup speculative decoding span (greedy only; 0 disables): "
                        "the serialized path and the paged continuous batcher")
    p.add_argument("--multi-step", type=int, default=1,
                   help="decode steps per burst (multi-step scheduling): the serialized path "
                        "ramps 1, 2, 4, N; the paged batcher bursts when no admission work "
                        "waits; one copy to the host a burst, each step a CUDA-graph replay "
                        "on the card; token-exact under greedy. Ignored with --lookahead")


def engine_from_args(model, cfg, tokenizer, a) -> ChatEngine:
    """The `ChatEngine` the parsed flags `a` ask for."""
    return ChatEngine(model, cfg, tokenizer, temperature=a.temperature,
                      max_new_tokens=a.max_new_tokens,
                      continuous_batching=a.continuous_batching, max_slots=a.max_slots,
                      kv_cache=a.kv_cache, kv_quant=a.kv_quant, num_pages=a.num_pages,
                      prefill_chunk=a.prefill_chunk or None, kv_fused=a.kv_fused,
                      page_size=a.page_size, lookahead=a.lookahead, multi_step=a.multi_step)


def main(args=None):
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
    add_engine_args(p)
    a = p.parse_args(args)

    tokenizer, model, cfg, _ = load_pretrained_model(
        a.model_path, model_base=a.model_base, vision_tower_path=a.vision_tower,
        dtype=torch.bfloat16, device="cuda", load_8bit=a.load_8bit, load_4bit=a.load_4bit,
    )
    if tokenizer is None:
        raise SystemExit("could not load a tokenizer; pass --model-base or a "
                         "--model-path with tokenizer files")
    engine = engine_from_args(model, cfg, tokenizer, a)
    server = serve(engine, a.host, a.port)
    print(f"serving on {a.host}:{a.port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        engine.close()


if __name__ == "__main__":
    main()
