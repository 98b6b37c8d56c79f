"""Streaming HTTP chat server (stdlib `ThreadingHTTPServer`).

Port of the `/chat` endpoint of `vis_zephyr_tpu/serve/api.py`: POST /chat
with ``{"session_id": str, "image_base64": str?, "question": str}`` →
chunked text/plain stream of the reply; the first request of a session must
carry the image unless one is already attached. The OpenAI endpoints,
health, metrics, profiling and draining are not ported yet.
"""

from __future__ import annotations

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


def serve(engine: ChatEngine, host: str = "0.0.0.0", port: int = 8000) -> ThreadingHTTPServer:
    handler = type("BoundChatHandler", (ChatHandler,), {"engine": engine})
    server = ThreadingHTTPServer((host, port), handler)
    # Handler threads must not block interpreter exit (a client that never
    # drains its stream would otherwise pin a thread).
    server.daemon_threads = True
    return server


def main(args=None):
    import argparse

    import torch

    from ..models.builder import load_pretrained_model

    p = argparse.ArgumentParser(description="Vis-Zephyr HTTP server (PyTorch)")
    p.add_argument("--model-path", required=True)
    p.add_argument("--model-base", default=None)
    p.add_argument("--vision-tower", default=None)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--max-new-tokens", type=int, default=512)
    a = p.parse_args(args)

    tokenizer, model, cfg, _ = load_pretrained_model(
        a.model_path, model_base=a.model_base, vision_tower_path=a.vision_tower,
        dtype=torch.bfloat16, device="cuda",
    )
    if tokenizer is None:
        raise SystemExit("could not load a tokenizer; pass --model-base or a "
                         "--model-path with tokenizer files")
    engine = ChatEngine(model, cfg, tokenizer, temperature=a.temperature,
                        max_new_tokens=a.max_new_tokens)
    server = serve(engine, a.host, a.port)
    print(f"serving on {a.host}:{a.port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
