"""PyTorch port serving path against the JAX package, on the CPU.

Greedy decoding is compared token for token: `generate` and
`generate_stream` with an image, a two-turn `ChatEngine.chat` with the mock
tokenizer, and the port's `/chat` server streaming that same text. Both
packages run the same f32 `tiny_config` weights (the port loads them through
the weight bridge). Host image preprocessing is compared bit for bit, and
sampled tokens are held to the top-p nucleus. A last test checks, in a fresh
interpreter, that the port's serving modules and a generation never import
jax.
"""

import base64
import http.client
import io
import json
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from conftest import MockTokenizer
from vis_zephyr_tpu.config import tiny_config
from vis_zephyr_tpu.constants import IMAGE_TOKEN_INDEX
from vis_zephyr_tpu.data import image_pipeline as jpipe
from vis_zephyr_tpu.models.vis_zephyr import init_vis_zephyr as jax_init
from vis_zephyr_tpu.serve import engine as jengine
from vis_zephyr_tpu.serve import generate as jgen
from vis_zephyr_tpu_torch.data import image_pipeline as tpipe
from vis_zephyr_tpu_torch.models.convert import state_dict_from_jax
from vis_zephyr_tpu_torch.models.vis_zephyr import VisZephyr
from vis_zephyr_tpu_torch.serve import api as tapi
from vis_zephyr_tpu_torch.serve import engine as tengine
from vis_zephyr_tpu_torch.serve import generate as tgen
from torch_port_util import port_config

CFG = tiny_config(vocab_size=256)
TCFG = port_config(CFG)  # the port's own dataclasses, field for field
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURNS = ["describe the picture", "what colour is it"]


@pytest.fixture(scope="module")
def models():
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jax_init, static_argnums=(0,))(CFG, jax.random.PRNGKey(1)))
    port = VisZephyr(TCFG)
    port.load_state_dict(state_dict_from_jax(params, TCFG), strict=True)
    return params, port.requires_grad_(False).eval()


@pytest.fixture(scope="module")
def image():
    pixels = np.random.default_rng(0).integers(0, 255, (60, 80, 3), dtype=np.uint8)
    return Image.fromarray(pixels)


@pytest.fixture(scope="module")
def jax_chat(models, image):
    """The JAX engine's replies to TURNS in one session."""
    engine = jengine.ChatEngine(models[0], CFG, MockTokenizer(), max_new_tokens=6)
    replies = [engine.chat_text("s", q, pil_image=image if i == 0 else None)
               for i, q in enumerate(TURNS)]
    assert replies[0], "the JAX engine replied nothing; pick another seed"
    return replies


@pytest.mark.parametrize("mode", ["anyres", "pad", "resize", "square"])
def test_host_preprocess_matches_jax(image, mode):
    if mode == "anyres":
        want = jpipe.anyres_preprocess_host(image, CFG.mm_grid_pinpoints, CFG.vision.image_size)
        got = tpipe.anyres_preprocess_host(image, CFG.mm_grid_pinpoints, CFG.vision.image_size)
    else:
        want = [jpipe.preprocess_mode_host(image, mode, CFG.vision.image_size)]
        got = [tpipe.preprocess_mode_host(image, mode, CFG.vision.image_size)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_sampling_stays_in_the_top_p_nucleus():
    """Temperature + top-p draws only from the JAX rule's nucleus (the
    smallest set of sorted tokens whose cumulative probability reaches
    top_p); greedy is the first maximum."""
    logits = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 50)).astype(np.float32))
    sampling = tgen.SamplingConfig(temperature=0.7, top_p=0.6)
    scaled = np.asarray(logits) / sampling.temperature
    srt = -np.sort(-scaled, axis=-1)
    probs = np.exp(srt - srt.max(-1, keepdims=True))
    cum = np.cumsum(probs / probs.sum(-1, keepdims=True), axis=-1)
    cutoff = np.take_along_axis(srt, (cum < sampling.top_p).sum(-1, keepdims=True), axis=-1)
    nucleus = scaled >= cutoff
    gen = torch.Generator().manual_seed(0)
    for _ in range(50):
        draw = tgen._sample(logits, gen, sampling).numpy()
        assert nucleus[np.arange(4), draw].all()
    greedy = tgen._sample(logits, None, tgen.SamplingConfig())
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(logits).argmax(-1))


def test_generate_greedy_tokens_match_jax(models, image):
    params, port = models
    ids = np.array([[1, 5, IMAGE_TOKEN_INDEX, 7, 9, 11]], np.int64)
    pixels, valid = tpipe.anyres_preprocess_host(image, CFG.mm_grid_pinpoints,
                                                 CFG.vision.image_size)
    sampling = jgen.SamplingConfig(max_new_tokens=8)
    want = jgen.generate(params, ids, pixels[None], valid[None], CFG, sampling)
    want_stream = list(jgen.generate_stream(params, ids, pixels[None], valid[None], CFG, sampling))

    args = (port, torch.from_numpy(ids), torch.from_numpy(pixels)[None],
            torch.from_numpy(valid)[None], TCFG, tgen.SamplingConfig(max_new_tokens=8))
    np.testing.assert_array_equal(tgen.generate(*args), want)
    assert list(tgen.generate_stream(*args)) == want_stream


def test_chat_engine_two_turns_match_jax(models, image, jax_chat):
    engine = tengine.ChatEngine(models[1], TCFG, MockTokenizer(), max_new_tokens=6)
    replies = [engine.chat_text("s", q, pil_image=image if i == 0 else None)
               for i, q in enumerate(TURNS)]
    assert replies == jax_chat


def _post(port, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/chat", body=json.dumps(payload),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = resp.read().decode()
    conn.close()
    return resp.status, body


def test_chat_server_streams_jax_text(models, image, jax_chat):
    engine = tengine.ChatEngine(models[1], TCFG, MockTokenizer(), max_new_tokens=6)
    server = tapi.serve(engine, "127.0.0.1", 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        buf = io.BytesIO()
        image.save(buf, format="PNG")
        b64 = base64.b64encode(buf.getvalue()).decode()
        assert _post(port, {"session_id": "new", "question": "hi"})[0] == 400  # no image
        first = _post(port, {"session_id": "s", "question": TURNS[0], "image_base64": b64})
        second = _post(port, {"session_id": "s", "question": TURNS[1]})
        assert [first, second] == [(200, jax_chat[0]), (200, jax_chat[1])]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def test_serving_modules_leave_jax_unimported():
    code = "\n".join([
        "import sys, torch",
        "import vis_zephyr_tpu_torch.serve.api, vis_zephyr_tpu_torch.serve.cli",
        "from vis_zephyr_tpu_torch.config import tiny_config",
        "from vis_zephyr_tpu_torch.models.vis_zephyr import init_vis_zephyr",
        "from vis_zephyr_tpu_torch.serve.generate import SamplingConfig, generate",
        "cfg = tiny_config()",
        "model = init_vis_zephyr(cfg, torch.Generator().manual_seed(0))",
        "out = generate(model, torch.tensor([[1, 5, -200, 7]]), torch.zeros(1, 4, 56, 56, 3),",
        "               torch.tensor([[True, True, False, False]]), cfg, SamplingConfig(max_new_tokens=3))",
        "assert out.shape == (1, 3), out.shape",
        "assert 'jax' not in sys.modules, 'jax was imported'",
        "assert 'vis_zephyr_tpu' not in sys.modules, 'the JAX package was imported'",
    ])
    env = {k: v for k, v in os.environ.items() if k != "VZT_PLATFORM"}
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
