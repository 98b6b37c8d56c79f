"""Multi-step bursts (`--multi-step N`) of the port against the JAX package,
on the CPU at `tiny_config`.

Both packages run the same f32 weights (through the weight bridge). On the
CPU a burst runs its steps eagerly (the card replays a captured step), so
greedy tokens must equal the JAX package's exactly:

- the paged batcher with `multi_step` against the JAX `generate` of each
  request alone (split and fused pools, f32 and int8 KV, a budget and an EOS
  that fall inside a burst), as `tests/test_paged_batching.py::
  TestMultiStepPaged` and `tests/test_paged_fused.py::
  test_fused_multi_step_and_speculation` hold the JAX batcher;
- the serialized stream's 1→2→4→n ramp against the JAX `generate_stream`
  (`tests/test_generate.py::test_multi_step_stream_token_exact`), and
  `generate`, whose decode loop is one burst, with its EOS padding;
- `_paged_multi_step(n)` against n `_paged_step`s bit for bit in both modes;
- the dense cache's new-token mask, now built without boolean indexing,
  against the indexing it replaces;
- `--multi-step` through `ChatEngine` and the `/chat` server on both paths.
"""

import argparse
import base64
import http.client
import io
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from conftest import MockTokenizer
from torch_port_util import jax_params_numpy, port_config, port_model
from vis_zephyr_tpu.config import tiny_config
from vis_zephyr_tpu.constants import IMAGE_TOKEN_INDEX
from vis_zephyr_tpu.serve import generate as jgen
from vis_zephyr_tpu_torch.models import mistral as tmistral
from vis_zephyr_tpu_torch.serve import api as tapi
from vis_zephyr_tpu_torch.serve import batching as tbatching
from vis_zephyr_tpu_torch.serve import engine as tengine
from vis_zephyr_tpu_torch.serve import generate as tgen
from vis_zephyr_tpu_torch.serve import paged as tpaged

CFG = tiny_config(vocab_size=256)
TCFG = port_config(CFG)
GEOMETRY = dict(max_slots=4, cache_len=64, page_size=16, num_pages=32)


@pytest.fixture(scope="module")
def models():
    params = jax_params_numpy(CFG, 1)
    return params, port_model(params, CFG)


def make_request(rng, T, with_image=True, P=3):
    """(ids [T], images [P, H, H, 3] or None, patch_valid [P] or None), as
    the JAX tests' `make_request`."""
    H = CFG.vision.image_size
    ids = rng.integers(5, CFG.decoder.vocab_size, (T,)).astype(np.int64)
    images = valid = None
    if with_image:
        ids[1] = IMAGE_TOKEN_INDEX
        images = rng.standard_normal((P, H, H, 3)).astype(np.float32)
        valid = np.ones((P,), bool)
    return ids, images, valid


def jax_solo(params, request, max_new_tokens, eos=-1):
    """The JAX package's greedy tokens for one request alone (dense cache)."""
    ids, images, valid = request
    return np.asarray(jgen.generate(
        params, jnp.asarray(ids[None]), None if images is None else jnp.asarray(images[None]),
        None if valid is None else jnp.asarray(valid[None]), CFG,
        jgen.SamplingConfig(max_new_tokens=max_new_tokens, temperature=0.0, eos_token_id=eos),
        cache_len=64)[0])


def run_batcher(batcher, requests, budgets=None):
    budgets = budgets or [None] * len(requests)
    handles = [batcher.submit(ids, im, pv, max_new_tokens=m)
               for (ids, im, pv), m in zip(requests, budgets)]
    batcher.run_until_drained()
    assert not batcher.has_work
    return [list(batcher.stream(h)) for h in handles]


def batcher(port, max_new_tokens, eos=-1, **kw):
    sampling = tgen.SamplingConfig(max_new_tokens=max_new_tokens, temperature=0.0,
                                   eos_token_id=eos)
    return tpaged.PagedBatcher(port, TCFG, sampling=sampling, **{**GEOMETRY, **kw})


# -- the paged batcher ---------------------------------------------------------------


@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32-pools", "int8-pools"])
def test_paged_bursts_match_jax_generate(models, kv_quant):
    """Three requests (the first with an image on f32 pools) in bursts of 4."""
    params, port = models
    rng = np.random.default_rng(0)
    requests = [make_request(rng, T, with_image=not kv_quant and T == 5) for T in (5, 8, 6)]
    b = batcher(port, 6, multi_step=4, kv_quant=kv_quant)
    got = run_batcher(b, requests)
    assert b.bursts > 0
    for request, tokens in zip(requests, got):
        np.testing.assert_array_equal(tokens, jax_solo(params, request, 6))
    assert got == run_batcher(batcher(port, 6, kv_quant=kv_quant), requests)  # single steps
    assert b.allocator.available == GEOMETRY["num_pages"] - 1


def test_paged_budget_exhausts_mid_burst(models):
    """Budgets 3, 6 and 9 against bursts of 4: each slot freezes at its own
    budget inside a burst, and no page leaks."""
    params, port = models
    rng = np.random.default_rng(1)
    requests = [make_request(rng, T, with_image=False) for T in (5, 8, 6)]
    b = batcher(port, 6, multi_step=4)
    got = run_batcher(b, requests, budgets=[3, 6, 9])
    assert not b.active.any() and b.bursts > 0
    for request, tokens, m in zip(requests, got, (3, 6, 9)):
        assert len(tokens) == m
        np.testing.assert_array_equal(tokens, jax_solo(params, request, m))
    assert b.allocator.available == GEOMETRY["num_pages"] - 1
    assert not b.page_table.any()


def test_paged_eos_mid_burst(models):
    """A token the free run first emits at its third place or later as EOS:
    the burst ends the stream where a single step would, before the EOS."""
    params, port = models
    request = make_request(np.random.default_rng(2), 7, with_image=False)
    free_run = [int(t) for t in jax_solo(params, request, 8)]
    first = next(i for i in range(2, 8) if free_run[i] not in free_run[:i])
    eos = free_run[first]
    b = batcher(port, 8, eos=eos, max_slots=2, multi_step=4)
    got = run_batcher(b, [request])[0]
    assert got == free_run[:first]
    assert not b.active.any() and b.bursts > 0


@pytest.mark.parametrize("kw", [dict(multi_step=4), dict(multi_step=3, kv_quant=True)],
                         ids=["f32-ms4", "int8-ms3"])
def test_fused_pool_bursts_match_jax(models, kw):
    """KV-fused pools with bursts (the two multi-step configurations of the
    JAX `test_fused_multi_step_and_speculation`): the split pools' twin's
    tokens, and single steps'. The f32 pools' tokens are the JAX `generate`'s
    of each request alone; int8 pools round K and V, so, as the JAX test
    does, their tokens are pinned to the twin and to the single-stepped
    batcher, which `test_torch_paged_serve.py` holds to the JAX batcher."""
    params, port = models
    rng = np.random.default_rng(3)
    requests = [make_request(rng, T, with_image=T == 5) for T in (5, 8, 6)]
    got = run_batcher(batcher(port, 6, kv_fused=True, **kw), requests)
    assert got == run_batcher(batcher(port, 6, kv_fused=False, **kw), requests)
    single = dict(kw, multi_step=1)
    assert got == run_batcher(batcher(port, 6, kv_fused=True, **single), requests)
    if not kw.get("kv_quant"):
        for request, tokens in zip(requests, got):
            np.testing.assert_array_equal(tokens, jax_solo(params, request, 6))


@pytest.mark.parametrize("mode,quant,fused", [("selfterm", True, True), ("selfterm", False, False),
                                              ("writefirst", True, True),
                                              ("writefirst", False, False)],
                         ids=["selfterm-int8-fused", "selfterm-f32-split", "writefirst-int8-fused",
                              "writefirst-f32-split"])
def test_paged_multi_step_equals_single_steps(models, mode, quant, fused):
    """`_paged_multi_step(n)` against n `_paged_step`s with the carry kept on
    the host: tokens, alive masks, pools, lengths and the last logits bit
    for bit, with one slot's budget and another's EOS inside the burst."""
    _, port = models
    rng = np.random.default_rng(4)
    b = batcher(port, 16, max_slots=4, kv_quant=quant, kv_fused=fused)
    for T in (5, 9, 20):
        b.submit(*make_request(rng, T, with_image=False))
    b._admit_pending()
    active = torch.as_tensor(b.active.copy())
    left = torch.tensor([2, 9, 9, 9], dtype=torch.int32)
    n = 5
    # An EOS that slot 1 emits at its third step.
    probe = [t.clone() if t is not None else None
             for t in (b.kp, b.vp, b.ksp, b.vsp, b.lengths, b.token)]
    for _ in range(3):
        tok, _ = tpaged._paged_step(port, *probe[:2], tuple(probe[2:4]), b.page_table.clone(),
                                    probe[4], probe[5], active, None, TCFG, b.sampling,
                                    mode=mode)
    sampling = tgen.SamplingConfig(max_new_tokens=16, eos_token_id=int(tok[1]))

    state = {name: [t.clone() if t is not None else None
                    for t in (b.kp, b.vp, b.ksp, b.vsp, b.lengths, b.token)]
             for name in ("burst", "steps")}
    kp, vp, ksp, vsp, lengths, token = state["burst"]
    toks, entry, logits = tpaged._paged_multi_step(
        port, kp, vp, (ksp, vsp), b.page_table, lengths, token, active, left, None, TCFG,
        sampling, mode=mode, n=n)
    kp, vp, ksp, vsp, lengths, token = state["steps"]
    alive, steps_left = active.clone(), left.clone()
    want_toks, want_entry = [], []
    for _ in range(n):
        want_entry.append(alive.clone())
        tok, want_logits = tpaged._paged_step(port, kp, vp, (ksp, vsp), b.page_table, lengths,
                                              token, alive, None, TCFG, sampling, mode=mode)
        want_toks.append(tok.clone())
        steps_left -= 1
        alive = alive & (tok != sampling.eos_token_id) & (steps_left > 0)
    assert torch.equal(toks, torch.stack(want_toks))
    assert torch.equal(entry, torch.stack(want_entry))
    assert entry[:, 0].tolist() == [True, True, False, False, False]  # budget 2
    assert entry[:, 1].tolist() == [True, True, True, False, False]   # EOS at step 3
    assert torch.equal(logits, want_logits)
    for got, want in zip(state["burst"], state["steps"]):
        assert (got is None) == (want is None)
        if got is not None:
            assert torch.equal(got, want)


def test_process_burst_emits_like_single_steps():
    """The scheduler's host side of a burst: only entries alive at a step
    count; EOS and the budget finish a slot."""
    b = tbatching.ContinuousBatcher.__new__(tbatching.ContinuousBatcher)
    b.max_slots = 3
    b.sampling = tgen.SamplingConfig(eos_token_id=9)
    b.active = np.array([True, True, False])
    b.budget = np.array([2, 5, 0])
    b.slot_len = np.array([10, 20, 0])
    reqs = [tbatching._Request(i, np.zeros(1, np.int64), None, None, 5) for i in range(3)]
    b.slot_req = list(reqs)
    toks = np.array([[4, 5, 0], [6, 9, 0], [7, 8, 0]])
    alive = np.array([[True, True, False], [True, True, False], [False, False, False]])
    assert b._process_burst(toks, alive) == 4
    got = [[reqs[i].out.get_nowait() for _ in range(reqs[i].out.qsize())] for i in range(3)]
    assert got == [[4, 6, None], [5, None], []]
    assert b.slot_len.tolist() == [12, 21, 0] and not b.active.any()


def test_every_launch_counter_is_registered():
    """Every module-level launch counter of the port (an int named like
    `*launches*` or `*_calls`) is filed in `_kernels.COUNTERS`, the registry
    that the step graphs carry across replays; `generate.verify_calls` too,
    since the dense verify step is replayed on the card."""
    import importlib
    import pkgutil

    import vis_zephyr_tpu_torch
    from vis_zephyr_tpu_torch.ops import _kernels

    found = set()
    for info in pkgutil.walk_packages(vis_zephyr_tpu_torch.__path__, "vis_zephyr_tpu_torch."):
        module = importlib.import_module(info.name)
        found |= {(module.__name__, name) for name, value in vars(module).items()
                  if type(value) is int and ("launches" in name or name.endswith("_calls"))}
    registered = {(module.__name__, name) for module, name in _kernels.COUNTERS}
    assert ("vis_zephyr_tpu_torch.ops.paged_attention", "attn_launches") in found
    assert ("vis_zephyr_tpu_torch.serve.generate", "verify_calls") in found
    assert found == registered


# -- the serialized path -------------------------------------------------------------


@pytest.fixture(scope="module")
def stream_inputs():
    rng = np.random.default_rng(5)
    ids, images, valid = make_request(rng, 9)
    return ids[None], images[None], valid[None]


@pytest.fixture(scope="module")
def jax_stream(models, stream_inputs):
    """The JAX `generate_stream`'s 13 greedy tokens in bursts of 4 (its own
    test holds them equal to single steps, and a shorter budget or an EOS
    to their prefix)."""
    ids, images, valid = (jnp.asarray(a) for a in stream_inputs)
    return [int(t) for t in jgen.generate_stream(
        models[0], ids, images, valid, CFG,
        jgen.SamplingConfig(max_new_tokens=13, temperature=0.0, eos_token_id=-1),
        multi_step=4)]


@pytest.mark.parametrize("case", ["ramp", "eos-mid-burst", "budget-mid-burst"])
def test_stream_bursts_match_jax(models, stream_inputs, jax_stream, case):
    """The 1→2→4→n ramp: 13 tokens (the last burst cut by the budget), the
    same with the first place a token first appears at or after the sixth
    as EOS (inside a burst of 4), and 10 tokens (the budget cuts the ramp's
    burst of 4 to 2)."""
    _, port = models
    free = jax_stream
    first = next(i for i in range(5, 13) if free[i] not in free[:i])
    max_new, eos = {"ramp": (13, -1), "eos-mid-burst": (13, free[first]),
                    "budget-mid-burst": (10, -1)}[case]
    want = free[:first] if case == "eos-mid-burst" else free[:max_new]
    ids, images, valid = (torch.from_numpy(a) for a in stream_inputs)
    sampling = tgen.SamplingConfig(max_new_tokens=max_new, eos_token_id=eos)
    got = list(tgen.generate_stream(port, ids, images, valid, TCFG, sampling, multi_step=4))
    assert got == want
    assert got == list(tgen.generate_stream(port, ids, images, valid, TCFG, sampling))
    assert len(got) == (first if case == "eos-mid-burst" else max_new)


def test_generate_burst_pads_after_eos(models, stream_inputs):
    """`generate` runs its decode loop as one burst: the JAX tokens, and EOS
    in every place after a row's first EOS (the JAX `_decode_loop`'s done
    carry)."""
    params, port = models
    ids, images, valid = stream_inputs
    args = (jnp.asarray(ids), jnp.asarray(images), jnp.asarray(valid), CFG)
    targs = tuple(torch.from_numpy(a) for a in stream_inputs) + (TCFG,)
    free = tgen.generate(port, *targs, tgen.SamplingConfig(max_new_tokens=8, eos_token_id=-1))
    eos = int(free[0, 2])
    first = list(free[0]).index(eos)
    sampling = dict(max_new_tokens=8, temperature=0.0, eos_token_id=eos)
    want = np.asarray(jgen.generate(params, *args, jgen.SamplingConfig(**sampling)))
    got = tgen.generate(port, *targs, tgen.SamplingConfig(**sampling))
    np.testing.assert_array_equal(got, want)
    assert (got[0, first:] == eos).all() and (got[0, :first] == free[0, :first]).all()


# -- the dense cache's mask ------------------------------------------------------------


def test_new_token_mask_equals_boolean_indexing():
    """Padded verify rows (valid proposals then padding), rows whose tail
    runs past the cache's end, and a row at length 0: the fixed-shape mask
    equals the boolean-index assignment it replaced."""
    rng = np.random.default_rng(6)
    B, T, S = 6, 5, 16
    lengths = torch.tensor([0, 3, 9, 11, 13, 16], dtype=torch.int32)
    n_valid = torch.from_numpy(rng.integers(1, T + 1, B))
    valid = torch.arange(T)[None, :] < n_valid[:, None]
    valid[2, 3] = True  # a hole in the middle too
    valid[2, 1] = False
    slot = lengths[:, None].long() + torch.arange(T)[None, :]
    old = torch.ones((B, S), dtype=torch.bool)
    rows = torch.arange(B)[:, None].expand(B, T)
    inside = slot < S
    old[rows[inside], slot[inside]] = valid[inside]
    assert torch.equal(tmistral.new_token_mask(lengths, valid, S), old)
    assert not old.all()


# -- the flag through ChatEngine and /chat ----------------------------------------------


@pytest.fixture(scope="module")
def image():
    pixels = np.random.default_rng(7).integers(0, 255, (60, 80, 3), dtype=np.uint8)
    return Image.fromarray(pixels)


@pytest.fixture(scope="module")
def single_step_reply(models, image):
    """The serialized engine's reply without bursts (`test_torch_serve.py`
    holds it to the JAX engine's)."""
    reply = tengine.ChatEngine(models[1], TCFG, MockTokenizer(), max_new_tokens=6).chat_text(
        "s", "describe the picture", pil_image=image)
    assert reply
    return reply


@pytest.mark.parametrize("path", ["serialized", "paged"])
def test_multi_step_flag_through_server(models, image, single_step_reply, path):
    _, port = models
    parser = argparse.ArgumentParser()
    tapi.add_engine_args(parser)
    assert parser.parse_args([]).multi_step == 1
    paged = ["--continuous-batching", "--kv-cache", "paged", "--kv-quant", "--max-slots", "2",
             "--page-size", "16", "--prefill-chunk", "0"] if path == "paged" else []
    flags = parser.parse_args(paged + ["--max-new-tokens", "6", "--multi-step", "4"])
    engine = tapi.engine_from_args(port, TCFG, MockTokenizer(), flags)
    assert engine.multi_step == 4
    if path == "paged":
        assert engine.batcher.multi_step == 4 and engine.batcher._headroom == 4
    server = tapi.serve(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        buf = io.BytesIO()
        image.save(buf, format="PNG")
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
        conn.request("POST", "/chat", body=json.dumps({
            "session_id": "s", "question": "describe the picture",
            "image_base64": base64.b64encode(buf.getvalue()).decode()}),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        reply = (resp.status, resp.read().decode())
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        engine.close()
    assert reply == (200, single_step_reply)
    if path == "paged":
        assert engine.batcher.bursts > 0
