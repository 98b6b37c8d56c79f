"""The port's paged batcher against the JAX package's, on the CPU at `tiny_config`.

Both packages run the same f32 weights (through the weight bridge) and the
same scripted scenario: requests with and without an image, a prompt longer
than a page, `max_new_tokens` of 0 and 1, two requests submitted while the
first are decoding. Greedy tokens are equal per request; pools, scales, page
table and lengths are compared through the port's layout converters after
every scheduler step (f32 pools and scales to 1e-4, the tolerance of the model
parity tests; int8 values within 1 and almost all equal: the two frameworks' f32 matmuls round
differently through the layers, which can move a value across a rounding
boundary; the ops themselves are held bit for bit in test_torch_paged_ops.py). A JAX
snapshot taken before a decode step goes through the port's `_paged_step`
and lands on the JAX snapshot after it.
"""

import base64
import http.client
import io
import json
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from PIL import Image

from conftest import MockTokenizer
from torch_port_util import jax_params_numpy, port_config, port_model
from vis_zephyr_tpu.config import tiny_config
from vis_zephyr_tpu.constants import IMAGE_TOKEN_INDEX
from vis_zephyr_tpu.serve import engine as jengine
from vis_zephyr_tpu.serve import generate as jgen
from vis_zephyr_tpu.serve import paged as jpaged
from vis_zephyr_tpu_torch.conversation import templates
from vis_zephyr_tpu_torch.ops import paged_attention as tpa
from vis_zephyr_tpu_torch.serve import api as tapi
from vis_zephyr_tpu_torch.serve import batching as tbatching
from vis_zephyr_tpu_torch.serve import engine as tengine
from vis_zephyr_tpu_torch.serve import generate as tgen
from vis_zephyr_tpu_torch.serve import paged as tpaged

CFG = tiny_config(vocab_size=256)
TCFG = port_config(CFG)
EOS = MockTokenizer.eos_token_id
GEOMETRY = dict(max_slots=4, cache_len=64, page_size=16, num_pages=32)
# (kv_quant, kv_fused, prefill_chunk): both pool types, both layouts, both
# admissions against the JAX batcher (each costs its jit compiles, some 15 s);
# the other combinations are held to these inside the port, bit for bit.
CONFIGS = {
    "int8-fused-chunked": (True, True, 16),
    "f32-split-whole": (False, False, None),
}


@pytest.fixture(scope="module")
def models():
    params = jax_params_numpy(CFG, 1)
    return params, port_model(params, CFG)


def scenario():
    """[(ids, images, patch_valid, max_new_tokens, submit before step N)]."""
    rng = np.random.default_rng(0)
    side = CFG.vision.image_size

    def request(T, with_image, max_new=None, at=0):
        ids = rng.integers(5, CFG.decoder.vocab_size, (T,)).astype(np.int64)
        images = valid = None
        if with_image:
            ids[1] = IMAGE_TOKEN_INDEX
            images = rng.standard_normal((3, side, side, 3)).astype(np.float32)
            valid = np.array([True, True, False])
        return ids, images, valid, max_new, at

    return [request(5, True), request(9, False), request(20, False), request(7, False, 1),
            request(6, False, 0), request(8, True, at=3), request(11, False, at=3)]


def drive(batcher, requests, snapshot, max_steps=200):
    """Run the scripted scenario; returns (tokens per request, snapshots
    before each step, snapshots after each step)."""
    handles = {}
    before, after = [], []
    for step in range(max_steps):
        for i, (ids, images, valid, max_new, at) in enumerate(requests):
            if at == step:
                handles[i] = batcher.submit(ids, images, valid, max_new_tokens=max_new)
        if len(handles) == len(requests) and not batcher.has_work:
            break
        before.append(snapshot(batcher))
        batcher.step()
        after.append(snapshot(batcher))
    assert not batcher.has_work
    return [list(batcher.stream(handles[i])) for i in range(len(requests))], before, after


def jax_snapshot(b):
    return dict(pools=tuple(None if a is None else np.asarray(a)
                            for a in (b.kp, b.vp, b.ksp, b.vsp)),
                table=np.asarray(b.page_table), lengths=np.asarray(b.lengths),
                token=np.asarray(b.token), active=b.active.copy())


def port_snapshot(b):
    pools = tpa.pools_to_jax_layout(*(None if a is None else a.numpy().copy()
                                      for a in (b.kp, b.vp, b.ksp, b.vsp)))
    return dict(pools=pools, table=b.page_table.numpy().copy(),
                lengths=b.lengths.numpy().copy(), token=b.token.numpy().copy(),
                active=b.active.copy())


def assert_same_state(got, want, where):
    np.testing.assert_array_equal(got["table"], want["table"], err_msg=where)
    np.testing.assert_array_equal(got["lengths"], want["lengths"], err_msg=where)
    np.testing.assert_array_equal(got["active"], want["active"], err_msg=where)
    np.testing.assert_array_equal(got["token"], want["token"], err_msg=where)
    for name, g, w in zip(("k_pages", "v_pages", "k_scales", "v_scales"),
                          got["pools"], want["pools"]):
        assert (g is None) == (w is None), (where, name)
        if g is None:
            continue
        if g.dtype == np.int8:
            diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1 and (diff != 0).mean() < 1e-3, (where, name, diff.max())
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=f"{where} {name}")


@pytest.fixture(scope="module")
def runs(models):
    """Each configuration's scenario through both packages, run once."""
    params, port = models
    done = {}

    def run(name):
        if name not in done:
            quant, fused, chunk = CONFIGS[name]
            kw = dict(GEOMETRY, kv_quant=quant, kv_fused=fused, prefill_chunk=chunk)
            jb = jpaged.PagedBatcher(
                params, CFG, sampling=jgen.SamplingConfig(max_new_tokens=6, eos_token_id=EOS),
                **kw)
            tb = tpaged.PagedBatcher(
                port, TCFG, sampling=tgen.SamplingConfig(max_new_tokens=6, eos_token_id=EOS),
                **kw)
            done[name] = (drive(jb, scenario(), jax_snapshot),
                          drive(tb, scenario(), port_snapshot), jb, tb)
        return done[name]

    return run


@pytest.mark.parametrize("name", list(CONFIGS))
def test_greedy_tokens_match_jax_batcher(runs, name):
    (want, _, _), (got, _, _), _, tb = runs(name)
    assert got == want
    assert len(want[0]) > 1 and len(want[2]) > 1, "replies too short to mean much"
    assert want[4] == [] and len(want[3]) == 1  # max_new_tokens 0 and 1
    assert not tb.active.any() and tb.allocator.available == GEOMETRY["num_pages"] - 1


@pytest.mark.parametrize("name", list(CONFIGS))
def test_pools_table_and_lengths_match_jax_after_every_step(runs, name):
    (_, _, want), (_, _, got), _, _ = runs(name)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same_state(g, w, f"{name}, after step {i}")
    quant = CONFIGS[name][0]
    assert (want[-1]["pools"][0].dtype == np.int8) == quant
    assert np.abs(want[-1]["pools"][0].astype(np.float32)).max() > 0  # the pools were written


@pytest.mark.parametrize("quant,chunk,like", [(True, 16, "int8-fused-chunked"),
                                              (False, None, "f32-split-whole")],
                         ids=["int8-split-chunked", "f32-fused-whole"])
def test_other_pool_layout_is_bit_exact_with_the_compared_one(runs, models, quant, chunk, like):
    """Split and fused pools hold the same bytes: the same scenario through
    the other layout gives the same tokens and, un-fused, the same pools."""
    fused = not CONFIGS[like][1]
    tb = tpaged.PagedBatcher(
        models[1], TCFG, sampling=tgen.SamplingConfig(max_new_tokens=6, eos_token_id=EOS),
        **dict(GEOMETRY, kv_quant=quant, kv_fused=fused, prefill_chunk=chunk))
    tokens, _, after = drive(tb, scenario(), port_snapshot)
    _, (want_tokens, _, want_after), _, _ = runs(like)
    assert tokens == want_tokens and len(after) == len(want_after)
    ps = GEOMETRY["page_size"]

    def split(pools):
        k, v, ks, vs = pools
        if v is not None:
            return pools
        return (k[:, :, :ps], k[:, :, ps:], None if ks is None else ks[..., :ps],
                None if ks is None else ks[..., ps:])

    for g, w in zip(after, want_after):
        for a, b in zip(split(g["pools"]), split(w["pools"])):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["int8-fused-chunked", "f32-split-whole"])
def test_jax_admission_decodes_in_the_port(runs, models, name):
    """Pools, scales, table and lengths admitted by the JAX package go through
    the converters into the port's `_paged_step`; the step lands on the JAX
    package's own next state."""
    (_, before, after), _, _, _ = runs(name)
    step = next(i for i, s in enumerate(before) if s["active"].sum() >= 2)
    start, want = before[step], after[step]
    pools = [None if a is None else torch.from_numpy(a.copy())
             for a in tpa.pools_from_jax_layout(*start["pools"])]
    table = torch.from_numpy(start["table"].copy())
    lengths = torch.from_numpy(start["lengths"].copy())
    token = torch.from_numpy(start["token"].astype(np.int64))
    tpaged._paged_step(models[1], pools[0], pools[1], (pools[2], pools[3]), table, lengths,
                       token, torch.from_numpy(start["active"]), None, TCFG,
                       tgen.SamplingConfig(max_new_tokens=6, eos_token_id=EOS))
    got = dict(pools=tpa.pools_to_jax_layout(*(None if p is None else p.numpy() for p in pools)),
               table=table.numpy(), lengths=lengths.numpy(), token=token.numpy(),
               active=start["active"])
    # The scheduler step may also have admitted a request; compare the decode
    # step's own work: the slots active before it.
    live = start["active"]
    np.testing.assert_array_equal(got["token"][live], want["token"][live])
    np.testing.assert_array_equal(got["lengths"][live], want["lengths"][live])
    assert (got["lengths"][live] == start["lengths"][live] + 1).all()
    # Row written by the step, read back from both pools: slot b, layer 0.
    ps = GEOMETRY["page_size"]
    for b in np.nonzero(live)[0]:
        n = start["lengths"][b]
        page, row = start["table"][b, n // ps], n % ps
        g, w = got["pools"][0][:, page, row], want["pools"][0][:, page, row]
        if g.dtype == np.int8:
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1
            assert np.abs(g).max() >= 126
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


# -- the scheduler's corner cases, against the port's own `generate` ---------------
# (`generate` is held against the JAX package in test_torch_serve.py.)


def text_request(rng, T):
    return rng.integers(5, CFG.decoder.vocab_size, (T,)).astype(np.int64)


def solo(port, ids, sampling):
    out = tgen.generate(port, torch.from_numpy(ids)[None], None, None, TCFG, sampling)[0]
    return [int(t) for t in out]


@pytest.mark.parametrize("fused,quant", [(False, False), (True, False), (True, True)],
                         ids=["split-f32", "fused-f32", "fused-int8"])
def test_page_reuse_across_requests(models, fused, quant):
    """More requests than the pool holds at once: freed pages go to later
    requests, and (f32 pools) outputs stay those of a solo run."""
    port = models[1]
    sampling = tgen.SamplingConfig(max_new_tokens=4, eos_token_id=-1)
    b = tpaged.PagedBatcher(port, TCFG, max_slots=2, cache_len=32, page_size=16,
                            sampling=sampling, num_pages=5, kv_fused=fused, kv_quant=quant)
    rng = np.random.default_rng(1)
    requests = [text_request(rng, 4 + i) for i in range(5)]
    handles = [b.submit(ids) for ids in requests]
    b.run_until_drained()
    for ids, h in zip(requests, handles):
        got = list(b.stream(h))
        assert len(got) == 4
        if not quant:
            assert got == solo(port, ids, sampling)
    assert not b.active.any() and b.allocator.available == 4  # everything released
    assert not b.page_table.any()


def test_pool_exhaustion_requeues(models):
    sampling = tgen.SamplingConfig(max_new_tokens=17, eos_token_id=-1)
    # Each request needs ceil((len + 17) / 16) = 2 pages; the pool has 2 usable.
    b = tpaged.PagedBatcher(models[1], TCFG, max_slots=4, cache_len=48, page_size=16,
                            sampling=sampling, num_pages=3)
    rng = np.random.default_rng(2)
    h1, h2 = b.submit(text_request(rng, 5)), b.submit(text_request(rng, 6))
    b.step()
    assert b.active.sum() == 1 and len(b._requeued) == 1  # re-queued, not dropped
    b.run_until_drained()
    assert len(list(b.stream(h1))) == 17 and len(list(b.stream(h2))) == 17


@pytest.mark.parametrize("chunk", [None, 16], ids=["whole", "chunked"])
def test_too_long_request_rejected(models, chunk):
    b = tpaged.PagedBatcher(models[1], TCFG, max_slots=2, cache_len=32, page_size=16,
                            sampling=tgen.SamplingConfig(max_new_tokens=200, eos_token_id=-1),
                            num_pages=8, prefill_chunk=chunk)
    h = b.submit(text_request(np.random.default_rng(3), 10))
    b.run_until_drained()
    assert list(b.stream(h)) == [] and b.allocator.available == 7


def test_eos_on_the_first_token_finishes_at_once(models):
    port = models[1]
    ids = text_request(np.random.default_rng(4), 7)
    first = solo(port, ids, tgen.SamplingConfig(max_new_tokens=1, eos_token_id=-1))[0]
    b = tpaged.PagedBatcher(port, TCFG, max_slots=2, cache_len=32, page_size=16,
                            sampling=tgen.SamplingConfig(max_new_tokens=5, eos_token_id=first),
                            num_pages=8)
    h = b.submit(ids)
    b.run_until_drained()
    assert list(b.stream(h)) == [] and b.steps == 0 and b.allocator.available == 7


def test_cancel_frees_the_slot_and_its_pages(models):
    sampling = tgen.SamplingConfig(max_new_tokens=30, eos_token_id=-1)
    b = tpaged.PagedBatcher(models[1], TCFG, max_slots=2, cache_len=96, page_size=16,
                            sampling=sampling, num_pages=16, prefill_chunk=16)
    rng = np.random.default_rng(5)
    running, queued = b.submit(text_request(rng, 6)), b.submit(text_request(rng, 40))
    for _ in range(3):
        b.step()               # `running` decodes, `queued` is mid-prefill
    assert b.active.sum() == 1 and b._prefilling is not None
    b.cancel(running)
    b.cancel(queued)
    b.run_until_drained()
    assert 0 < len(list(b.stream(running))) < 30 and list(b.stream(queued)) == []
    assert not b.active.any() and b.allocator.available == 15 and b._reserved_slot is None


def test_sampled_decoding_is_seeded_and_in_range(models):
    """Temperature sampling cannot reproduce the JAX package's draws (another
    generator); it is held to shape, range and determinism under a seed."""
    def run(seed):
        b = tpaged.PagedBatcher(
            models[1], TCFG, seed=seed, sampling=tgen.SamplingConfig(
                max_new_tokens=8, temperature=0.9, top_p=0.9, eos_token_id=-1), **GEOMETRY)
        rng = np.random.default_rng(6)
        handles = [b.submit(text_request(rng, 6 + i)) for i in range(3)]
        b.run_until_drained()
        return [list(b.stream(h)) for h in handles]

    a, again, other = run(0), run(0), run(1)
    assert a == again and a != other
    assert all(len(r) == 8 and all(0 <= t < CFG.decoder.vocab_size for t in r) for r in a)


def test_left_out_options_raise_not_implemented(models):
    port = models[1]
    kw = dict(GEOMETRY, sampling=tgen.SamplingConfig(max_new_tokens=2))
    for option in (dict(mesh=object()), dict(metrics=object()), dict(draft=object()),
                   dict(draft=object(), lookahead=2), dict(prefix_cache=True),
                   dict(mlora=object()), dict(adapter_names={"a": 1}), dict(lazy_alloc=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tpaged.PagedBatcher(port, TCFG, **kw, **option)
    for option in ({}, dict(lookahead=2), dict(multi_step=4)):
        with pytest.raises(NotImplementedError, match="dense"):
            tbatching.ContinuousBatcher(port, TCFG, **option)
    b = tpaged.PagedBatcher(port, TCFG, **kw)
    ids = np.array([5, 6, 7])
    for option in (dict(adapter="lora-a"), dict(temperature=0.5), dict(top_p=0.5),
                   dict(grammar=object()), dict(logprobs=2), dict(frequency_penalty=0.5),
                   dict(presence_penalty=0.5)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            b.submit(ids, **option)
    step = (port, b.kp, b.vp, (b.ksp, b.vsp), b.page_table, b.lengths, b.token,
            torch.zeros(4, dtype=torch.bool), None, TCFG, kw["sampling"])
    for option in (dict(mesh=object()), dict(mlora=object()),
                   dict(adapter_idx=object()), dict(sample_overrides=(1, 1)),
                   dict(grammar=(1, 1)), dict(want_logprobs=True), dict(penalties=(1, 1, 1))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tpaged._paged_step(*step, **option)
    # Two modes exist (writefirst is held in test_torch_paged_single.py); an
    # unknown one is refused, where the JAX step would take it as writefirst.
    with pytest.raises(ValueError, match="selfterm"):
        tpaged._paged_step(*step, mode="write-first")
    for option in (dict(continuous_batching=True, kv_cache="dense"),
                   dict(continuous_batching=True, kv_cache="dense", lookahead=2),
                   dict(draft_params=object(), lookahead=2),
                   dict(continuous_batching=True, kv_cache="dense", multi_step=2),
                   dict(mesh=object()), dict(metrics=object()),
                   dict(continuous_batching=True, kv_cache="paged", draft_params=object()),
                   dict(continuous_batching=True, kv_cache="paged", prefix_cache=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tengine.ChatEngine(port, TCFG, MockTokenizer(), **option)


# -- /chat with the paged flags, concurrent clients ------------------------------------

QUESTIONS = ["describe the picture", "what colour is it", "count the objects",
             "is it day or night", "name the largest thing"]


def warmed_tokenizer():
    """A MockTokenizer that has seen every prompt in a fixed order: it numbers
    words as they arrive, and concurrent clients arrive in any order."""
    tok = MockTokenizer()
    for q in QUESTIONS:
        conv = templates["zephyr_v1"].copy()
        conv.append_message(conv.roles[0], "<image>\n" + q)
        conv.append_message(conv.roles[1], None)
        tok(conv.get_prompt().replace("<image>", " "))
    return tok


def test_paged_chat_server_with_concurrent_clients_matches_jax_engine(models):
    params, port = models
    flags = dict(max_new_tokens=6, continuous_batching=True, max_slots=4, cache_len=256,
                 kv_cache="paged", kv_quant=True, kv_fused=True, page_size=16,
                 prefill_chunk=64)
    rng = np.random.default_rng(7)
    images = [Image.fromarray(rng.integers(0, 255, (60, 80, 3), dtype=np.uint8))
              for _ in QUESTIONS]

    jeng = jengine.ChatEngine(params, CFG, warmed_tokenizer(), **flags)
    try:
        with ThreadPoolExecutor(len(QUESTIONS)) as pool:
            want = list(pool.map(lambda i: jeng.chat_text(f"s{i}", QUESTIONS[i], images[i]),
                                 range(len(QUESTIONS))))
    finally:
        jeng.close()
    assert all(want), "the JAX engine replied nothing; pick another seed"

    a = tapi.argparse.ArgumentParser()
    tapi.add_engine_args(a)
    args = a.parse_args(["--continuous-batching", "--kv-cache", "paged", "--kv-quant",
                         "--max-slots", "4", "--page-size", "16", "--prefill-chunk", "64",
                         "--max-new-tokens", "6"])
    assert args.kv_fused and args.num_pages is None  # the JAX server's defaults
    teng = tapi.engine_from_args(port, TCFG, warmed_tokenizer(), args)
    assert isinstance(teng.batcher, tpaged.PagedBatcher) and teng.batcher.kv_fused
    assert teng.batcher.cache_len == 2048
    teng.close()
    teng = tengine.ChatEngine(port, TCFG, warmed_tokenizer(), **flags)
    server = tapi.serve(teng, "127.0.0.1", 0)
    port_no = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def post(i):
        buf = io.BytesIO()
        images[i].save(buf, format="PNG")
        conn = http.client.HTTPConnection("127.0.0.1", port_no, timeout=120)
        conn.request("POST", "/chat", body=json.dumps(
            {"session_id": f"s{i}", "question": QUESTIONS[i],
             "image_base64": base64.b64encode(buf.getvalue()).decode()}),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = resp.read().decode()
        conn.close()
        return resp.status, body

    try:
        with ThreadPoolExecutor(len(QUESTIONS)) as pool:
            got = list(pool.map(post, range(len(QUESTIONS))))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        teng.close()
    assert got == [(200, w) for w in want]
    b = teng.batcher
    assert not b.has_work and b.allocator.available == b.num_pages - 1
    assert b.slots_stepped > b.steps > 0  # requests did share decode steps


# -- the page allocator (the cases of the JAX package's allocator tests) --------------------


def test_allocator_reserves_trash_page_and_prefers_runs():
    a = tpaged.PageAllocator(4)
    got = a.alloc(3)
    assert sorted(got) == [1, 2, 3] and a.alloc(1) is None  # page 0 never handed out
    a.release(got)
    assert a.available == 3
    with pytest.raises(KeyError):
        a.release([1])  # not held
    a = tpaged.PageAllocator(16)
    r1, r2 = a.alloc(4), a.alloc(4)
    assert r1 == [1, 2, 3, 4] and r2 == [5, 6, 7, 8]
    a.release(r1)
    assert a.alloc(3) == [1, 2, 3]                   # fits the released hole
    assert a.alloc(5) == [9, 10, 11, 12, 13]         # the first run of 5


def test_allocator_falls_back_to_scattered_pages():
    a, j = tpaged.PageAllocator(8), jpaged.PageAllocator(8)
    for alloc in (a, j):
        held = alloc.alloc(3)
        alloc.alloc(4)
        alloc.release([held[0], held[2]])            # free: {1, 3}, no run of 2
    assert a.alloc(2) == j.alloc(2) == [1, 3]
    assert a.available == j.available == 0
