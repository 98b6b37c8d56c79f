"""The port's lazy page allocation with host-swap preemption (`PagedBatcher`
with `lazy_alloc`, `serve/paged.py`) on the CPU at `tiny_config`.

The invariant, as in the JAX package's tests: a lazy batcher on a pool too
small for every request's full span gives the tokens of an eager batcher on
an ample pool, bit for bit, however much swapping the small pool forces;
the swap moves raw pool bytes, so its round trip is bit-exact in every
layout. Besides: the JAX package's lazy batcher gives the same tokens and
swap counts on the same f32 weights; admission never takes a parked slot;
growth at the `cache_len` edge is clamped; the fixed buffers that the card's
captured steps read keep their addresses across growth and swaps; a slot
cancelled while parked finishes; the engine and the server take the flags,
and GET /metrics shows the preemption and prefix-cache counts.
"""

import argparse
import http.client
import json
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from conftest import MockTokenizer
from torch_port_util import jax_params_numpy, port_config, port_model
from vis_zephyr_tpu.config import tiny_config
from vis_zephyr_tpu.serve import generate as jgen
from vis_zephyr_tpu.serve import paged as jpaged
from vis_zephyr_tpu.utils.metrics import ServingMetrics as JServingMetrics
from vis_zephyr_tpu_torch.serve import api as tapi
from vis_zephyr_tpu_torch.serve import draft as tdraft
from vis_zephyr_tpu_torch.serve import engine as tengine
from vis_zephyr_tpu_torch.serve import generate as tgen
from vis_zephyr_tpu_torch.serve import paged as tpaged
from vis_zephyr_tpu_torch.serve.graphs import addresses
from vis_zephyr_tpu_torch.utils.metrics import ServingMetrics

CFG = tiny_config(vocab_size=256)
TCFG = port_config(CFG)
# 4 slots x 40 new tokens from 5- to 9-token prompts: 3 pages each at the
# peak (12 in all) against 8 usable pages; admission fits all four at 1 or 2
# pages, and growth then forces swaps again and again.
GEOMETRY = dict(max_slots=4, cache_len=64, page_size=16)
SMALL, AMPLE = 9, 64


@pytest.fixture(scope="module")
def models():
    params = jax_params_numpy(CFG, 3)
    return params, port_model(params, CFG)


def requests(seed: int, lengths=(7, 5, 9, 6)):
    rng = np.random.default_rng(seed)
    return [rng.integers(5, 60, (n,)) for n in lengths]


def run_paged(port, reqs, *, num_pages, lazy, max_new=40, metrics=None, submit=None, **kw):
    b = tpaged.PagedBatcher(port, TCFG, num_pages=num_pages, lazy_alloc=lazy, metrics=metrics,
                            sampling=tgen.SamplingConfig(max_new_tokens=max_new,
                                                         eos_token_id=-1),
                            **dict(GEOMETRY, **kw))
    handles = [b.submit(ids, **(submit or {})) for ids in reqs]
    b.run_until_drained(max_steps=1000)  # some 200 steps at most: a stall fails, not hangs
    assert not b.has_work and not b._swapped
    assert b.allocator.available == num_pages - 1 and not b.page_table.any()
    # Read without blocking: a stream that never ended fails here.
    outs = [list(h.out.queue) for h in handles]
    assert all(out and out[-1] is None for out in outs)
    return [out[:-1] for out in outs]


CHURN = {"f32": dict(), "int8": dict(kv_quant=True),
         "int8-fused": dict(kv_quant=True, kv_fused=True), "multi-step": dict(multi_step=3),
         "lookahead": dict(lookahead=2), "chunked": dict(prefill_chunk=16),
         "draft": dict(lookahead=2, draft=True),
         "penalties": dict(submit=dict(frequency_penalty=0.5, presence_penalty=0.3))}


@pytest.mark.parametrize("name", list(CHURN))
def test_lazy_equals_eager_under_churn(models, name):
    port = models[1]
    kw = dict(CHURN[name])

    def options():
        # A draft model per batcher: its dense cache holds the slots' rows,
        # which a parked slot keeps.
        out = dict(kw)
        if out.pop("draft", False):
            out["draft"] = tdraft.DraftModel(port, TCFG, max_slots=GEOMETRY["max_slots"],
                                             cache_len=GEOMETRY["cache_len"])
        return out

    reqs = requests(0)
    eager_metrics, metrics = ServingMetrics(), ServingMetrics()
    eager = run_paged(port, reqs, num_pages=AMPLE, lazy=False, metrics=eager_metrics,
                      **options())
    lazy = run_paged(port, reqs, num_pages=SMALL, lazy=True, metrics=metrics, **options())
    assert lazy == eager and all(len(r) == 40 for r in lazy)
    assert metrics.preempt_swap_out > 0 and metrics.preempt_swap_in > 0
    # A slot's proposals depend on its own draft rows and history alone: a
    # parked slot keeps both, so the proposals and acceptances are eager's.
    assert ((metrics.spec_proposed, metrics.spec_accepted)
            == (eager_metrics.spec_proposed, eager_metrics.spec_accepted))
    if "lookahead" in kw:
        assert metrics.spec_proposed > 0
    assert metrics.summary()["preemption"] == {"swap_out": metrics.preempt_swap_out,
                                               "swap_in": metrics.preempt_swap_in}


def test_lazy_matches_jax_lazy_batcher(models):
    """The same f32 weights and scenario through both packages' lazy
    batchers: the same tokens and the same swaps, out and in."""
    params, port = models
    reqs = requests(0)
    jm = JServingMetrics()
    jb = jpaged.PagedBatcher(params, CFG, num_pages=SMALL, lazy_alloc=True, metrics=jm,
                             sampling=jgen.SamplingConfig(max_new_tokens=40, eos_token_id=-1),
                             **GEOMETRY)
    handles = [jb.submit(ids, None, None) for ids in reqs]
    jb.run_until_drained()
    want = [list(jb.stream(h)) for h in handles]
    tm = ServingMetrics()
    assert run_paged(port, reqs, num_pages=SMALL, lazy=True, metrics=tm) == want
    assert (tm.preempt_swap_out, tm.preempt_swap_in) == (jm.preempt_swap_out, jm.preempt_swap_in)
    assert tm.preempt_swap_out > 0


def test_more_requests_than_slots_under_churn(models):
    """Admission must not take a parked slot (inactive, yet it owns its
    request): with more requests than slots every stream completes as
    eagerly."""
    port = models[1]
    reqs = requests(1, (7, 5, 9, 6, 8, 5))
    eager = run_paged(port, reqs, num_pages=AMPLE, lazy=False)
    metrics = ServingMetrics()
    assert run_paged(port, reqs, num_pages=SMALL, lazy=True, metrics=metrics) == eager
    assert metrics.preempt_swap_out > 0


def test_growth_at_the_cache_len_edge(models):
    """Length plus a burst's headroom past cache_len is clamped to the row's
    width (multi-step 3, prompt + budget = cache_len)."""
    port = models[1]
    reqs = requests(2, (8,))
    eager = run_paged(port, reqs, num_pages=AMPLE, lazy=False, max_new=56, multi_step=3)
    lazy = run_paged(port, reqs, num_pages=AMPLE, lazy=True, max_new=56, multi_step=3)
    assert lazy == eager and len(lazy[0]) == 56


def test_small_eager_pool_queues_instead(models):
    """The same small pool without `lazy_alloc`: admission waits for whole
    spans, and the tokens stay those of the ample pool."""
    port = models[1]
    reqs = requests(0)
    assert (run_paged(port, reqs, num_pages=SMALL, lazy=False)
            == run_paged(port, reqs, num_pages=AMPLE, lazy=False))


def started(port, quant=False, fused=False, max_new=8, prompt=20):
    b = tpaged.PagedBatcher(port, TCFG, num_pages=16, lazy_alloc=True, kv_quant=quant,
                            kv_fused=fused, max_slots=2, cache_len=64, page_size=16,
                            sampling=tgen.SamplingConfig(max_new_tokens=max_new,
                                                         eos_token_id=-1))
    h = b.submit(np.random.default_rng(4).integers(5, 60, (prompt,)))
    b.step()  # admission and one decode step
    return b, h, int(np.nonzero(b.active)[0][0])


@pytest.mark.parametrize("quant,fused", [(False, False), (False, True), (True, False),
                                         (True, True)],
                         ids=["f32-split", "f32-fused", "int8-split", "int8-fused"])
def test_pool_rows_round_trip_is_bit_exact(models, quant, fused):
    """Swap-out and swap-in by hand, into other pages: the restored rows (and
    scale rows) equal the originals bit for bit, and the slot decodes on as
    a batcher that was never swapped."""
    port = models[1]
    b, h, slot = started(port, quant, fused)
    pages0 = list(b.slot_pages[slot])
    names = [n for n in ("kp", "vp", "ksp", "vsp") if getattr(b, n) is not None]
    before = {n: tpaged._pool_rows_get(getattr(b, n), b._swap_idx(pages0)).clone()
              for n in names}
    token = int(b.token[slot])
    b._swap_out(slot)
    assert not b.active[slot] and b.slot_pages[slot] == [] and not b.page_table[slot].any()
    blocker = b.allocator.alloc(1)  # the slot comes back on other pages
    b._try_swap_in()
    assert b.active[slot] and int(b.token[slot]) == token
    pages1 = b.slot_pages[slot][:len(pages0)]
    assert pages1 != pages0
    for n in names:
        got = tpaged._pool_rows_get(getattr(b, n), b._swap_idx(pages1))
        assert got.dtype == before[n].dtype and bool((got == before[n]).all()), n
    b.allocator.release(blocker)
    b.run_until_drained()
    again, h2, _ = started(port, quant, fused)
    again.run_until_drained()
    assert list(b.stream(h)) == list(again.stream(h2))


def test_cancel_while_swapped(models):
    port = models[1]
    b, h, slot = started(port)
    b._swap_out(slot)
    b.cancel(h)
    b.step()  # `_try_swap_in` finishes it
    assert not b._swapped and not b.active.any() and b.slot_req[slot] is None
    assert len(list(b.stream(h))) == 2  # its first token and one decode step's
    assert b.allocator.available == 15


def test_fixed_buffers_keep_their_addresses_across_swaps(models):
    """Growth, swap-out and swap-in write the table, lengths, tokens and pools
    in place: the card's captured steps keep reading the same tensors."""
    port = models[1]
    b = tpaged.PagedBatcher(port, TCFG, num_pages=SMALL, lazy_alloc=True, kv_quant=True,
                            metrics=ServingMetrics(), sampling=tgen.SamplingConfig(
                                max_new_tokens=40, eos_token_id=-1), **GEOMETRY)

    def fixed():
        return addresses(b.kp, b.vp, b.ksp, b.vsp, b.page_table, b.lengths, b.token,
                         b._active_dev, b._left_dev)

    start = fixed()
    for ids in requests(0):
        b.submit(ids)
    while b.has_work:
        b.step()
        assert fixed() == start
    assert b.metrics.preempt_swap_out > 0 and b.metrics.preempt_swap_in > 0


def test_engine_validation(models):
    port = models[1]
    with pytest.raises(ValueError, match="lazy_alloc"):
        tengine.ChatEngine(port, TCFG, MockTokenizer(), lazy_alloc=True)
    with pytest.raises(ValueError, match="lazy_alloc"):
        tengine.ChatEngine(port, TCFG, MockTokenizer(), continuous_batching=True,
                           lazy_alloc=True)
    with pytest.raises(ValueError, match="prefill_chunk"):
        tengine.ChatEngine(port, TCFG, MockTokenizer(), continuous_batching=True,
                           kv_cache="paged", prefix_cache=True)
    engine = tengine.ChatEngine(port, TCFG, MockTokenizer(), continuous_batching=True,
                                kv_cache="paged", prefix_cache=True, lazy_alloc=True,
                                prefill_chunk=16, page_size=16, cache_len=64)
    assert engine.batcher.lazy_alloc and engine.batcher.prefix_cache is not None
    engine.close()


def request(port, method, path, payload=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=None if payload is None else json.dumps(payload),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = resp.read().decode()
    conn.close()
    return resp.status, body


def test_server_flags_and_metrics(models):
    """`--prefix-cache --lazy-alloc --kv-quant` on a small pool: /v1/completions
    on one shared prefix (n = 3 copies each), one request alone and then
    three at once, all complete with equal copies; GET /metrics shows the
    cache's hits (the alone request's later copies hit) and the swaps."""
    port = models[1]
    parser = argparse.ArgumentParser()
    tapi.add_engine_args(parser)
    flags = parser.parse_args(["--continuous-batching", "--kv-cache", "paged", "--kv-quant",
                               "--prefix-cache", "--lazy-alloc", "--max-slots", "4",
                               "--page-size", "16", "--prefill-chunk", "16", "--num-pages",
                               "10", "--max-new-tokens", "40"])
    assert flags.prefix_cache and flags.lazy_alloc
    engine = tapi.engine_from_args(port, TCFG, MockTokenizer(), flags)
    b = engine.batcher
    assert b.prefix_cache is not None and b.lazy_alloc and b.kv_quant
    server = tapi.serve(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port_no = server.server_address[1]
    shared = " ".join(f"s{i % 7}" for i in range(36))
    prompts = [f"{shared} question {i} " + " ".join(f"q{i}" for _ in range(i + 1))
               for i in range(3)]
    try:
        alone = request(port_no, "POST", "/v1/completions",
                        {"prompt": prompts[0], "max_tokens": 40, "n": 3})
        first = json.loads(request(port_no, "GET", "/metrics")[1])
        with ThreadPoolExecutor(len(prompts)) as pool:
            replies = list(pool.map(lambda p: request(port_no, "POST", "/v1/completions", {
                "prompt": p, "max_tokens": 40, "n": 3}), prompts))
        summary = json.loads(request(port_no, "GET", "/metrics")[1])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        engine.close()
    for status, body in [alone] + replies:
        choices = json.loads(body)["choices"]
        assert status == 200 and len(choices) == 3
        assert choices[0]["text"] == choices[1]["text"] == choices[2]["text"]
    # One request of three copies: the second and third hit the first's pages.
    assert first["requests"] == 3 and first["prefix_cache"] == {"hits": 2, "pages_reused": 4}
    assert summary["requests"] == 12
    assert summary["prefix_cache"] == {"hits": b.prefix_cache.hits,
                                       "pages_reused": b.prefix_cache.pages_reused}
    # Under the burst's pool pressure idle cached prefixes are evicted, so
    # not every later copy hits.
    assert summary["prefix_cache"]["hits"] > 2
    assert summary["preemption"]["swap_out"] > 0
    assert not b.has_work and not b.active.any()
    b.prefix_cache.drop_all()
    assert b.allocator.available == b.num_pages - 1
