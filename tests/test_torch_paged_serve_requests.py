"""The port's paged batcher on requests of its own and behind its server,
on the CPU at `tiny_config` (moved from `test_torch_paged_serve.py`, which
holds the scripted scenario against the JAX batcher step by step).

- Pages are reused across requests in every pool form, an exhausted pool
  requeues, a request too long for its slot ends with no token, an EOS
  first token and a cancel free the slot and its pages, sampled decoding is
  seeded and in range, and the options not ported raise by name (a mesh).
- `/chat` with the paged flags (`--kv-quant`, fused pools, chunked
  admission) under five concurrent clients, each with its own image: the
  port's server gives each session the JAX engine's reply; the server's
  flags build the JAX server's defaults; every page is released after the
  burst, and requests shared decode steps.
- The page allocator: the cases of the JAX package's allocator tests.
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

from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from conftest import MockTokenizer
from torch_port_util import jax_params_numpy, port_config, port_model
from vis_zephyr_tpu.config import tiny_config
from vis_zephyr_tpu.serve import engine as jengine
from vis_zephyr_tpu.serve import paged as jpaged
from vis_zephyr_tpu_torch.conversation import templates
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
    # The prefix cache, lazy allocation (test_torch_prefix_cache.py,
    # test_torch_paged_swap.py) and multi-LoRA adapters (test_torch_mlora.py)
    # are served.
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpaged.PagedBatcher(port, TCFG, **kw, mesh=object())
    # The dense batcher is ported; it refuses what the paged one refuses.
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tbatching.ContinuousBatcher(port, TCFG, cache_len=64, mesh=object())
    b = tpaged.PagedBatcher(port, TCFG, **kw)
    ids = np.array([5, 6, 7])
    # Per-request temperature, top-p, logprobs, penalties, adapters and
    # grammars are served; an adapter the batcher has not loaded is a
    # KeyError.
    with pytest.raises(KeyError, match="lora-a"):
        b.submit(ids, adapter="lora-a")
    step = (port, b.kp, b.vp, (b.ksp, b.vsp), b.page_table, b.lengths, b.token,
            torch.zeros(4, dtype=torch.bool), None, TCFG, kw["sampling"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpaged._paged_step(*step, mesh=object())
    # The step's grammar operand is each row's mask: a row allowed one token
    # samples it.
    mask = torch.zeros((4, TCFG.decoder.vocab_size), dtype=torch.bool)
    mask[:, 7] = True
    active = torch.tensor([True, False, False, False])
    token = tpaged._paged_step(*step[:7], active, *step[8:], grammar=mask)[0]
    assert token.tolist() == [7] + [TCFG.decoder.pad_token_id] * 3
    # Two modes exist (writefirst is held in test_torch_paged_single.py); an
    # unknown one is refused, where the JAX step would take it as writefirst.
    with pytest.raises(ValueError, match="selfterm"):
        tpaged._paged_step(*step, mode="write-first")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tengine.ChatEngine(port, TCFG, MockTokenizer(), mesh=object())


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
