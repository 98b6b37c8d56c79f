"""The port's serving observability on the CPU: `ServingMetrics` (against the
JAX package's), the batchers' records, `ChatEngine.drain`, the server's GET
/health, /metrics and /debug/profile and its 503 while draining, the
`--draft-model`, `--metrics-path` and signal wiring of `serve/api.py::main`,
and `utils/profiling.py`.

- `ServingMetrics.summary()` equals the JAX class's after the same seeded
  sequence of `record_request` / `record_speculation` / `observe` calls,
  and its JSONL rows carry the same fields;
- a batcher's recorded proposals and acceptance are its own `proposed` /
  `accepted`, its recorded requests and tokens those it served;
- `drain()` lets an in-flight request finish while new ones raise
  `EngineDraining`, and reports a timeout;
- the HTTP server answers /health, /metrics and /debug/profile (a
  `torch.profiler` trace file written on the CPU; 400, 409 and, without a
  profile dir, 404), and 503 on every POST route while draining;
- `--draft-model` without `--continuous-batching` is an argument error
  before anything loads (as `tests/test_serve.py` holds it for JAX); with
  it the draft loads in bf16, `--lookahead` defaults to 4, and SIGTERM
  drains the server.
"""

import argparse
import http.client
import json
import os
import threading

import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from conftest import MockTokenizer
from vis_zephyr_tpu.utils.metrics import MetricsLogger as JMetricsLogger
from vis_zephyr_tpu.utils.metrics import ServingMetrics as JServingMetrics
from vis_zephyr_tpu.utils.profiling import StepTimer as JStepTimer
from vis_zephyr_tpu_torch.config import tiny_config
from vis_zephyr_tpu_torch.models.vis_zephyr import init_vis_zephyr
from vis_zephyr_tpu_torch.serve import api as tapi
from vis_zephyr_tpu_torch.serve import batching as tbatching
from vis_zephyr_tpu_torch.serve import draft as tdraft
from vis_zephyr_tpu_torch.serve import engine as tengine
from vis_zephyr_tpu_torch.serve import generate as tgen
from vis_zephyr_tpu_torch.serve import paged as tpaged
from vis_zephyr_tpu_torch.utils import profiling
from vis_zephyr_tpu_torch.utils.metrics import MetricsLogger, ServingMetrics

CFG = tiny_config()
PIXELS = np.zeros((4, 56, 56, 3), np.float32)
VALID = np.array([True, False, False, False])


@pytest.fixture(scope="module")
def model():
    return init_vis_zephyr(CFG, torch.Generator().manual_seed(0)).requires_grad_(False).eval()


# -- ServingMetrics ---------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_serving_metrics_summary_matches_jax(seed, tmp_path):
    rng = np.random.default_rng(seed)
    paths = [tmp_path / "port.jsonl", tmp_path / "jax.jsonl"]
    ours = ServingMetrics(MetricsLogger(str(paths[0]), echo=False))
    theirs = JServingMetrics(JMetricsLogger(str(paths[1]), echo=False))
    for i in range(40 * (seed + 1)):
        kind = rng.integers(0, 4)
        if kind == 0:  # TTFT and TPOT over every bucket, infinity's included
            args = (i, float(rng.choice([0.5, 3.0, 70.0, 900.0, 20000.0]) * rng.random()),
                    float(10 ** rng.uniform(-1, 4.5)), int(rng.integers(0, 40)))
            ours.record_request(*args)
            theirs.record_request(*args)
        elif kind == 1:
            proposed = int(rng.integers(0, 6))
            args = (proposed, int(rng.integers(0, proposed + 1)))
            ours.record_speculation(*args)
            theirs.record_speculation(*args)
        elif kind == 2:
            args = (str(rng.choice(["queue_ms", "step_ms"])), float(rng.exponential(50.0)))
            ours.observe(*args)
            theirs.observe(*args)
        else:
            ours.preempt_swap_out += 1
            theirs.preempt_swap_out += 1
    assert ours.summary() == theirs.summary()
    assert ours.summary()["requests"] > 0
    ours.logger.close()
    theirs.logger.close()
    rows = [[{k: v for k, v in json.loads(line).items() if k != "time"}
             for line in path.read_text().splitlines()] for path in paths]
    assert rows[0] == rows[1] and len(rows[0]) == ours.requests


@pytest.mark.parametrize("paged", [False, True])
def test_batcher_records_what_it_counts(model, paged):
    """Prompt-lookup speculation over repetitive prompts: the metrics' spec
    counts are the batcher's, one request row a request, TPOT for each
    request of more than one token."""
    sampling = tgen.SamplingConfig(max_new_tokens=10, eos_token_id=-1)
    metrics = ServingMetrics()
    kw = dict(max_slots=2, cache_len=64, sampling=sampling, lookahead=3, metrics=metrics)
    b = (tpaged.PagedBatcher(model, CFG, page_size=16, num_pages=10, **kw) if paged
         else tbatching.ContinuousBatcher(model, CFG, **kw))
    handles = [b.submit(np.tile(np.array([5, 6, 7, 8]), 5)),
               b.submit(np.tile(np.array([9, 10, 11]), 4), max_new_tokens=1),
               b.submit(np.array([12, 13, 14, 12, 13]))]
    b.run_until_drained()
    served = [len(list(b.stream(h))) for h in handles]
    assert served == [10, 1, 10]
    summary = metrics.summary()
    assert (metrics.spec_proposed, metrics.spec_accepted) == (b.proposed, b.accepted)
    assert b.proposed > 0 and summary["speculation"]["proposed"] == b.proposed
    assert summary["requests"] == 3 and summary["tokens_out"] == sum(served)
    assert summary["ttft_ms"]["count"] == 3 and summary["tpot_ms"]["count"] == 2


# -- drain ------------------------------------------------------------------------------


@pytest.mark.parametrize("batching", [False, True])
def test_drain_finishes_in_flight_then_refuses(model, batching):
    kw = dict(continuous_batching=True, max_slots=2, cache_len=128) if batching else {}
    engine = tengine.ChatEngine(model, CFG, MockTokenizer(), max_new_tokens=6, **kw)
    try:
        want = list(engine.generate_request("hello there"))
        held = engine.generate_request("hello there")  # accepted, not read yet
        assert engine.drain(timeout=0.2) is False  # it is still in flight
        for call in (lambda: engine.generate_request("another one"),
                     lambda: engine.chat("s", "what is this")):
            with pytest.raises(tengine.EngineDraining):
                call()
        done = []
        drainer = threading.Thread(target=lambda: done.append(engine.drain(timeout=60)))
        drainer.start()
        assert list(held) == want  # the in-flight request runs to its end
        drainer.join(timeout=60)
        assert not drainer.is_alive() and done == [True]
        assert engine._inflight == 0
    finally:
        engine.close()


# -- the HTTP routes ----------------------------------------------------------------------


def request(port, method, path, payload=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=None if payload is None else json.dumps(payload),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = resp.read().decode()
    conn.close()
    return resp.status, body


def test_health_metrics_profile_and_draining_routes(model, tmp_path):
    parser = argparse.ArgumentParser()
    tapi.add_engine_args(parser)
    flags = parser.parse_args(["--continuous-batching", "--max-slots", "2", "--max-new-tokens",
                               "4", "--lookahead", "2", "--metrics-path",
                               str(tmp_path / "requests.jsonl")])
    engine = tapi.engine_from_args(model, CFG, MockTokenizer(), flags)
    engine.attach_pixels("s", PIXELS, VALID, (56, 56))
    profile_dir = tmp_path / "profiles"
    servers = [tapi.serve(engine, "127.0.0.1", 0, profile_dir=str(profile_dir)),
               tapi.serve(engine, "127.0.0.1", 0)]
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers]
    for t in threads:
        t.start()
    port, bare = (s.server_address[1] for s in servers)
    try:
        assert request(port, "GET", "/health") == (200, json.dumps({"status": "ok"}))
        assert json.loads(request(port, "GET", "/metrics")[1]) == {"requests": 0,
                                                                    "tokens_out": 0}
        status, text = request(port, "POST", "/chat", {"session_id": "s",
                                                       "question": "<image>\nwhat is it"})
        assert status == 200 and text
        summary = json.loads(request(port, "GET", "/metrics")[1])
        assert summary["requests"] == 1 and summary["ttft_ms"]["count"] == 1
        assert summary == engine.metrics.summary()
        row = json.loads((tmp_path / "requests.jsonl").read_text())
        assert row["step"] == 1 and row["tokens"] == summary["tokens_out"]

        status, body = request(port, "GET", "/debug/profile?seconds=0.1")
        answer = json.loads(body)
        assert status == 200 and answer["trace_dir"] == str(profile_dir)
        assert os.path.dirname(answer["trace_file"]) == str(profile_dir)
        assert os.path.getsize(answer["trace_file"]) > 0
        assert "traceEvents" in json.loads(open(answer["trace_file"]).read())
        assert request(port, "GET", "/debug/profile?seconds=-1")[0] == 400
        assert request(port, "GET", "/debug/profile?seconds=nan")[0] == 400
        with tapi.ChatHandler._profile_lock:  # a capture already running
            assert request(port, "GET", "/debug/profile?seconds=0")[0] == 409
        assert request(bare, "GET", "/debug/profile?seconds=0")[0] == 404
        assert request(port, "GET", "/nowhere")[0] == 404

        assert engine.drain(timeout=30)
        assert request(port, "GET", "/health") == (503, json.dumps({"status": "draining"}))
        for path, payload in (("/chat", {"session_id": "s", "question": "again"}),
                              ("/v1/completions", {"prompt": "hi"}),
                              ("/v1/chat/completions",
                               {"messages": [{"role": "user", "content": "hi"}]})):
            status, body = request(port, "POST", path, payload)
            assert status == 503 and "draining" in body, path
    finally:
        for server, thread in zip(servers, threads):
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        engine.close()


# -- the server's flags ---------------------------------------------------------------------


def test_draft_model_flag_needs_continuous_batching(monkeypatch, capsys):
    from vis_zephyr_tpu_torch.models import builder

    def refuse(*args, **kw):
        raise AssertionError("nothing may load before the flags are checked")

    monkeypatch.setattr(builder, "load_pretrained_model", refuse)
    with pytest.raises(SystemExit) as exit_info:
        tapi.main(["--model-path", "target", "--draft-model", "draft", "--device", "cpu"])
    assert exit_info.value.code == 2
    assert "--draft-model requires --continuous-batching" in capsys.readouterr().err


def test_main_loads_the_draft_and_drains_on_sigterm(model, monkeypatch, capsys):
    """`main` with --draft-model and no --lookahead: the target and the draft
    load (the draft in bf16, never quantized), both batchers' engines get a
    DraftModel at lookahead 4, and the SIGTERM handler drains."""
    import signal

    from vis_zephyr_tpu_torch.models import builder

    loads, handlers, built = [], {}, []

    def fake_load(path, **kw):
        loads.append((path, kw.get("dtype"), kw.get("load_8bit", False), kw.get("device")))
        return MockTokenizer(), model, CFG, 512

    class Server:
        def __init__(self, engine):
            self.engine = engine
            self.stopped = threading.Event()

        def serve_forever(self):
            handlers[signal.SIGTERM](signal.SIGTERM, None)
            assert self.stopped.wait(30) and self.engine._draining

        def shutdown(self):
            self.stopped.set()

        def server_close(self):
            pass

    def fake_serve(engine, host, port, profile_dir=None):
        built.append(engine)
        return Server(engine)

    monkeypatch.setattr(builder, "load_pretrained_model", fake_load)
    monkeypatch.setattr(tapi, "serve", fake_serve)
    monkeypatch.setattr(signal, "signal", lambda sig, fn: handlers.__setitem__(sig, fn))
    for cache in ("dense", "paged"):
        tapi.main(["--model-path", "target", "--draft-model", "draft", "--device", "cpu",
                   "--continuous-batching", "--kv-cache", cache, "--max-slots", "2",
                   "--page-size", "16", "--load-8bit", "--drain-timeout", "5"])
    out = capsys.readouterr().out
    assert "defaulting to --lookahead 4" in out and "drained cleanly" in out
    assert loads[:2] == [("target", torch.bfloat16, True, "cpu"),
                         ("draft", torch.bfloat16, False, "cpu")]
    assert {signal.SIGTERM, signal.SIGINT} <= set(handlers)
    for engine, kind in zip(built, (tbatching.ContinuousBatcher, tpaged.PagedBatcher)):
        assert type(engine.batcher) is kind and engine.batcher.lookahead == 4
        assert isinstance(engine.batcher.draft, tdraft.DraftModel)
        assert engine.batcher.draft.model is model and engine._draining


# -- profiling helpers --------------------------------------------------------------------


def test_profiling_helpers(tmp_path):
    x = torch.ones(3)
    profiling.device_sync(x)
    profiling.device_sync({"a": [x, (x,)]})
    profiling.device_sync([])
    with profiling.profile_to(str(tmp_path)) as trace:
        with profiling.trace_region("vzt_region"):
            (x + 1).sum()
    assert trace["path"] is not None and "vzt_region" in open(trace["path"]).read()
    ours, theirs = profiling.StepTimer(warmup=1), JStepTimer(warmup=1)
    for _ in range(4):
        with ours.step(sync_on=x):
            pass
    assert ours.summary()["steps"] == 3 and theirs.summary() == {}
    times = [0.3, 0.1, 0.2, 0.5, 0.4]
    ours.times, theirs.times = list(times), list(times)
    assert ours.summary() == theirs.summary()
