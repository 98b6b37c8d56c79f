"""The port's sampling operands, logprobs, penalties and OpenAI endpoints
against the JAX package's, on the CPU at `tiny_config`.

- `_sample_per_slot`, `_apply_penalties`, `_count_token`, `_logprobs`,
  `_logprobs_host` against the JAX functions on the same logits: greedy rows
  exact, penalties and logprobs within 1e-5, sampled rows inside their top-p
  nucleus (the JAX draw is Gumbel noise, the port's the exponential race:
  the same distribution, not the same bits), and the race's frequencies
  against the softmax;
- requests with penalties and logprobs beside a greedy and a sampled one,
  on the JAX dense batcher and on both of the port's batchers: penalized
  and greedy tokens identical, `lp_log` within 1e-4;
- a chat completion with penalties and logprobs from the JAX engine's
  serialized path and from the port's three engines (serialized, dense and
  paged batching): the same text, logprobs within 1e-4;
- the port's /v1 endpoints over its HTTP server in this process, as
  `tests/test_openai_api.py` holds the JAX server's;
- structured output and function calling on a character vocabulary
  (`response_format` regex and json_schema, `json_object` refused, `tools`
  under each `tool_choice`, streamed `tool_calls`, the forced-choice
  conflict): each request's reply from the port's three engines against the
  JAX engine's on the same request;
- multi-LoRA through the `model` field: an adapter's name routes to it (the
  completion of the model with its leaves attached), `GET /v1/models`
  lists the adapters as the JAX `list_models` does, and an unknown name is
  a 400 with the JAX `_resolve_adapter` message.
"""

import base64
import io
import json
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from conftest import MockTokenizer
from torch_port_util import jax_params_numpy, port_config, port_model
from vis_zephyr_tpu.config import tiny_config
from vis_zephyr_tpu.serve import batching as jbatching
from vis_zephyr_tpu.serve import engine as jengine
from vis_zephyr_tpu.serve import generate as jgen
from vis_zephyr_tpu.serve import openai_api as jopenai
from vis_zephyr_tpu_torch.serve import api as tapi
from vis_zephyr_tpu_torch.serve import batching as tbatching
from vis_zephyr_tpu_torch.serve import engine as tengine
from vis_zephyr_tpu_torch.serve import generate as tgen
from vis_zephyr_tpu_torch.serve import openai_api as topenai
from vis_zephyr_tpu_torch.serve import paged as tpaged

CFG = tiny_config(vocab_size=256)
TCFG = port_config(CFG)


@pytest.fixture(scope="module")
def models():
    params = jax_params_numpy(CFG, 0)
    return params, port_model(params, CFG)


# -- the sampling operands ------------------------------------------------------------


def nucleus(logits: np.ndarray, temps: np.ndarray, top_ps: np.ndarray) -> np.ndarray:
    """The JAX rule's support per row: bool [B, V]."""
    scaled = logits / np.maximum(temps, 1e-6)[:, None]
    srt = -np.sort(-scaled, axis=-1)
    probs = np.exp(srt - srt.max(-1, keepdims=True))
    cum = np.cumsum(probs / probs.sum(-1, keepdims=True), axis=-1)
    idx = np.minimum((cum < top_ps[:, None]).sum(-1, keepdims=True), scaled.shape[1] - 1)
    return scaled >= np.take_along_axis(srt, idx, axis=-1)


def test_sample_per_slot_greedy_rows_exact_and_draws_in_the_nucleus():
    logits = np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32) * 3
    temps = np.array([0.0, 1.0, 0.0, 0.7], np.float32)
    tops = np.array([1.0, 0.9, 1.0, 0.5], np.float32)
    want = np.asarray(jgen._sample_per_slot(jnp.asarray(logits), jax.random.PRNGKey(1),
                                            jnp.asarray(temps), jnp.asarray(tops)))
    support = nucleus(logits, temps, tops)
    gen = torch.Generator().manual_seed(0)
    for _ in range(40):
        got = tgen._sample_per_slot(torch.from_numpy(logits), gen, torch.from_numpy(temps),
                                    torch.from_numpy(tops)).numpy()
        assert got[0] == want[0] == logits[0].argmax() and got[2] == want[2] == logits[2].argmax()
        assert support[np.arange(4), got].all()
    assert support[np.arange(4), want].all()


def test_top_p_restricts_support():
    """One dominant logit a row with a small top-p: the draw is that token."""
    logits = torch.full((2, 16), -10.0)
    logits[:, 3] = 10.0
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):
        got = tgen._sample_per_slot(logits, gen, torch.tensor([1.0, 1.0]), torch.tensor([0.5, 0.5]))
        assert (got == 3).all()


def test_exponential_race_draws_the_softmax():
    """The draw's frequencies over 40000 rows match the softmax within 0.01."""
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, -3.0, 1.5, 0.2]]).repeat(40000, 1)
    sampling = tgen.SamplingConfig(temperature=1.0)
    draws = tgen._sample(logits, torch.Generator().manual_seed(0), sampling)
    freq = torch.bincount(draws, minlength=8).float() / draws.numel()
    np.testing.assert_allclose(freq.numpy(), torch.softmax(logits[0], -1).numpy(), atol=0.01)


def test_penalties_and_counts_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 40)).astype(np.float32)
    counts = rng.integers(0, 3, (3, 40)).astype(np.float32)
    freq = np.array([0.5, 0.0, 2.0], np.float32)
    pres = np.array([1.0, 2.0, 0.0], np.float32)
    want = np.asarray(jgen._apply_penalties(*map(jnp.asarray, (logits, counts, freq, pres))))
    got = tgen._apply_penalties(*map(torch.from_numpy, (logits, counts, freq, pres))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    token, active = np.array([4, 4, 39]), np.array([True, False, True])
    want = np.asarray(jgen._count_token(jnp.asarray(counts), jnp.asarray(token),
                                        jnp.asarray(active)))
    got = tgen._count_token(torch.from_numpy(counts.copy()), torch.from_numpy(token),
                            torch.from_numpy(active)).numpy()
    np.testing.assert_array_equal(got, want)


def test_logprobs_match_jax():
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((3, 64)) * 2).astype(np.float32)
    token = np.array([5, 0, 63])
    want = jax.device_get(jgen._logprobs(jnp.asarray(logits), jnp.asarray(token)))
    got = [t.numpy() for t in tgen._logprobs(torch.from_numpy(logits), torch.from_numpy(token))]
    assert tgen.LP_TOPK == jgen.LP_TOPK == got[1].shape[1]
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], atol=1e-5)
    for i, (g, w) in enumerate(zip(tgen._logprobs_host(logits[1], 7),
                                   jgen._logprobs_host(logits[1], 7))):
        np.testing.assert_allclose(g, w, atol=1e-5, err_msg=str(i))
    chosen, ids, lps = tgen._logprobs_host(logits[2], 63)
    np.testing.assert_array_equal(ids, got[1][2])
    np.testing.assert_allclose(lps, got[2][2], atol=1e-5)
    assert abs(chosen - got[0][2]) < 1e-5


# -- penalties and logprobs in the batched steps ---------------------------------------


def batch_requests():
    """(ids, submit kwargs) of the batch: penalized, logprobs, greedy, sampled."""
    ids = np.asarray([1, 17, 23, 42, 17, 23], np.int64)
    return [(ids, dict(presence_penalty=100.0)),
            (ids, dict(frequency_penalty=0.5, presence_penalty=1.5, logprobs=3)),
            (ids, dict(logprobs=2)),
            (ids, {}),
            (ids, dict(temperature=1.3, top_p=0.9))]


def run_batch(batcher):
    handles = [batcher.submit(ids, **kw) for ids, kw in batch_requests()]
    batcher.run_until_drained()
    return [list(batcher.stream(h)) for h in handles], [h.lp_log for h in handles]


@pytest.fixture(scope="module")
def jax_batch(models):
    sampling = jgen.SamplingConfig(max_new_tokens=12, temperature=0.0, eos_token_id=-1)
    return run_batch(jbatching.ContinuousBatcher(models[0], CFG, max_slots=8, cache_len=64,
                                                 sampling=sampling))


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_batched_penalties_and_logprobs_match_jax(models, jax_batch, kind):
    sampling = tgen.SamplingConfig(max_new_tokens=12, temperature=0.0, eos_token_id=-1)
    if kind == "dense":
        b = tbatching.ContinuousBatcher(models[1], TCFG, max_slots=8, cache_len=64,
                                        sampling=sampling, multi_step=4)
    else:
        b = tpaged.PagedBatcher(models[1], TCFG, max_slots=8, cache_len=64, page_size=16,
                                num_pages=40, sampling=sampling, multi_step=4)
    toks, logs = run_batch(b)
    want_toks, want_logs = jax_batch
    assert toks[:4] == want_toks[:4]
    assert len(set(toks[0])) == len(toks[0]) == 12  # a presence penalty of 100: no repeats
    assert len(toks[3]) == 12 and len(set(toks[3])) < 12  # the unpenalized stream repeats
    assert len(toks[4]) == 12 and all(0 <= t < CFG.decoder.vocab_size for t in toks[4])
    assert [len(log) for log in logs] == [0, 12, 12, 0, 0]
    for got, want in zip(logs[1] + logs[2], want_logs[1] + want_logs[2]):
        assert abs(got[0] - want[0]) < 1e-4
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[2], want[2], atol=1e-4)
    # Logprobs and penalties single-step the batcher: no burst ran.
    assert b.bursts == 0


def test_speculative_batcher_refuses_logprobs_and_penalties(models):
    b = tbatching.ContinuousBatcher(models[1], TCFG, max_slots=2, cache_len=64, lookahead=2,
                                    sampling=tgen.SamplingConfig(max_new_tokens=4))
    with pytest.raises(ValueError, match="logprobs"):
        b.submit(np.asarray([1, 17], np.int64), logprobs=1)
    with pytest.raises(ValueError, match="penalties"):
        b.submit(np.asarray([1, 17], np.int64), presence_penalty=1.0)
    assert b.submit(np.asarray([1, 17], np.int64), temperature=0.9).temperature is None


# -- the engines and the endpoints ----------------------------------------------------


@pytest.fixture(scope="module")
def tokenizer():
    return MockTokenizer()


ENGINES = {"serialized": {},
           "dense": dict(continuous_batching=True, max_slots=4, cache_len=256),
           "paged": dict(continuous_batching=True, kv_cache="paged", max_slots=4,
                         cache_len=256, page_size=16, num_pages=48)}
SCORED = {"messages": [{"role": "system", "content": "be brief"},
                       {"role": "user", "content": "score these words please"}],
          "max_tokens": 6, "logprobs": True, "top_logprobs": 3,
          "frequency_penalty": 0.5, "presence_penalty": 1.5}


@pytest.fixture(scope="module")
def engines(models, tokenizer):
    made = {name: tengine.ChatEngine(models[1], TCFG, tokenizer, max_new_tokens=6, **kw)
            for name, kw in ENGINES.items()}
    yield made
    for engine in made.values():
        engine.close()


@pytest.fixture(scope="module")
def jax_scored(models, tokenizer):
    engine = jengine.ChatEngine(models[0], CFG, tokenizer, max_new_tokens=6)
    return jopenai.chat_completion(engine, dict(SCORED))


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_chat_completion_matches_jax(jax_scored, engines, name):
    """Penalties and logprobs through each engine: JAX's serialized text and
    logprobs."""
    err, want = jax_scored
    assert err is None
    err, got = topenai.chat_completion(engines[name], dict(SCORED))
    assert err is None
    assert got["usage"] == want["usage"]
    g, w = got["choices"][0], want["choices"][0]
    assert g["message"] == w["message"] and g["finish_reason"] == w["finish_reason"]
    for ge, we in zip(g["logprobs"]["content"], w["logprobs"]["content"]):
        assert ge["token"] == we["token"] and ge["bytes"] == we["bytes"]
        assert abs(ge["logprob"] - we["logprob"]) < 1e-4
        assert [t["token"] for t in ge["top_logprobs"]] == [t["token"] for t in we["top_logprobs"]]


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_zero_budget_yields_no_token_on_every_engine(engines, name):
    err, out = topenai.chat_completion(engines[name], {
        "messages": [{"role": "user", "content": "count to ten"}], "max_tokens": 0})
    assert err is None and out["usage"]["completion_tokens"] == 0
    assert out["choices"][0]["message"]["content"] == ""


@pytest.fixture(scope="module")
def server(engines):
    srv = tapi.serve(engines["dense"], host="127.0.0.1", port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def _post(base, path, payload):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _events(body: str):
    return [json.loads(line[len("data: "):]) for line in body.splitlines()
            if line.startswith("data: ") and line != "data: [DONE]"]


def test_models_lists_base(server):
    with urllib.request.urlopen(server + "/v1/models", timeout=30) as resp:
        body = json.loads(resp.read())
    assert body["object"] == "list" and body["data"][0]["id"] == "vis-zephyr-tpu"


def test_chat_completion_nonstream(server):
    status, body = _post(server, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "Hello there"}], "max_tokens": 4})
    assert status == 200
    out = json.loads(body)
    assert out["object"] == "chat.completion"
    assert out["choices"][0]["message"]["role"] == "assistant"
    assert out["usage"]["completion_tokens"] <= 4 and out["usage"]["prompt_tokens"] > 0
    assert out["choices"][0]["finish_reason"] in ("stop", "length")


def test_chat_completion_stream_sse(server):
    status, body = _post(server, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "Stream please"}], "max_tokens": 4,
        "stream": True})
    assert status == 200 and body.rstrip().endswith("data: [DONE]")
    events = _events(body)
    assert events[0]["choices"][0]["delta"].get("role") == "assistant"
    assert events[-2]["choices"][0]["finish_reason"] in ("stop", "length")
    assert events[-1]["choices"] == [] and "usage" in events[-1]
    text = "".join(e["choices"][0]["delta"].get("content", "") for e in events if e["choices"])
    _, whole = _post(server, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "Stream please"}], "max_tokens": 4})
    assert text == json.loads(whole)["choices"][0]["message"]["content"]


def test_completions_endpoint(server):
    status, body = _post(server, "/v1/completions", {"prompt": "Some prefix text",
                                                     "max_tokens": 3})
    assert status == 200
    out = json.loads(body)
    assert out["object"] == "text_completion" and "text" in out["choices"][0]
    assert out["usage"]["completion_tokens"] <= 3


def test_unknown_model_rejected(server):
    status, body = _post(server, "/v1/chat/completions", {
        "model": "not-a-model", "messages": [{"role": "user", "content": "x"}]})
    assert status == 400
    message = json.loads(body)["error"]["message"]
    # The JAX message: the served id and the loaded adapters (none here).
    assert message == "unknown model 'not-a-model'; available: ['vis-zephyr-tpu']"


def test_invalid_messages_rejected(server):
    status, _ = _post(server, "/v1/chat/completions", {"messages": []})
    assert status == 400


def test_stop_string_truncates(server):
    payload = {"messages": [{"role": "user", "content": "Tell me everything"}],
               "max_tokens": 6}
    full = json.loads(_post(server, "/v1/chat/completions", payload)[1])
    text = full["choices"][0]["message"]["content"]
    assert text.strip()  # MockTokenizer renders every id
    second = text.split()[1]
    status, body = _post(server, "/v1/chat/completions", dict(payload, stop=[second]))
    stopped = json.loads(body)["choices"][0]
    assert status == 200 and stopped["finish_reason"] == "stop"
    assert second not in stopped["message"]["content"]
    assert text.startswith(stopped["message"]["content"])


def test_chat_logprobs(server):
    status, body = _post(server, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "score this"}], "max_tokens": 4,
        "logprobs": True, "top_logprobs": 3})
    assert status == 200
    out = json.loads(body)
    content = out["choices"][0]["logprobs"]["content"]
    assert len(content) == out["usage"]["completion_tokens"]
    for e in content:
        assert set(e) == {"token", "logprob", "bytes", "top_logprobs"}
        assert e["logprob"] <= 0.0 and len(e["top_logprobs"]) == 3
        assert e["top_logprobs"][0]["logprob"] == e["logprob"]  # greedy: the top-1
        assert e["bytes"] == list(e["token"].encode("utf-8"))


def test_completions_legacy_logprobs(server):
    status, body = _post(server, "/v1/completions", {"prompt": "prefix words here",
                                                     "max_tokens": 3, "logprobs": 2})
    assert status == 200
    lp = json.loads(body)["choices"][0]["logprobs"]
    n = len(lp["tokens"])
    assert n == len(lp["token_logprobs"]) == len(lp["top_logprobs"]) == len(lp["text_offset"])
    assert all(len(t) == 2 for t in lp["top_logprobs"])
    assert lp["text_offset"] == sorted(lp["text_offset"])


def test_streaming_logprobs(server):
    status, body = _post(server, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "stream scores"}], "max_tokens": 4,
        "logprobs": True, "top_logprobs": 1, "stream": True})
    assert status == 200
    events = _events(body)
    entries = [x for e in events if e["choices"] and e["choices"][0].get("logprobs")
               for x in e["choices"][0]["logprobs"]["content"]]
    assert len(entries) == events[-1]["usage"]["completion_tokens"]
    assert all(len(e["top_logprobs"]) == 1 for e in entries)


def test_n_choices_nonstream(server):
    status, body = _post(server, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "many answers"}], "max_tokens": 3, "n": 3})
    assert status == 200
    out = json.loads(body)
    assert [c["index"] for c in out["choices"]] == [0, 1, 2]
    assert len({c["message"]["content"] for c in out["choices"]}) == 1  # greedy
    assert out["usage"]["completion_tokens"] <= 9


def test_n_choices_stream_interleaved(server):
    status, body = _post(server, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "many streams"}], "max_tokens": 3, "n": 2,
        "stream": True})
    assert status == 200
    events = _events(body)
    finishes = {e["choices"][0]["index"] for e in events
                if e["choices"] and e["choices"][0]["finish_reason"]}
    assert finishes == {0, 1}
    per_idx = {0: "", 1: ""}
    for e in events:
        if e["choices"]:
            per_idx[e["choices"][0]["index"]] += e["choices"][0]["delta"].get("content", "")
    assert per_idx[0] == per_idx[1] and events[-1]["choices"] == []


def test_penalty_accepted_and_validated(server):
    status, body = _post(server, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "no repeats"}], "max_tokens": 4,
        "frequency_penalty": 0.5, "presence_penalty": 1.5})
    assert status == 200 and json.loads(body)["usage"]["completion_tokens"] <= 4
    status, _ = _post(server, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "x"}], "presence_penalty": 3.0})
    assert status == 400


@pytest.mark.parametrize("payload", [{"n": 99}, {"logprobs": True, "top_logprobs": 50},
                                     {"max_tokens": "many"}, {"stop": 3}])
def test_out_of_range_rejected(server, payload):
    status, body = _post(server, "/v1/chat/completions",
                         dict(payload, messages=[{"role": "user", "content": "x"}]))
    assert status == 400 and json.loads(body)["error"]["type"] == "invalid_request_error"


def test_per_request_temperature_accepted(server):
    status, body = _post(server, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "Sample away"}], "max_tokens": 4,
        "temperature": 1.1, "top_p": 0.95})
    assert status == 200 and json.loads(body)["usage"]["completion_tokens"] <= 4


def test_string_content_part(server):
    status, body = _post(server, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": ["hi"]}]})
    assert status == 400 and json.loads(body)["error"]["type"] == "invalid_request_error"


def test_tool_call_history(server):
    """Earlier tool-calling turns render as the JAX module renders them; dict
    arguments and a missing function are 400s, never a dropped connection."""
    history = [{"role": "assistant", "tool_calls": [
                   {"id": "c1", "type": "function",
                    "function": {"name": "f", "arguments": "{\"a\": 1}"}}]},
               {"role": "tool", "tool_call_id": "c1", "name": "f", "content": "ok"},
               {"role": "user", "content": "hi"}]
    assert (topenai.render_chat_prompt(history, "zephyr_v1")[0]
            == jopenai.render_chat_prompt(history, "zephyr_v1")[0])
    status, _ = _post(server, "/v1/chat/completions", {"messages": history, "max_tokens": 2})
    assert status == 200
    history[0]["tool_calls"][0]["function"]["arguments"] = {"a": 1}
    assert _post(server, "/v1/chat/completions", {"messages": history})[0] == 400
    status, _ = _post(server, "/v1/chat/completions", {"messages": [
        {"role": "assistant", "tool_calls": [{"id": "c1"}]},
        {"role": "user", "content": "hi"}]})
    assert status == 400


def test_max_tokens_zero_yields_zero_tokens(server):
    status, body = _post(server, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "count to ten"}], "max_tokens": 0})
    assert status == 200
    out = json.loads(body)
    assert out["usage"]["completion_tokens"] == 0
    assert out["choices"][0]["message"]["content"] == ""


@pytest.mark.parametrize("extra", [
    {"tools": [{"type": "function", "function": {"name": "f", "parameters": {}}}]},
    {"tools": [{"type": "function", "function": {"name": "f"}}], "tool_choice": "required"},
    {"tool_choice": {"type": "function", "function": {"name": "f"}}},
    {"response_format": {"type": "json_schema", "json_schema": {"schema": {"type": "object"}}}},
    {"response_format": {"type": "regex", "regex": "a+"}},
    {"response_format": {"type": "json_object"}},
])
def test_left_out_fields_refused_by_name(server, engines, extra):
    """The fields this port once refused are served now; each of these
    requests gets the JAX module's answer: its refusal (a free-form object
    schema, `json_object`, a grammar the mock vocabulary cannot decode), or
    the JAX reading of a field that changes nothing (`tool_choice` without
    `tools`, `tools` under "auto")."""
    payload = dict(extra, messages=[{"role": "user", "content": "x"}], max_tokens=3)
    want = jopenai._parse_request(engines["dense"], dict(payload), chat=True)[1]
    status, body = _post(server, "/v1/chat/completions", payload)
    if want is None:
        assert status == 200
    else:
        assert status == 400 and json.loads(body)["error"]["message"] == want
    assert "not ported to PyTorch yet" not in body


def test_fields_that_change_nothing_are_served(server):
    """tool_choice "none" with tools, and response_format text, decode as
    without them (the JAX module's reading)."""
    base = {"messages": [{"role": "user", "content": "plain words"}], "max_tokens": 3}
    want = json.loads(_post(server, "/v1/chat/completions", base)[1])["choices"][0]["message"]
    for extra in ({"tools": [{"function": {"name": "f"}}], "tool_choice": "none"},
                  {"response_format": {"type": "text"}}):
        status, body = _post(server, "/v1/chat/completions", dict(base, **extra))
        assert status == 200 and json.loads(body)["choices"][0]["message"] == want


def test_image_data_url(server, engines, monkeypatch):
    """A data-URL image goes through PIL to the image path; where PIL is
    missing the request is a 400 that says so; remote URLs are refused."""
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(0).integers(0, 255, (40, 60, 3), np.uint8)).save(
        buf, format="PNG")
    url = "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()
    messages = [{"role": "user", "content": [{"type": "text", "text": "what is it"},
                                             {"type": "image_url", "image_url": {"url": url}}]}]
    prompt, image = topenai.render_chat_prompt(messages, "zephyr_v1")
    assert prompt == jopenai.render_chat_prompt(messages, "zephyr_v1")[0]
    assert image.size == (60, 40)
    status, body = _post(server, "/v1/chat/completions", {"messages": messages,
                                                          "max_tokens": 2})
    assert status == 200 and json.loads(body)["usage"]["completion_tokens"] == 2
    monkeypatch.setitem(sys.modules, "PIL", None)
    err, _ = topenai.chat_completion(engines["dense"], {"messages": messages})
    assert "needs PIL" in err["error"]["message"]
    bad = [{"role": "user", "content": [{"type": "image_url",
                                         "image_url": {"url": "http://example.com/a.png"}}]}]
    assert _post(server, "/v1/chat/completions", {"messages": bad})[0] == 400


def test_stream_text_matches_jax(tokenizer):
    """The incremental detokenizer gives the JAX engine's deltas."""
    ids = tokenizer("one two three four five six seven eight nine ten").input_ids

    def deltas(engine_cls):
        engine = engine_cls.__new__(engine_cls)
        engine.tokenizer = tokenizer
        return list(engine.stream_text(iter(ids)))

    got = deltas(tengine.ChatEngine)
    assert got == deltas(jengine.ChatEngine)
    assert "".join(got) == tokenizer.decode(ids, skip_special_tokens=True)


# -- multi-LoRA adapters through the `model` field -------------------------------------


@pytest.fixture(scope="module")
def lora_server(models, tokenizer):
    """(base URL, engine, pack): a dense-batching engine with two random
    adapters, "a" and "b", behind the port's HTTP server."""
    from vis_zephyr_tpu_torch.ops import mlora as tmlora

    pack = tmlora.make_random_pack(TCFG, 2, 4, torch.Generator().manual_seed(5))
    engine = tengine.ChatEngine(models[1], TCFG, tokenizer, max_new_tokens=6,
                                continuous_batching=True, max_slots=4, cache_len=256,
                                mlora=pack, adapter_names={"a": 1, "b": 2})
    srv = tapi.serve(engine, host="127.0.0.1", port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", engine, pack
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=30)
    engine.close()


def test_model_field_routes_to_an_adapter(models, tokenizer, lora_server):
    """`model` "a" gives the completion of the model with adapter a attached,
    "base" and the served id that of the base model."""
    import copy

    from vis_zephyr_tpu_torch.ops import mlora as tmlora
    from vis_zephyr_tpu_torch.train.lora import attach_lora

    base_url, _, pack = lora_server
    prompt = {"prompt": "Some prefix text", "max_tokens": 5}
    alone = tengine.ChatEngine(
        attach_lora(copy.deepcopy(models[1]), tmlora.lora_leaves_for_adapter(pack, 1)), TCFG,
        tokenizer, max_new_tokens=6)
    plain = tengine.ChatEngine(models[1], TCFG, tokenizer, max_new_tokens=6)
    want_a = topenai.completion(alone, dict(prompt))[1]["choices"][0]["text"]
    want_base = topenai.completion(plain, dict(prompt))[1]["choices"][0]["text"]
    texts = {}
    for model in ("a", "base", "vis-zephyr-tpu"):
        status, body = _post(base_url, "/v1/completions", dict(prompt, model=model))
        assert status == 200
        out = json.loads(body)
        assert out["model"] == model
        texts[model] = out["choices"][0]["text"]
    assert texts == {"a": want_a, "base": want_base, "vis-zephyr-tpu": want_base}
    assert want_a != want_base
    status, body = _post(base_url, "/v1/chat/completions", {
        "model": "b", "messages": [{"role": "user", "content": "hello"}], "max_tokens": 3})
    assert status == 200 and json.loads(body)["usage"]["completion_tokens"] <= 3


def test_models_lists_the_adapters_as_jax_does(lora_server):
    base_url, engine, _ = lora_server
    with urllib.request.urlopen(base_url + "/v1/models", timeout=30) as resp:
        body = json.loads(resp.read())
    want = jopenai.list_models(engine)  # the JAX function on the same engine
    for entry in body["data"] + want["data"]:
        entry.pop("created")
    assert [e["id"] for e in body["data"]] == ["vis-zephyr-tpu", "a", "b"]
    assert body == want


def test_unknown_adapter_is_a_400_with_the_jax_body(lora_server):
    base_url, engine, _ = lora_server
    for path, payload in (("/v1/completions", {"prompt": "x"}),
                          ("/v1/chat/completions",
                           {"messages": [{"role": "user", "content": "x"}]})):
        status, body = _post(base_url, path, dict(payload, model="nope"))
        assert status == 400
        want = jopenai._resolve_adapter(engine, "nope")[1]
        assert json.loads(body)["error"]["message"] == want
        assert "'a', 'b'" in want



# -- structured output and function calling ---------------------------------------------


class CharTokenizer:
    """A character tokenizer with the HF surface the grammars read
    (`convert_ids_to_tokens`): ids 10..104 are the printable ASCII
    characters, 0..3 specials (the JAX `tests/test_structured.py` one)."""

    bos_token_id = 1
    eos_token_id = 2
    pad_token_id = 0
    vocab_size = CFG.decoder.vocab_size
    model_max_length = 4096

    class _Out:
        def __init__(self, ids):
            self.input_ids = ids

    def __call__(self, text, **kwargs):
        return self._Out([self.bos_token_id] + [10 + ord(ch) - 32 if 32 <= ord(ch) < 127 else 3
                                                for ch in text])

    def convert_ids_to_tokens(self, ids):
        return [chr(22 + i) if 10 <= i < 105 else "<sp>" for i in ids]

    def decode(self, ids, skip_special_tokens=False):
        return "".join(chr(22 + i) for i in ids if 10 <= i < 105)


TOOLS = [
    {"type": "function", "function": {
        "name": "get_weather", "description": "Weather for a city",
        "parameters": {"type": "object", "properties": {"city": {"enum": ["Paris", "Tokyo"]}}}}},
    {"type": "function", "function": {"name": "noop", "parameters": {}}},
]
ASK = [{"role": "user", "content": "pick"}]
GRAMMAR_REQUESTS = {
    "regex": {"messages": ASK, "response_format": {"type": "regex", "regex": "[0-9]{3}-[a-z]{2}"},
              "max_tokens": 12},
    "json_schema": {"messages": ASK, "max_tokens": 40, "response_format": {
        "type": "json_schema", "json_schema": {"name": "ans", "schema": {
            "type": "object", "properties": {"c": {"enum": ["red", "green"]},
                                             "ok": {"type": "boolean"}}}}}},
    "tools_none": {"messages": ASK, "tools": TOOLS, "tool_choice": "none", "max_tokens": 4},
    "tools_auto": {"messages": ASK, "tools": TOOLS, "max_tokens": 4},
    "tools_required": {"messages": ASK, "tools": TOOLS, "tool_choice": "required",
                       "max_tokens": 64},
    "tools_named": {"messages": ASK, "tools": TOOLS, "max_tokens": 64,
                    "tool_choice": {"type": "function", "function": {"name": "get_weather"}}},
}
GRAMMAR_REFUSED = {
    "json_object": {"messages": ASK, "response_format": {"type": "json_object"}},
    "forced_conflict": {"messages": ASK, "tools": TOOLS, "tool_choice": "required",
                        "response_format": {"type": "regex", "regex": "a"}},
    "unknown_function": {"messages": ASK, "tools": TOOLS,
                         "tool_choice": {"type": "function", "function": {"name": "missing"}}},
}


# A character a token: the chat template and a tools directory make prompts
# of 400 to 800 tokens.
CHAR_ENGINES = {"serialized": {},
                "dense": dict(continuous_batching=True, max_slots=2, cache_len=1024),
                "paged": dict(continuous_batching=True, kv_cache="paged", max_slots=2,
                              cache_len=1024, page_size=64, num_pages=33)}


@pytest.fixture(scope="module")
def char_engines(models):
    """The JAX serialized engine and the port's three engines on the
    character tokenizer."""
    made = {name: tengine.ChatEngine(models[1], TCFG, CharTokenizer(), max_new_tokens=64, **kw)
            for name, kw in CHAR_ENGINES.items()}
    yield jengine.ChatEngine(models[0], CFG, CharTokenizer(), max_new_tokens=64), made
    for engine in made.values():
        engine.close()


def without_ids(out: dict) -> dict:
    """A reply with its random ids taken out (the response's and each tool
    call's)."""
    out = json.loads(json.dumps(out))
    for key in ("id", "created"):
        out.pop(key, None)
    for choice in out.get("choices", []):
        for call in (choice.get("message") or {}).get("tool_calls") or []:
            assert call.pop("id").startswith("call_")
    return out


@pytest.fixture(scope="module")
def jax_grammar_replies(char_engines):
    jax_engine = char_engines[0]
    return {name: jopenai.chat_completion(jax_engine, json.loads(json.dumps(payload)))
            for name, payload in GRAMMAR_REQUESTS.items()}


@pytest.mark.parametrize("engine", sorted(CHAR_ENGINES))
def test_grammar_replies_match_jax(char_engines, jax_grammar_replies, engine):
    """Each request's reply from the port's engine equals the JAX engine's:
    the constrained text, a forced call's `tool_calls` and `finish_reason`
    "tool_calls", the usage."""
    port = char_engines[1][engine]
    for name, payload in GRAMMAR_REQUESTS.items():
        err, want = jax_grammar_replies[name]
        assert err is None, (name, err)
        err, got = topenai.chat_completion(port, json.loads(json.dumps(payload)))
        assert err is None, (name, err)
        assert without_ids(got) == without_ids(want), name
    calls = without_ids(want)["choices"][0]["message"]["tool_calls"]
    assert calls[0]["function"]["name"] == "get_weather"
    assert json.loads(calls[0]["function"]["arguments"])["city"] in ("Paris", "Tokyo")


def test_grammar_reply_contents(jax_grammar_replies):
    """What the grammars promise, on the JAX replies the port's equal."""
    msg = {name: out[1]["choices"][0]["message"] for name, out in jax_grammar_replies.items()}
    reason = {name: out[1]["choices"][0]["finish_reason"]
              for name, out in jax_grammar_replies.items()}
    from vis_zephyr_tpu_torch.serve.structured import compile_regex

    assert compile_regex("[0-9]{3}-[a-z]{2}").matches(msg["regex"]["content"])
    assert set(json.loads(msg["json_schema"]["content"])) <= {"c", "ok"}
    assert reason["regex"] == reason["json_schema"] == "stop"
    for name in ("tools_required", "tools_named"):
        assert msg[name]["content"] is None and reason[name] == "tool_calls"
    assert "tool_calls" not in msg["tools_none"] and "tool_calls" not in msg["tools_auto"]


@pytest.mark.parametrize("name", sorted(GRAMMAR_REFUSED))
def test_grammar_refusals_match_jax(char_engines, name):
    jax_engine, ports = char_engines
    want, _ = jopenai.chat_completion(jax_engine, dict(GRAMMAR_REFUSED[name]))
    got, _ = topenai.chat_completion(ports["dense"], dict(GRAMMAR_REFUSED[name]))
    assert got == want and "message" in got["error"]


def test_streamed_tool_calls_and_grammar_match_jax(char_engines):
    """A forced call streams as one `tool_calls` delta and a "tool_calls"
    finish; a regex reply streams the text of the whole reply; both as the
    JAX module streams them."""
    jax_engine, ports = char_engines

    def events(module, engine, payload):
        err, stream = module.chat_completion(engine, dict(payload, stream=True))
        assert err is None
        out = [json.loads(e[len("data: "):]) for e in stream if e != "data: [DONE]\n\n"]
        for e in out:
            e.pop("id"), e.pop("created")
            for c in e["choices"]:
                for call in c.get("delta", {}).get("tool_calls", []):
                    call.pop("id")
        return out

    streams = {}
    for engine in ("serialized", "paged"):
        for name in ("tools_required", "regex"):
            want = events(jopenai, jax_engine, GRAMMAR_REQUESTS[name])
            got = streams[name] = events(topenai, ports[engine], GRAMMAR_REQUESTS[name])
            assert got == want, (engine, name)
    forced = streams["tools_required"]
    assert [c["finish_reason"] for e in forced for c in e["choices"] if c["finish_reason"]] \
        == ["tool_calls"]
    assert len([c for e in forced for c in e["choices"] if c["delta"].get("tool_calls")]) == 1
    text = "".join(c["delta"].get("content", "") for e in streams["regex"] for c in e["choices"])
    err, whole = topenai.chat_completion(ports["dense"], dict(GRAMMAR_REQUESTS["regex"]))
    assert text == whole["choices"][0]["message"]["content"]


def test_tools_render_into_the_prompt_as_in_jax():
    messages = [{"role": "user", "content": "weather?"},
                {"role": "assistant", "content": None, "tool_calls": [
                    {"id": "call_1", "type": "function", "function": {
                        "name": "get_weather", "arguments": '{"city": "Paris"}'}}]},
                {"role": "tool", "name": "get_weather", "content": "sunny"}]
    got = topenai.render_chat_prompt(messages, "zephyr_v1", tools=TOOLS)
    assert got == jopenai.render_chat_prompt(messages, "zephyr_v1", tools=TOOLS)
    assert "You can call these functions" in got[0]


def test_compile_grammar_is_an_lru_of_32(char_engines):
    engine = char_engines[1]["serialized"]
    first = engine.compile_grammar("[0-9]")
    assert engine.compile_grammar("[0-9]") is first
    assert engine.compile_grammar(json_schema={"type": "boolean"}) is \
        engine.compile_grammar("(true|false)")
    for i in range(tengine.GRAMMAR_CACHE):
        engine.compile_grammar(f"a{{{i + 1}}}")
    assert engine.compile_grammar("[0-9]") is not first
    assert len(engine._grammar_cache) == tengine.GRAMMAR_CACHE
    with pytest.raises(ValueError, match="needs a regex"):
        engine.compile_grammar()
