"""The port's draft-model speculation (`serve/draft.py::DraftModel` and the
batchers' hooks) against the JAX package, on the CPU at `tiny_config` in
f32 with the same weights on both sides (`tests/torch_port_util.py`).

For the cases of `tests/test_draft.py` (a self-draft, a draft of other
weights, the paged batcher, a slot the draft declines, a tight draft cache,
budget edges, interleaved admissions) the port's batcher with the port's
draft and the JAX dense batcher with the JAX draft run the same requests:
every round's proposals and the draft's length mirror after each round
are equal, and so are the streams, which also equal the port's own plain
greedy (`lookahead=0`). The `ServingMetrics` each batcher fills counts
what the batcher counts. The direct case of a tight draft cache (a shorter
span, then none) is held call for call, and every serving feature at once
(`tests/test_paged_batching.py::TestKitchenSink`: int8 fused pools, chunked
prefill, a sliding window, images, more requests than slots and pages)
against plain greedy and the JAX dense batcher with its draft.
"""

import dataclasses

import numpy as np
import pytest

from torch_port_util import jax_params_numpy, port_config, port_model
from vis_zephyr_tpu.config import tiny_config
from vis_zephyr_tpu.constants import IMAGE_TOKEN_INDEX
from vis_zephyr_tpu.serve import batching as jbatching
from vis_zephyr_tpu.serve import draft as jdraft
from vis_zephyr_tpu.serve import generate as jgen
from vis_zephyr_tpu.utils.metrics import ServingMetrics as JServingMetrics
from vis_zephyr_tpu_torch.serve import batching as tbatching
from vis_zephyr_tpu_torch.serve import draft as tdraft
from vis_zephyr_tpu_torch.serve import generate as tgen
from vis_zephyr_tpu_torch.serve import paged as tpaged
from vis_zephyr_tpu_torch.utils.metrics import ServingMetrics

CFG = tiny_config()
TCFG = port_config(CFG)
# The combined case's model: a 16-token sliding window inside a 64-token cache.
WCFG = dataclasses.replace(CFG, decoder=dataclasses.replace(CFG.decoder, sliding_window=16))


@pytest.fixture(scope="module")
def models():
    """{"target" | "other": (JAX params, port model)}: the served model and a
    draft of other weights."""
    out = {}
    for name, seed in (("target", 0), ("other", 7)):
        params = jax_params_numpy(CFG, seed)
        out[name] = (params, port_model(params, CFG))
    return out


def recorded(draft) -> list:
    """Record each round of `draft`: its proposals, then its length mirror
    once the round rolls back (the same hooks on the JAX and the port's
    DraftModel)."""
    rounds = []
    propose, rollback = draft.propose, draft.rollback

    def recording_propose(active, pending, caps, span):
        out = propose(active, pending, caps, span)
        rounds.append([None if p is None else [int(t) for t in p] for p in out])
        return out

    def recording_rollback():
        rollback()
        rounds.append(draft.len.tolist())

    draft.propose, draft.rollback = recording_propose, recording_rollback
    return rounds


def drive(b, requests, staggered: bool):
    """Submit `requests` (ids arrays) and run `b` dry; `staggered`: one
    scheduler step between the first request and the rest."""
    handles = [b.submit(np.asarray(requests[0]), None, None)]
    if staggered:
        b.step()
    handles += [b.submit(np.asarray(ids), None, None) for ids in requests[1:]]
    b.run_until_drained()
    return [list(b.stream(h)) for h in handles]


# name -> (seed, prompt lengths, lookahead, draft weights, draft cache_len,
#          max_new_tokens, paged, staggered)
CASES = {
    "selfdraft": (1, (7, 5), 4, "target", 64, 16, False, False),
    "random_draft": (2, (6,), 3, "other", 64, 12, False, False),
    "paged": (3, (7, 9), 4, "target", 64, 16, True, False),
    "declined_to_lookup": (4, "copy", 4, "target", 16, 16, False, False),
    "tight_draft_cache": (5, (7,), 8, "target", 12, 12, False, False),
    "budget_1": (6, (6,), 5, "target", 64, 1, False, False),
    "budget_2": (6, (6,), 5, "target", 64, 2, False, False),
    "budget_3": (6, (6,), 5, "target", 64, 3, False, False),
    "interleaved": (7, (5, 7), 3, "target", 64, 10, False, True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_draft_rounds_and_streams_match_jax(models, name):
    seed, lengths, lookahead, weights, draft_len, max_new, paged, staggered = CASES[name]
    rng = np.random.default_rng(seed)
    if lengths == "copy":  # copy-heavy: prompt lookup has something to propose
        requests = [np.tile(rng.integers(5, 40, (5,)), 4)]
    else:
        requests = [rng.integers(5, 60, (n,)) for n in lengths]
    params, port = models["target"]
    dparams, dport = models[weights]
    kw = dict(max_slots=4, cache_len=64)

    def port_batcher(lookahead, draft=None, metrics=None):
        sampling = tgen.SamplingConfig(max_new_tokens=max_new, eos_token_id=-1)
        if paged:
            return tpaged.PagedBatcher(port, TCFG, page_size=16, num_pages=32, sampling=sampling,
                                       lookahead=lookahead, draft=draft, metrics=metrics, **kw)
        return tbatching.ContinuousBatcher(port, TCFG, sampling=sampling, lookahead=lookahead,
                                           draft=draft, metrics=metrics, **kw)

    draft = tdraft.DraftModel(dport, TCFG, max_slots=4, cache_len=draft_len)
    rounds = recorded(draft)
    metrics = ServingMetrics()
    spec = port_batcher(lookahead, draft, metrics)
    got = drive(spec, requests, staggered)

    jd = jdraft.DraftModel(dparams, CFG, max_slots=4, cache_len=draft_len)
    jrounds = recorded(jd)
    jmetrics = JServingMetrics()
    want = drive(jbatching.ContinuousBatcher(
        params, CFG, sampling=jgen.SamplingConfig(max_new_tokens=max_new, eos_token_id=-1),
        lookahead=lookahead, draft=jd, metrics=jmetrics, **kw), requests, staggered)

    assert got == want == drive(port_batcher(0), requests, staggered)
    assert all(len(r) == max_new for r in got)
    assert rounds == jrounds
    assert draft.len.tolist() == jd.len.tolist() == [0] * 4  # every slot released
    summary, jsummary = metrics.summary(), jmetrics.summary()
    for key in ("requests", "tokens_out", "speculation"):
        assert summary.get(key) == jsummary.get(key), key
    assert summary["ttft_ms"]["count"] == len(requests)
    assert (metrics.spec_proposed, metrics.spec_accepted) == (spec.proposed, spec.accepted)
    if name == "selfdraft":  # the target drafting for itself: every proposal lands
        assert 0 < spec.accepted == spec.proposed
    if name == "declined_to_lookup":  # never drafted, yet lookup proposed
        assert draft.admissions == 0 and not any(isinstance(r[0], list) for r in rounds[::2])
        assert spec.proposed > 0
    elif max_new > 2:
        assert draft.admissions == len(requests) and draft.steps > 0


def test_tight_cache_caps_span_like_jax(models):
    """A slot whose draft cache can't hold the FULL span drafts a SHORTER
    one (rows = len + allowed + 2 == cache_len), then none: call for call
    what the JAX DraftModel returns."""
    params, port = models["target"]
    hist = [int(t) for t in np.random.default_rng(8).integers(5, 60, (7,))]
    active = np.array([True, False, False, False])
    pending = np.array([hist[-1], 0, 0, 0])
    caps = np.array([8, 0, 0, 0])
    runs = []
    for draft in (tdraft.DraftModel(port, TCFG, max_slots=4, cache_len=12),
                  jdraft.DraftModel(params, CFG, max_slots=4, cache_len=12)):
        assert draft.admit(0, hist) and draft.len[0] == 6
        first = draft.propose(active, pending, caps, span=8)
        drafted = bool(draft._drafted[0])
        draft.commit(0, 5)  # pending + 4 accepted
        draft.rollback()
        length = int(draft.len[0])
        second = draft.propose(active, pending, caps, span=8)
        runs.append(([int(t) for t in first[0]], [p is None for p in first[1:]], drafted,
                     length, second[0] is None, bool(draft._drafted[0])))
    assert runs[0] == runs[1]
    assert len(runs[0][0]) == 4 and runs[0][2:] == (True, 11, True, False)


def test_every_feature_at_once_matches_plain_and_jax(models):
    """Paged int8 fused pools, chunked prefill, a sliding window, images and
    more requests than slots and pages hold at once, with a draft of the
    target's weights: each stream equals plain greedy's (the port's
    batcher without speculation) and the JAX dense batcher's with its
    draft; every page comes back."""
    params = jax_params_numpy(WCFG, 0)
    port = port_model(params, WCFG)
    tcfg = port_config(WCFG)
    rng = np.random.default_rng(9)
    image_ids = np.array([1, 5, IMAGE_TOKEN_INDEX, 7, 9, 11, 13, 7, 9])
    pixels = rng.standard_normal((4, 56, 56, 3)).astype(np.float32)
    valid = np.array([True, True, False, False])
    requests = [(rng.integers(5, 60, (6,)), None, None),
                (image_ids, pixels, valid),
                (np.tile(rng.integers(5, 40, (5,)), 4), None, None),
                (rng.integers(5, 60, (21,)), None, None),
                (rng.integers(5, 60, (7,)), None, None)]

    def run(b):
        handles = [b.submit(ids, px, pv) for ids, px, pv in requests]
        b.run_until_drained()
        return [list(b.stream(h)) for h in handles]

    sampling = tgen.SamplingConfig(max_new_tokens=12, eos_token_id=-1)
    kw = dict(max_slots=3, cache_len=64, page_size=16, num_pages=14, kv_quant=True,
              kv_fused=True, prefill_chunk=16, sampling=sampling)
    draft = tdraft.DraftModel(port, tcfg, max_slots=3, cache_len=64)
    spec = tpaged.PagedBatcher(port, tcfg, lookahead=3, draft=draft, **kw)
    got = run(spec)
    assert got == run(tpaged.PagedBatcher(port, tcfg, **kw))
    want = run(jbatching.ContinuousBatcher(
        params, WCFG, max_slots=3, cache_len=64, prefill_chunk=16, lookahead=3,
        sampling=jgen.SamplingConfig(max_new_tokens=12, eos_token_id=-1),
        draft=jdraft.DraftModel(params, WCFG, max_slots=3, cache_len=64)))
    assert got == want
    assert all(len(r) == 12 for r in got)
    assert draft.admissions == len(requests) and spec.accepted > 0
    assert not spec.active.any() and spec.allocator.available == 13
