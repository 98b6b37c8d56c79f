"""The port's dense continuous batcher against the JAX package's, on the CPU at
`tiny_config`.

Both packages run the same f32 weights (through the weight bridge) and one
scripted scenario: requests with and without an image, a prompt of three
16-token chunks, repetitive prompts that prompt lookup can propose from,
budgets of 0 to 12, a prompt too long for its slot, more requests than
slots, and requests submitted while others decode. The JAX batcher runs it
once with whole-prompt admission; the port runs it whole, in chunks, in
bursts of 4 and with `lookahead` 4, and each gives the JAX batcher's greedy
tokens per request (the JAX package holds those forms token-equal to plain
greedy itself: `tests/test_batching.py`, `tests/test_chunked_prefill.py`).
One dense decode step with penalties and logprobs is held against the JAX
step on the same cache.
"""

import numpy as np
import pytest
import torch

from torch_port_util import jax_params_numpy, port_config, port_model
from vis_zephyr_tpu.config import tiny_config
from vis_zephyr_tpu.constants import IMAGE_TOKEN_INDEX
from vis_zephyr_tpu.serve import batching as jbatching
from vis_zephyr_tpu.serve import generate as jgen
from vis_zephyr_tpu_torch.serve import batching as tbatching
from vis_zephyr_tpu_torch.serve import generate as tgen

CFG = tiny_config(vocab_size=256)
TCFG = port_config(CFG)
SLOTS, CACHE_LEN, MAX_NEW = 4, 256, 6
VARIANTS = {
    "whole": {},
    "chunked": dict(prefill_chunk=16),
    "burst": dict(multi_step=4),
    "lookahead": dict(lookahead=4),
}


@pytest.fixture(scope="module")
def models():
    params = jax_params_numpy(CFG, 1)
    return params, port_model(params, CFG)


def scenario():
    """[(ids, images, patch_valid, max_new_tokens, submit before step N)]:
    10 requests for 4 slots, one too long for a 256-row slot."""
    rng = np.random.default_rng(0)
    side = CFG.vision.image_size

    def request(T, with_image=False, max_new=None, at=0, repeat=False):
        if repeat:
            ids = np.tile(rng.integers(5, 60, (6,)), T // 6).astype(np.int64)
        else:
            ids = rng.integers(5, CFG.decoder.vocab_size, (T,)).astype(np.int64)
        images = valid = None
        if with_image:
            ids[1] = IMAGE_TOKEN_INDEX
            images = rng.standard_normal((3, side, side, 3)).astype(np.float32)
            valid = np.array([True, True, False])
        return ids, images, valid, max_new, at

    return [request(5, True), request(40, max_new=5), request(24, max_new=12, repeat=True),
            request(8, True, 3), request(7, max_new=4, at=2), request(6, max_new=1, at=2),
            request(6, max_new=0, at=3), request(7, max_new=300), request(5, at=4),
            request(24, max_new=10, at=5, repeat=True)]


def drive(batcher, requests, max_steps=300):
    """Run the scripted scenario; returns the tokens of each request."""
    handles = {}
    for step in range(max_steps):
        for i, (ids, images, valid, max_new, at) in enumerate(requests):
            if at == step:
                handles[i] = batcher.submit(ids, images, valid, max_new_tokens=max_new)
        if len(handles) == len(requests) and not batcher.has_work:
            break
        batcher.step()
    assert not batcher.has_work
    return [list(batcher.stream(handles[i])) for i in range(len(requests))]


@pytest.fixture(scope="module")
def jax_tokens(models):
    sampling = jgen.SamplingConfig(max_new_tokens=MAX_NEW, temperature=0.0, eos_token_id=-1)
    b = jbatching.ContinuousBatcher(models[0], CFG, max_slots=SLOTS, cache_len=CACHE_LEN,
                                    sampling=sampling)
    return drive(b, scenario())


def port_batcher(model, **variant):
    sampling = tgen.SamplingConfig(max_new_tokens=MAX_NEW, temperature=0.0, eos_token_id=-1)
    return tbatching.ContinuousBatcher(model, TCFG, max_slots=SLOTS, cache_len=CACHE_LEN,
                                       sampling=sampling, **variant)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_greedy_tokens_match_jax(models, jax_tokens, variant):
    b = port_batcher(models[1], **VARIANTS[variant])
    got = drive(b, scenario())
    assert got == jax_tokens
    budgets = [MAX_NEW if m is None else m for _, _, _, m, _ in scenario()]
    assert [len(t) for t in got] == [0 if m == 300 else m for m in budgets]
    # Every slot is free again, and the form under test ran.
    assert not b.active.any() and all(r is None for r in b.slot_req)
    if variant == "burst":
        assert b.bursts > 0
    if variant == "lookahead":
        assert b.verify_steps > 0 and b.accepted > 0
    else:
        assert b.verify_steps == 0


def test_too_long_prompt_rejected_and_slots_reused(models):
    """A request past its slot's rows ends with no token, and a pool of one
    slot serves every other request in turn."""
    sampling = tgen.SamplingConfig(max_new_tokens=3, temperature=0.0, eos_token_id=-1)
    b = tbatching.ContinuousBatcher(models[1], TCFG, max_slots=1, cache_len=64,
                                    sampling=sampling)
    rng = np.random.default_rng(1)
    handles = [b.submit(rng.integers(5, 200, (4 + i,))) for i in range(4)]
    too_long = b.submit(rng.integers(5, 200, (10,)), max_new_tokens=60)
    b.run_until_drained()
    assert [len(list(b.stream(h))) for h in handles] == [3] * 4
    assert list(b.stream(too_long)) == []
    assert not b.active.any()


def test_batch_step_matches_jax(models):
    """One dense decode step over 4 slots (one inactive) with penalties and
    logprobs on, from the same cache: tokens, lengths and counts equal, the
    written rows and the logprobs within 1e-4."""
    params, port = models
    dec = CFG.decoder
    rng = np.random.default_rng(3)
    shape = (dec.num_layers, SLOTS, CACHE_LEN, dec.num_kv_heads, dec.head_dim)
    k = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    v = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    lengths = np.array([5, 0, 37, 200], np.int32)
    token = np.array([7, 1, 99, 3], np.int64)
    active = np.array([True, False, True, True])
    counts = rng.integers(0, 3, (SLOTS, dec.vocab_size)).astype(np.float32)
    freq = np.array([0.5, 0.0, 0.0, 1.0], np.float32)
    pres = np.array([1.0, 0.0, 2.0, 0.0], np.float32)
    sampling = dict(max_new_tokens=4, temperature=0.0, eos_token_id=-1)

    import jax
    import jax.numpy as jnp

    cache = {"k": jnp.asarray(k), "v": jnp.asarray(v), "length": jnp.asarray(lengths)}
    want_tok, want_cache, want_lp, want_counts = jbatching._batch_step(
        params, cache, jnp.asarray(token, jnp.int32), jnp.asarray(active),
        jax.random.PRNGKey(0), CFG, jgen.SamplingConfig(**sampling), want_logprobs=True,
        penalties=(jnp.asarray(freq), jnp.asarray(pres), jnp.asarray(counts)))

    tcache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
              "length": torch.from_numpy(lengths.copy())}
    tcounts = torch.from_numpy(counts.copy())
    ttoken = torch.from_numpy(token.copy())
    got_tok, logits = tbatching._batch_step(
        port, tcache, ttoken, torch.from_numpy(active), None, TCFG,
        tgen.SamplingConfig(**sampling),
        penalties=(torch.from_numpy(freq), torch.from_numpy(pres), tcounts))
    got_lp = tgen._logprobs(logits, got_tok)

    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(ttoken.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(tcache["length"].numpy(), np.asarray(want_cache["length"]))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(want_counts))
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(want_cache[name]),
                                   atol=1e-4, rtol=1e-4)
    rows = active.nonzero()[0]
    np.testing.assert_allclose(got_lp[0].numpy()[rows], np.asarray(want_lp[0])[rows], atol=1e-4)
    np.testing.assert_array_equal(got_lp[1].numpy()[rows], np.asarray(want_lp[1])[rows])
    np.testing.assert_allclose(got_lp[2].numpy()[rows], np.asarray(want_lp[2])[rows], atol=1e-4)


def test_burst_leaves_the_single_steps_state(models):
    """A burst of 4 `_batch_multi_step` steps against 4 `_batch_step`s with
    the carry kept on the host, budgets 1 to 4: tokens, alive masks, cache
    and lengths bit for bit."""
    port = models[1]
    dec = CFG.decoder
    rng = np.random.default_rng(4)
    shape = (dec.num_layers, SLOTS, 64, dec.num_kv_heads, dec.head_dim)
    base = {"k": torch.from_numpy((0.5 * rng.standard_normal(shape)).astype(np.float32)),
            "v": torch.from_numpy((0.5 * rng.standard_normal(shape)).astype(np.float32)),
            "length": torch.tensor([3, 9, 0, 20], dtype=torch.int32)}
    token0 = torch.tensor([5, 6, 7, 8])
    active = torch.tensor([True, True, False, True])
    left = torch.tensor([4, 1, 4, 2], dtype=torch.int32)
    sampling = tgen.SamplingConfig(max_new_tokens=8, temperature=0.0, eos_token_id=-1)

    cache = {name: t.clone() for name, t in base.items()}
    token = token0.clone()
    toks, entry, _ = tbatching._batch_multi_step(port, cache, token, active, left, None, TCFG,
                                                 sampling, n=4)

    ref = {name: t.clone() for name, t in base.items()}
    ref_token, alive, steps = token0.clone(), active.clone(), left.clone()
    for j in range(4):
        assert torch.equal(entry[j], alive)
        tok, _ = tbatching._batch_step(port, ref, ref_token, alive, None, TCFG, sampling)
        assert torch.equal(toks[j], tok)
        steps -= 1
        alive = alive & (steps > 0)
    for name in ("k", "v", "length"):
        assert torch.equal(cache[name], ref[name]), name
    assert torch.equal(token, ref_token)
