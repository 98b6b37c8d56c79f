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
and lands on the JAX snapshot after it. The batcher's other cases and the
paged server under concurrent `/chat` clients are in
`test_torch_paged_serve_requests.py`.
"""


import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from conftest import MockTokenizer
from torch_port_util import (assert_same_state, drive, jax_params_numpy, jax_snapshot,
                             port_config, port_model, port_snapshot)
from vis_zephyr_tpu.config import tiny_config
from vis_zephyr_tpu.constants import IMAGE_TOKEN_INDEX
from vis_zephyr_tpu.serve import generate as jgen
from vis_zephyr_tpu.serve import paged as jpaged
from vis_zephyr_tpu_torch.ops import paged_attention as tpa
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
