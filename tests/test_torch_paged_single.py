"""The port's single-row paged attention and writefirst decode step against
the JAX package, on the CPU.

- `paged_attention` (one query row a slot, `lengths` tokens in the pool):
  split and fused pools, bf16 and int8, with and without the self-term,
  window none and 16, a non-default scale. The JAX function runs its Pallas
  kernels in interpret mode: `_make_kernel` for split pools with the
  self-term, `paged_attention_fa` otherwise. f32 queries, so that both sides
  round only where the kernels do (a probability to the pool's bf16, none
  for int8): outputs agree to 2e-5 absolute, as in test_torch_paged_ops.py.
- `paged_attention_fa(fold_heads=False)` (the JAX package's (slot, kv head)
  grid, `_fa_kernel`) at S = 1 and 3 over split pools, and its two refusals
  (a self-term, fused pools) in both packages.
- `_paged_step(mode="writefirst")` for 4 steps at `tiny_config` on f32
  weights, over bf16 split and int8 fused pools with an inactive slot:
  greedy tokens equal to the JAX step's and to the port's own selfterm
  step's; lengths equal; pools and scales as the paged batcher's tests hold
  them (int8 values within 1 and almost all equal, bf16 within one ulp and
  almost all equal, scales to 1e-4: the two frameworks' f32 layers round
  differently, which can move a written value across a rounding boundary).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import jax_params_numpy, port_config, port_model
from vis_zephyr_tpu.config import tiny_config
from vis_zephyr_tpu.ops import paged_attention as jpa
from vis_zephyr_tpu.serve import generate as jgen
from vis_zephyr_tpu.serve import paged as jpaged
from vis_zephyr_tpu_torch.ops import paged_attention as tpa
from vis_zephyr_tpu_torch.serve import generate as tgen
from vis_zephyr_tpu_torch.serve import paged as tpaged

TOL = dict(rtol=0, atol=2e-5)
HQ, HKV, D, PS, PPS, NPAGES = 8, 2, 128, 16, 4, 32


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _np32(x):
    """A JAX or torch array as f32 numpy (bf16 widens exactly); int8 stays."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return (x if x.dtype == torch.int8 else x.float()).numpy()
    return np.asarray(x if x.dtype == jnp.int8 else x.astype(jnp.float32))


def make_case(seed, lengths, pool, fused):
    """Pools in the JAX layout: JAX arrays (bf16, or int8 with scales) and
    the port's tensors holding the same values."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    table = rng.permutation(np.arange(1, NPAGES))[: B * PPS].reshape(B, PPS).astype(np.int32)
    q = rng.standard_normal((B, HQ, D)).astype(np.float32)
    kp = rng.standard_normal((HKV, NPAGES, PS, D)).astype(np.float32)
    vp = rng.standard_normal((HKV, NPAGES, PS, D)).astype(np.float32)
    ksc = vsc = None
    if pool == "int8":
        kp, ksc = (np.asarray(a) for a in jpa.quantize_kv_pool(jnp.asarray(kp)))
        vp, vsc = (np.asarray(a) for a in jpa.quantize_kv_pool(jnp.asarray(vp)))
    else:  # bf16 values, held as f32 numpy
        kp = _np32(jnp.asarray(kp, jnp.bfloat16))
        vp = _np32(jnp.asarray(vp, jnp.bfloat16))
    if fused:
        kp, vp = np.concatenate([kp, vp], axis=2), None
        if pool == "int8":
            ksc, vsc = np.concatenate([ksc, vsc], axis=3), None
    k_new = rng.standard_normal((B, HKV, D)).astype(np.float32)
    v_new = rng.standard_normal((B, HKV, D)).astype(np.float32)
    jk, jv = _j(kp), _j(vp)
    tk, tv, tks, tvs = (_t(a) for a in tpa.pools_from_jax_layout(kp, vp, ksc, vsc))
    if pool == "bf16":
        jk, tk = jk.astype(jnp.bfloat16), tk.to(torch.bfloat16)
        if vp is not None:
            jv, tv = jv.astype(jnp.bfloat16), tv.to(torch.bfloat16)
    return dict(q=q, table=table, lengths=np.asarray(lengths, np.int32), k_new=k_new,
                v_new=v_new, jax=(jk, jv, _j(ksc), _j(vsc)), port=(tk, tv, tks, tvs))


# Lengths: nothing in the pool, one token, a page boundary and past it, 37, full.
LENGTHS = [0, 1, PS, PS + 1, 37, PPS * PS]


@pytest.mark.parametrize("selfterm", [False, True], ids=["pool-only", "selfterm"])
@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_paged_attention_matches_jax(fused, pool, selfterm):
    case = make_case(0, LENGTHS, pool, fused)
    got, want = run_single(case, case["lengths"], selfterm)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(want).max() > 0.1
    if not selfterm:  # length 0 without a self-term: no key at all → exact zeros
        assert not got[0].any() and not want[0].any()


@pytest.mark.parametrize("fused,pool,selfterm", [(False, "int8", True), (False, "bf16", False),
                                                 (True, "int8", False), (True, "bf16", True)],
                         ids=["split-int8-selfterm", "split-bf16-pool-only",
                              "fused-int8-pool-only", "fused-bf16-selfterm"])
def test_paged_attention_windowed_scaled_matches_jax(fused, pool, selfterm):
    """A window of 16 and a non-default scale; the window cuts keys."""
    case = make_case(1, [60, 33, 17, 5], pool, fused)
    got, want = run_single(case, case["lengths"], selfterm, window=16, scale=0.05)
    np.testing.assert_allclose(got, want, **TOL)
    unwindowed, _ = run_single(case, case["lengths"], selfterm, scale=0.05, jax_too=False)
    assert np.abs(got[0] - unwindowed[0]).max() > 1e-3


def run_single(case, lengths, selfterm, window=None, scale=None, jax_too=True):
    """(port `paged_attention`, JAX `paged_attention` in interpret mode)."""
    jk, jv, jks, jvs = case["jax"]
    tk, tv, tks, tvs = case["port"]
    new = dict(k_new=case["k_new"], v_new=case["v_new"]) if selfterm else {}
    before = tpa.attn_launches
    got = tpa.paged_attention(
        _t(case["q"]), tk, tv, _t(case["table"]), _t(lengths), scale=scale,
        sliding_window=window, k_scales=tks, v_scales=tvs,
        **{k: _t(v) for k, v in new.items()}).numpy()
    assert got.shape == case["q"].shape and tpa.attn_launches == before  # the plain version
    if not jax_too:
        return got, None
    want = jpa.paged_attention(
        _j(case["q"]), jk, jv, _j(case["table"]), _j(lengths), scale=scale, interpret=True,
        sliding_window=window, k_scales=jks, v_scales=jvs, **{k: _j(v) for k, v in new.items()})
    return got, np.asarray(want)


def test_paged_attention_takes_the_layer_offset():
    """`page_offset` is added to every table entry: a table into pages
    [off, N) read at offset 0 equals that table less `off` read at `off`."""
    case = make_case(2, [5, 40], "int8", False)
    tk, tv, tks, tvs = case["port"]
    off = 8
    rng = np.random.default_rng(9)
    table = rng.permutation(np.arange(off, NPAGES))[: 2 * PPS].reshape(2, PPS).astype(np.int32)
    q, lengths = _t(case["q"]), _t(case["lengths"])
    whole = tpa.paged_attention(q, tk, tv, _t(table), lengths, k_scales=tks, v_scales=tvs)
    shifted = tpa.paged_attention(q, tk, tv, _t(table - off), lengths, k_scales=tks,
                                  v_scales=tvs, page_offset=off)
    assert torch.equal(whole, shifted) and whole.abs().max() > 0


# -- row 8: the (slot, kv head) grid --------------------------------------------------


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_unfolded_grid_matches_jax(pool, S):
    case = make_case(3, [S, 9, 30, 64], pool, False)
    jk, jv, jks, jvs = case["jax"]
    tk, tv, tks, tvs = case["port"]
    lengths = case["lengths"]
    q = np.random.default_rng(4).standard_normal((len(lengths), S, HQ, D)).astype(np.float32)
    q_offs = lengths - S
    want = jpa.paged_attention_fa(_j(q), jk, jv, _j(case["table"]), _j(lengths), _j(q_offs),
                                  k_scales=jks, v_scales=jvs, fold_heads=False, interpret=True)
    kw = dict(k_scales=tks, v_scales=tvs)
    got = tpa.paged_attention_fa(_t(q), tk, tv, _t(case["table"]), _t(lengths), _t(q_offs),
                                 fold_heads=False, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    folded = tpa.paged_attention_fa(_t(q), tk, tv, _t(case["table"]), _t(lengths), _t(q_offs),
                                    **kw)
    assert torch.equal(got, folded)  # one kernel, one arithmetic, either grid


def test_unfolded_grid_refusals_match_jax():
    """A self-term, and fused pools, need the folded grid in both packages."""
    for fused, selfterm in ((False, True), (True, False)):
        case = make_case(5, [3, 7], "bf16", fused)
        jk, jv, _, _ = case["jax"]
        tk, tv, _, _ = case["port"]
        lengths = case["lengths"]
        new = dict(k_new=case["k_new"], v_new=case["v_new"]) if selfterm else {}
        q_offs = lengths if selfterm else lengths - 1
        q = case["q"][:, None]
        with pytest.raises(ValueError, match="folded grid") as jax_err:
            jpa.paged_attention_fa(_j(q), jk, jv, _j(case["table"]), _j(lengths), _j(q_offs),
                                   fold_heads=False, interpret=True,
                                   **{k: _j(v) for k, v in new.items()})
        with pytest.raises(ValueError, match="folded grid") as port_err:
            tpa.paged_attention_fa(_t(q), tk, tv, _t(case["table"]), _t(lengths), _t(q_offs),
                                   fold_heads=False, **{k: _t(v) for k, v in new.items()})
        assert str(port_err.value) == str(jax_err.value)


# -- the writefirst decode step ------------------------------------------------------------

CFG = tiny_config(vocab_size=256)
TCFG = port_config(CFG)


@pytest.fixture(scope="module")
def models():
    params = jax_params_numpy(CFG, 2)
    return params, port_model(params, CFG)


def assert_pools_close(got, want, where):
    """int8: within 1, almost all equal; bf16: within one ulp, almost all
    equal; f32 scales to 1e-4 (the paged batcher tests' tolerances)."""
    for name, g, w in zip(("k_pages", "v_pages", "k_scales", "v_scales"), got, want):
        assert (g is None) == (w is None), (where, name)
        if g is None:
            continue
        if g.dtype == np.int8:
            diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1 and (diff != 0).mean() < 1e-3, (where, name, diff.max())
        elif name.endswith("scales"):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=f"{where} {name}")
        else:  # bf16 values widened to f32
            np.testing.assert_allclose(g, w, rtol=2 ** -7, atol=1e-6, err_msg=f"{where} {name}")
            assert (g != w).mean() < 1e-3, (where, name, (g != w).mean())


def step_state(pool):
    """Three slots: one crossing a page boundary during the 4 steps, one
    inactive (it writes page 0 of every layer), one with a longer history;
    the pools hold random rows in the JAX layout."""
    quant = fused = pool == "int8-fused"
    dec = CFG.decoder
    L, Hkv, hd = dec.num_layers, dec.num_kv_heads, dec.head_dim
    ps, P = 16, 10
    rng = np.random.default_rng(7)
    rows = 2 * ps if fused else ps
    shape = (Hkv, L * P, rows, hd)
    ksc = vsc = vp = None
    if quant:
        kp, ksc = (np.asarray(a) for a in jpa.quantize_kv_pool(
            jnp.asarray(rng.standard_normal(shape).astype(np.float32))))
    else:
        kp = _np32(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))
        vp = _np32(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))
    table = np.array([[1, 2, 0, 0], [0, 0, 0, 0], [6, 7, 8, 9]], np.int32)
    lengths = np.array([14, 0, 37], np.int32)
    active = np.array([True, False, True])
    token = np.array([17, dec.pad_token_id, 101], np.int32)
    return dict(pools=(kp, vp, ksc, vsc), table=table, lengths=lengths, active=active,
                token=token, quant=quant)


def port_pools(state):
    tk, tv, tks, tvs = (_t(a) for a in tpa.pools_from_jax_layout(*state["pools"]))
    if not state["quant"]:
        tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
    return tk, tv, tks, tvs


def run_port(model, state, mode, steps=4):
    tk, tv, tks, tvs = port_pools(state)
    # Copies: the step updates lengths and token in place.
    table, lengths = _t(state["table"].copy()), _t(state["lengths"].copy())
    token = _t(state["token"]).long()
    active = _t(state["active"].copy())
    sampling = tgen.SamplingConfig(max_new_tokens=8, eos_token_id=-1)
    tokens, lens = [], []
    for _ in range(steps):
        tpaged._paged_step(model, tk, tv, (tks, tvs), table, lengths, token, active, None, TCFG,
                           sampling, mode=mode)
        tokens.append(token.numpy().copy())
        lens.append(lengths.numpy().copy())
    return tokens, lens, (tk, tv, tks, tvs)


@pytest.mark.parametrize("pool", ["bf16-split", "int8-fused"])
def test_writefirst_step_matches_jax(models, pool):
    params, port = models
    state = step_state(pool)
    kp, vp, ksc, vsc = state["pools"]
    jk, jv = _j(kp), _j(vp)
    if not state["quant"]:
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
    scales = (_j(ksc), _j(vsc))
    table, lengths = _j(state["table"]), _j(state["lengths"])
    token, active = _j(state["token"]), _j(state["active"])
    sampling = jgen.SamplingConfig(max_new_tokens=8, eos_token_id=-1)
    want_tokens, want_lens = [], []
    for _ in range(4):
        token, jk, jv, scales, lengths, _, _ = jpaged._paged_step(
            params, jk, jv, scales, table, lengths, token, active, jax.random.PRNGKey(0), CFG,
            sampling, mode="writefirst")
        want_tokens.append(np.asarray(token))
        want_lens.append(np.asarray(lengths))

    tokens, lens, pools = run_port(port, state, "writefirst")
    for i in range(4):
        np.testing.assert_array_equal(tokens[i], want_tokens[i], err_msg=f"step {i}")
        np.testing.assert_array_equal(lens[i], want_lens[i], err_msg=f"step {i}")
    assert (lens[-1] == state["lengths"] + 4 * state["active"]).all()
    assert (tokens[-1][~state["active"]] == CFG.decoder.pad_token_id).all()
    got = tpa.pools_to_jax_layout(*(_np32(a) for a in pools))
    assert_pools_close(got, [_np32(a) for a in (jk, jv, *scales)], pool)
    # Each active slot's 4 new rows were written, in every layer.
    P, ps = 10, 16
    before = state["pools"][0]
    for b in np.nonzero(state["active"])[0]:
        for n in range(state["lengths"][b], state["lengths"][b] + 4):
            page = state["table"][b, n // ps]
            for layer in range(CFG.decoder.num_layers):
                assert (got[0][:, layer * P + page, n % ps] != before[:, layer * P + page, n % ps]).any()

    # The port's own selfterm step decodes the same tokens.
    self_tokens, self_lens, _ = run_port(port, state, "selfterm")
    for i in range(4):
        np.testing.assert_array_equal(self_tokens[i], tokens[i], err_msg=f"selfterm step {i}")
        np.testing.assert_array_equal(self_lens[i], lens[i])
