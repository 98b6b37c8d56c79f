"""The port's writefirst decode step against the JAX package's, on the CPU
(moved from `test_torch_paged_single.py`).

`_paged_step(mode="writefirst")` for 4 steps at `tiny_config` on f32
weights, over bf16 split and int8 fused pools with an inactive slot: greedy
tokens equal to the JAX step's and to the port's own selfterm step's;
lengths equal; pools and scales as the paged batcher's tests hold them
(int8 values within 1 and almost all equal, bf16 within one ulp and almost
all equal, scales to 1e-4: the two frameworks' f32 layers round
differently, which can move a written value across a rounding boundary).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_port_util import jax_params_numpy, port_config, port_model
from torch_port_util import np32 as _np32, to_jax as _j, to_torch as _t
from vis_zephyr_tpu.config import tiny_config
from vis_zephyr_tpu.ops import paged_attention as jpa
from vis_zephyr_tpu.serve import generate as jgen
from vis_zephyr_tpu.serve import paged as jpaged
from vis_zephyr_tpu_torch.ops import paged_attention as tpa
from vis_zephyr_tpu_torch.serve import generate as tgen
from vis_zephyr_tpu_torch.serve import paged as tpaged

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
