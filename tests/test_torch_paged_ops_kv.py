"""The port's paged-KV ops against the JAX package, on the CPU in f32 (moved
from `test_torch_paged_ops.py`, which holds the one-slot schedule's
attention): `paged_attention_fa` against the JAX default grouped schedule
(`_fa_gmh_kernel`, four slots a program) and with a window of 24 keys
(which does cut keys), the int8 KV quantization and the pool forms, and the
row write into every pool form. The JAX kernels run in interpret mode;
attention outputs agree to 2e-5 absolute, int8 values, scales and written
pools bit for bit. The cases are `tests/torch_port_util.py`'s `ops_case`
and `ops_run_both`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_port_util import (OPS_D as D, OPS_HKV as HKV, OPS_PPS as PPS, OPS_PS as PS,
                             OPS_TOL as TOL, ops_case as make_case, ops_run_both as run_both,
                             to_jax as _j, to_torch as _t)
from vis_zephyr_tpu.ops import paged_attention as jpa
from vis_zephyr_tpu_torch.ops import paged_attention as tpa


@pytest.mark.parametrize("fused,quant,selfterm", [(True, True, True), (False, False, False)],
                         ids=["fused-int8-selfterm", "split-f32-pool-only"])
def test_paged_attention_plain_matches_jax_grouped_kernel(fused, quant, selfterm):
    """The JAX package's default schedule (four slots per program; B = 6 pads to 8)."""
    case = make_case(10, [0, 1, PS, PS + 1, 37, PPS * PS], quant, fused)
    got, want = run_both(case, selfterm, slot_block=None)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("fused,quant,selfterm", [(True, True, True), (False, False, False)],
                         ids=["fused-int8-selfterm", "split-f32-pool-only"])
def test_paged_attention_windowed_matches_jax_kernel(fused, quant, selfterm):
    case = make_case(1, [60, 33, 17, 5], quant, fused)
    got, want = run_both(case, selfterm, window=24)
    np.testing.assert_allclose(got, want, **TOL)
    q, kp, vp, ksc, vsc, table, lengths, k_new, v_new = case
    tk, tv, tks, tvs = (_t(a) for a in tpa.pools_from_jax_layout(kp, vp, ksc, vsc))
    new = dict(k_new=_t(k_new), v_new=_t(v_new)) if selfterm else {}
    unwindowed = tpa.paged_attention_fa(
        _t(q), tk, tv, _t(table), _t(lengths), _t(lengths if selfterm else lengths - 1),
        k_scales=tks, v_scales=tvs, **new).numpy()
    assert np.abs(got[0] - unwindowed[0]).max() > 1e-3  # the window does cut keys


# -- quantization -------------------------------------------------------------------


def quant_rows():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4096, 128)).astype(np.float32)
    x[0] = np.abs(x[0])
    x[0, 7] = x[0].max() + 1.0      # the absmax element is positive: rint gives 128
    x[1] = -np.abs(x[1])
    x[1, 9] = x[1].min() - 1.0      # the absmax element is negative: -128
    x[2] = 0.0                      # scale 0 → the 1e-9 floor
    return x


def test_quantize_kv_matches_jax_bit_for_bit():
    x = quant_rows()
    want_q, want_s = (np.asarray(a) for a in jpa.quantize_kv(jnp.asarray(x)))
    got_q, got_s = tpa.quantize_kv(_t(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    # The saturating convert, not a wrap: +absmax stores 127, −absmax stores −128.
    assert got_q[0, 7] == 127 and got_q[1, 9] == -128
    assert got_q.min() == -128 and got_q.max() == 127 and not got_q[2].any()


def test_quantize_kv_bf16_rows_match_jax():
    x = quant_rows()[:64]
    want_q, want_s = (np.asarray(a) for a in jpa.quantize_kv(jnp.asarray(x, jnp.bfloat16)))
    got_q, got_s = tpa.quantize_kv(_t(x).to(torch.bfloat16))
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)


def test_dequant_and_pool_forms_match_jax():
    pool = np.random.default_rng(7).standard_normal((HKV, 6, PS, D)).astype(np.float32)
    jq, js = jpa.quantize_kv_pool(jnp.asarray(pool))
    port_pool = tpa.pools_from_jax_layout(pool)[0]
    tq, ts = tpa.quantize_kv_pool(_t(port_pool))
    back_q, _, back_s, _ = tpa.pools_to_jax_layout(tq.numpy(), None, ts.numpy(), None)
    np.testing.assert_array_equal(back_q, np.asarray(jq))
    np.testing.assert_array_equal(back_s, np.asarray(js))
    want = np.asarray(jpa.dequant_kv_pool(jq, js, jnp.float32))
    got = tpa.dequant_kv_pool(tq, ts, torch.float32).numpy()
    np.testing.assert_array_equal(tpa.pools_to_jax_layout(got)[0], want)
    rows_q, rows_s = tpa.quantize_kv(_t(pool))
    np.testing.assert_array_equal(
        tpa.dequant_kv(rows_q, rows_s, torch.float32).numpy(),
        np.asarray(jpa.dequant_kv(*jpa.quantize_kv(jnp.asarray(pool)), jnp.float32)))


def test_layout_converters_round_trip():
    rng = np.random.default_rng(8)
    kp = rng.integers(-128, 128, (HKV, 6, 2 * PS, D)).astype(np.int8)
    ksc = rng.random((HKV, 6, 1, 2 * PS)).astype(np.float32)
    tk, tv, tks, tvs = tpa.pools_from_jax_layout(kp, None, ksc, None)
    assert tk.shape == (6, HKV, 2 * PS, D) and tks.shape == (6, HKV, 2 * PS)
    assert tv is None and tvs is None
    np.testing.assert_array_equal(tk[4, 1], kp[1, 4])
    np.testing.assert_array_equal(tks[4, 1], ksc[1, 4, 0])
    back = tpa.pools_to_jax_layout(tk, tv, tks, tvs)
    np.testing.assert_array_equal(back[0], kp)
    np.testing.assert_array_equal(back[2], ksc)


# -- the row write --------------------------------------------------------------------


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_kv_update_rows_matches_jax_whole_pool(fused, quant):
    """One step's rows of every layer, with two inactive slots on the trash
    page (page 0, row 0; their rows are equal, as a step's pad tokens are).
    The whole pool is compared, so rows the write must not touch count too."""
    L, P, B = 2, 6, 5
    rng = np.random.default_rng(9)
    rows = 2 * PS if fused else PS
    shape = (HKV, L * P, rows, D)
    if quant:
        kp = rng.integers(-128, 128, shape).astype(np.int8)
        vp = None if fused else rng.integers(-128, 128, shape).astype(np.int8)
        ksc = rng.random((HKV, L * P, 1, rows)).astype(np.float32)
        vsc = None if fused else rng.random((HKV, L * P, 1, rows)).astype(np.float32)
    else:
        kp = rng.standard_normal(shape).astype(np.float32)
        vp = None if fused else rng.standard_normal(shape).astype(np.float32)
        ksc = vsc = None
    ks = rng.standard_normal((L, B, HKV, D)).astype(np.float32)
    vs = rng.standard_normal((L, B, HKV, D)).astype(np.float32)
    ks[:, 0, :, 3] = np.abs(ks[:, 0]).max() + 1.0  # a positive absmax element
    ks[:, 4], vs[:, 4] = ks[:, 1], vs[:, 1]        # slots 1 and 4 are inactive
    pages = np.array([3, 0, 5, 1, 0], np.int32)
    offsets = np.array([0, 0, PS - 1, 7, 0], np.int32)

    tk, tv, tks, tvs = (_t(a) for a in tpa.pools_from_jax_layout(kp, vp, ksc, vsc))
    if quant:
        want = jpa.paged_kv_update_rows_q(_j(kp), _j(vp), _j(ksc), _j(vsc), _j(ks), _j(vs),
                                          _j(pages), _j(offsets), interpret=True)
        got = tpa.paged_kv_update_rows_q(tk, tv, tks, tvs, _t(ks), _t(vs), _t(pages), _t(offsets))
        assert got[0] is tk and got[2] is tks  # in place
    else:
        want = jpa.paged_kv_update_rows(_j(kp), _j(vp), _j(ks), _j(vs), _j(pages), _j(offsets),
                                        interpret=True) + (None, None)
        got = tpa.paged_kv_update_rows(tk, tv, _t(ks), _t(vs), _t(pages), _t(offsets))
        assert got[0] is tk
    back = tpa.pools_to_jax_layout(*(None if a is None else a.numpy() for a in (tk, tv, tks, tvs)))
    for name, g, w in zip(("k_pages", "v_pages", "k_scales", "v_scales"), back, want):
        assert (g is None) == (w is None), name
        if g is not None:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    if quant:
        assert tk[0 * P + 3, :, 0, 3].tolist() == [127] * HKV  # saturated, not wrapped
