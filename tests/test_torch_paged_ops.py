"""The port's paged-KV ops against the JAX package, on the CPU in f32.

Seeded numpy inputs go through the JAX function (its Pallas kernels in
interpret mode) and through the port's plain PyTorch version, the pools
passing through the port's layout converters. Attention outputs agree to
2e-5 absolute (f32 sums in another order); int8 values, scales and written
pools agree bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from vis_zephyr_tpu.ops import paged_attention as jpa
from vis_zephyr_tpu_torch.ops import paged_attention as tpa

TOL = dict(rtol=0, atol=2e-5)
HQ, HKV, D, PS, PPS, NPAGES = 8, 2, 64, 16, 4, 32


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def make_case(seed, lengths, quant, fused):
    """Pools in the JAX layout (numpy): f32, or int8 with scales."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    table = rng.permutation(NPAGES)[: B * PPS].reshape(B, PPS).astype(np.int32)
    q = rng.standard_normal((B, 1, HQ, D)).astype(np.float32)
    kp = rng.standard_normal((HKV, NPAGES, PS, D)).astype(np.float32)
    vp = rng.standard_normal((HKV, NPAGES, PS, D)).astype(np.float32)
    ksc = vsc = None
    if quant:
        kp, ksc = (np.asarray(a) for a in jpa.quantize_kv_pool(jnp.asarray(kp)))
        vp, vsc = (np.asarray(a) for a in jpa.quantize_kv_pool(jnp.asarray(vp)))
    if fused:
        kp, vp = np.concatenate([kp, vp], axis=2), None
        if quant:
            ksc, vsc = np.concatenate([ksc, vsc], axis=3), None
    k_new = rng.standard_normal((B, HKV, D)).astype(np.float32)
    v_new = rng.standard_normal((B, HKV, D)).astype(np.float32)
    return q, kp, vp, ksc, vsc, table, np.asarray(lengths, np.int32), k_new, v_new


def run_both(case, selfterm, window=None, slot_block=1):
    """(port plain version, JAX kernel in interpret mode). `slot_block=1` is
    the JAX package's one-slot-per-program kernel (`_fa_mh_kernel`), None its
    default grouped one (`_fa_gmh_kernel`), which compiles four times as long."""
    q, kp, vp, ksc, vsc, table, lengths, k_new, v_new = case
    q_offs = lengths if selfterm else lengths - 1
    new = dict(k_new=k_new, v_new=v_new) if selfterm else {}
    want = jpa.paged_attention_fa(
        _j(q), _j(kp), _j(vp), _j(table), _j(lengths), _j(q_offs), sliding_window=window,
        k_scales=_j(ksc), v_scales=_j(vsc), interpret=True, slot_block=slot_block,
        **{k: _j(v) for k, v in new.items()})
    tk, tv, tks, tvs = tpa.pools_from_jax_layout(kp, vp, ksc, vsc)
    got = tpa.paged_attention_fa(
        _t(q), _t(tk), _t(tv), _t(table), _t(lengths), _t(q_offs), sliding_window=window,
        k_scales=_t(tks), v_scales=_t(tvs), **{k: _t(v) for k, v in new.items()})
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("selfterm", [False, True], ids=["pool-only", "selfterm"])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_paged_attention_plain_matches_jax_kernel(fused, quant, selfterm):
    # Lengths: nothing in the pool, one token, a page boundary and past it, full.
    case = make_case(0, [0, 1, PS, PS + 1, 37, PPS * PS], quant, fused)
    got, want = run_both(case, selfterm)
    np.testing.assert_allclose(got, want, **TOL)
    if not selfterm:  # length 0 without a self-term: no key at all → exact zeros
        assert not got[0].any() and not want[0].any()


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


@pytest.mark.parametrize("selfterm", [False, True], ids=["pool-only", "selfterm"])
@pytest.mark.parametrize("window", [None, 24])
def test_paged_attention_plain_matches_reference(selfterm, window):
    """Against the dense oracle of each package (gather, then masked
    attention), f32 split pools; lengths ≥ 1 (the oracle's softmax averages V
    over a row that has no key)."""
    q, kp, vp, _, _, table, lengths, k_new, v_new = make_case(2, [1, PS, 41, 64], False, False)
    q_offs = lengths if selfterm else lengths - 1
    new = (k_new, v_new) if selfterm else (None, None)
    tk, tv, _, _ = tpa.pools_from_jax_layout(kp, vp)
    got = tpa.paged_attention_fa(_t(q), _t(tk), _t(tv), _t(table), _t(lengths), _t(q_offs),
                                 sliding_window=window, k_new=_t(new[0]), v_new=_t(new[1]))
    port_ref = tpa.paged_attention_reference(_t(q[:, 0]), _t(tk), _t(tv), _t(table), _t(lengths),
                                             _t(new[0]), _t(new[1]), sliding_window=window)
    jax_ref = jpa.paged_attention_reference(_j(q[:, 0]), _j(kp), _j(vp), _j(table), _j(lengths),
                                            _j(new[0]), _j(new[1]), sliding_window=window)
    np.testing.assert_allclose(got[:, 0].numpy(), port_ref.numpy(), **TOL)
    np.testing.assert_allclose(port_ref.numpy(), np.asarray(jax_ref), **TOL)


def test_multi_row_queries_match_jax_kernel():
    """S > 1 (the verify shape, rows already in the pool), fused int8."""
    q1, kp, vp, ksc, vsc, table, lengths, _, _ = make_case(3, [9, 30, 64], True, True)
    S = 3
    q = np.random.default_rng(4).standard_normal((3, S, HQ, D)).astype(np.float32)
    q_offs = lengths - S
    want = jpa.paged_attention_fa(_j(q), _j(kp), None, _j(table), _j(lengths), _j(q_offs),
                                  k_scales=_j(ksc), interpret=True, slot_block=1)
    tk, _, tks, _ = tpa.pools_from_jax_layout(kp, None, ksc, None)
    got = tpa.paged_attention_fa(_t(q), _t(tk), None, _t(table), _t(lengths), _t(q_offs),
                                 k_scales=_t(tks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rows_past_length_never_reach_the_output():
    """A recycled page may hold anything past `length`: NaN there changes nothing."""
    q, kp, vp, _, _, table, lengths, k_new, v_new = make_case(5, [5, 20], False, True)
    tk, _, _, _ = tpa.pools_from_jax_layout(kp)
    clean = tpa.paged_attention_fa(_t(q), _t(tk), None, _t(table), _t(lengths), _t(lengths),
                                   k_new=_t(k_new), v_new=_t(v_new))
    dirty = _t(tk).clone()
    for b, n in enumerate(lengths):
        page, row = table[b, n // PS], n % PS
        dirty[page, :, row:PS] = float("nan")            # K rows past length
        dirty[page, :, PS + row:] = float("nan")         # V rows past length
    got = tpa.paged_attention_fa(_t(q), dirty, None, _t(table), _t(lengths), _t(lengths),
                                 k_new=_t(k_new), v_new=_t(v_new))
    np.testing.assert_array_equal(got.numpy(), clean.numpy())


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


def test_plain_versions_is_the_one_switch():
    """A wrapper launches its kernel for any tensor off the CPU, and takes the
    plain version there only inside `plain_versions()`; the switch restores
    itself, nested and after an exception."""
    from vis_zephyr_tpu_torch.ops import _kernels

    cpu, off_cpu = torch.empty(1), torch.empty(1, device="meta")
    assert not _kernels.use_kernel(cpu) and _kernels.use_kernel(off_cpu)
    with _kernels.plain_versions():
        assert not _kernels.use_kernel(off_cpu)
        with _kernels.plain_versions():
            assert not _kernels.use_kernel(off_cpu)
        assert not _kernels.use_kernel(off_cpu)
    assert _kernels.use_kernel(off_cpu)
    with pytest.raises(RuntimeError):
        with _kernels.plain_versions():
            raise RuntimeError("inside")
    assert _kernels.use_kernel(off_cpu)
