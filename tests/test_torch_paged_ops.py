"""The port's paged-KV ops against the JAX package, on the CPU in f32.

Seeded numpy inputs go through the JAX function (its Pallas kernels in
interpret mode) and through the port's plain PyTorch version, the pools
passing through the port's layout converters. Attention outputs agree to
2e-5 absolute (f32 sums in another order); int8 values, scales and written
pools agree bit for bit. The cases are `tests/torch_port_util.py`'s
`ops_case` and `ops_run_both`; the JAX grouped and windowed schedules, the
quantization and the row write are in `test_torch_paged_ops_kv.py`.
"""

import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_port_util import (OPS_D as D, OPS_HQ as HQ, OPS_PPS as PPS, OPS_PS as PS, OPS_TOL as TOL,
                             ops_case as make_case, ops_run_both as run_both, to_jax as _j,
                             to_torch as _t)
from vis_zephyr_tpu.ops import paged_attention as jpa
from vis_zephyr_tpu_torch.ops import paged_attention as tpa


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
