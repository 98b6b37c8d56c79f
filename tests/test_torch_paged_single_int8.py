"""The port's single-row paged attention against the JAX package on int8
pools (the cases of `test_torch_paged_single.py`'s
`test_paged_attention_matches_jax` and `test_unfolded_grid_matches_jax`
whose pool is int8, moved here; the bf16 ones stay there): split and fused
pools, with and without the self-term; the (slot, kv head) grid at S = 1
and 3. The JAX function runs its Pallas kernels in interpret mode; outputs
agree to 2e-5 absolute.
"""

import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_port_util import (SINGLE_D as D, SINGLE_HQ as HQ, SINGLE_LENGTHS as LENGTHS,
                             SINGLE_TOL as TOL, run_single, single_case as make_case, to_jax as _j,
                             to_torch as _t)
from vis_zephyr_tpu.ops import paged_attention as jpa
from vis_zephyr_tpu_torch.ops import paged_attention as tpa


@pytest.mark.parametrize("selfterm", [False, True], ids=["pool-only", "selfterm"])
@pytest.mark.parametrize("pool", ["int8"])
@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_paged_attention_matches_jax(fused, pool, selfterm):
    case = make_case(0, LENGTHS, pool, fused)
    got, want = run_single(case, case["lengths"], selfterm)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(want).max() > 0.1
    if not selfterm:  # length 0 without a self-term: no key at all → exact zeros
        assert not got[0].any() and not want[0].any()


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("pool", ["int8"])
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
