"""The port's single-row paged attention against the JAX package, on the CPU.

- `paged_attention` (one query row a slot, `lengths` tokens in the pool):
  split and fused bf16 pools, with and without the self-term (the int8
  pools' cases, of this test and of the grid's below, are in
  `test_torch_paged_single_int8.py`, the windowed and scaled ones in
  `test_torch_paged_single_window.py`: the JAX kernels' interpret-mode
  compiles make each group tens of seconds). The JAX
  function runs its Pallas kernels in interpret mode: `_make_kernel` for
  split pools with the self-term, `paged_attention_fa` otherwise. f32
  queries, so that both sides round only where the kernels do (a
  probability to the pool's bf16, none for int8): outputs agree to 2e-5
  absolute, as in test_torch_paged_ops.py. `page_offset` shifts the table.
- `paged_attention_fa(fold_heads=False)` (the JAX package's (slot, kv head)
  grid, `_fa_kernel`) at S = 1 and 3 over split pools, and its two refusals
  (a self-term, fused pools) in both packages.

The cases and both calls are `tests/torch_port_util.py`'s `single_case` and
`run_single`; the writefirst step is in `test_torch_paged_single_writefirst.py`.
"""

import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_port_util import (SINGLE_D as D, SINGLE_HQ as HQ, SINGLE_LENGTHS as LENGTHS,
                             SINGLE_NPAGES as NPAGES, SINGLE_PPS as PPS, SINGLE_TOL as TOL,
                             run_single, single_case as make_case, to_jax as _j, to_torch as _t)
from vis_zephyr_tpu.ops import paged_attention as jpa
from vis_zephyr_tpu_torch.ops import paged_attention as tpa


@pytest.mark.parametrize("selfterm", [False, True], ids=["pool-only", "selfterm"])
@pytest.mark.parametrize("pool", ["bf16"])
@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_paged_attention_matches_jax(fused, pool, selfterm):
    case = make_case(0, LENGTHS, pool, fused)
    got, want = run_single(case, case["lengths"], selfterm)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(want).max() > 0.1
    if not selfterm:  # length 0 without a self-term: no key at all → exact zeros
        assert not got[0].any() and not want[0].any()


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
@pytest.mark.parametrize("pool", ["bf16"])
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
