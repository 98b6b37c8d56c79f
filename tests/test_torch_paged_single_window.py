"""The port's single-row paged attention against the JAX package with a
window of 16 and a non-default scale (moved from
`test_torch_paged_single.py`): split and fused pools, bf16 and int8, with
and without the self-term; the window cuts keys. The JAX function runs its
Pallas kernels in interpret mode; outputs agree to 2e-5 absolute.
"""

import numpy as np
import pytest

from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_port_util import SINGLE_TOL as TOL, run_single, single_case as make_case


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
