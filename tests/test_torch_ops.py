"""PyTorch port ops against the JAX package, on the CPU.

The same numpy inputs (seeded) go through the JAX function and its port. On
the CPU the port's kernel wrappers take their plain versions; the JAX flash
and cache kernels run in Pallas interpret mode, as their own tests run them.
Tolerances: atol = rtol = 1e-5 in f32 for attention (summation order
differs), bit-exact for the cache row writes (pure copies).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vis_zephyr_tpu.ops import attention as jattn
from vis_zephyr_tpu.ops.flash_attention import flash_attention as jax_flash
from vis_zephyr_tpu.ops.kv_cache import dense_cache_update as jax_cache_update
from vis_zephyr_tpu_torch.ops import attention as tattn
from vis_zephyr_tpu_torch.ops import flash_attention as tflash
from vis_zephyr_tpu_torch.ops import kv_cache as tkv

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(rng, B, T, S, Hq, Hkv, D=128):
    q = rng.standard_normal((B, T, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    return q, k, v


def _kv_valid(case, B, S):
    valid = np.ones((B, S), bool)
    if case == "padded":
        valid[0, 200:] = False
        valid[1, 131:] = False
    if case == "empty_row":
        valid[1, 0] = False  # causal: query row 0 of batch row 1 sees no key
    return valid


@pytest.mark.parametrize("case,causal,Hq,Hkv", [
    ("causal", True, 4, 2),
    ("non_causal", False, 4, 2),
    ("padded", True, 4, 2),
    ("empty_row", True, 4, 2),
    ("gqa", True, 4, 1),
])
def test_flash_attention_matches_jax(case, causal, Hq, Hkv):
    rng = np.random.default_rng(0)
    B, T = 2, 256
    q, k, v = _qkv(rng, B, T, T, Hq, Hkv)
    valid = _kv_valid(case, B, T)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                kv_valid=jnp.asarray(valid), causal=causal))
    got = tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 kv_valid=torch.from_numpy(valid), causal=causal).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if case == "empty_row":
        assert np.all(got[1, 0] == 0.0)


def test_flash_attention_needs_128_multiples():
    q = torch.zeros(1, 100, 2, 128)
    with pytest.raises(ValueError):
        tflash.flash_attention(q, q, q)


def test_flash_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 128, 2, 128, dtype=torch.bfloat16)
    valid = torch.ones(1, 128, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention_fwd(q, q, q, valid, True, 128 ** -0.5)


def test_flash_fwd_forms_are_edits_of_the_committed_kernel():
    """Each form `experiments/flash_fwd_forms.py` builds on the card is a text
    edit of `csrc/flash_fwd.cu` that still applies (the committed form is the
    source itself)."""
    from vis_zephyr_tpu_torch.experiments import flash_fwd_forms

    committed = flash_fwd_forms.form_source([])
    for name, edits in flash_fwd_forms.FORMS.items():
        assert (flash_fwd_forms.form_source(edits) == committed) == (not edits), name


def test_flash_bwd_forms_are_edits_of_the_committed_kernels():
    """Each form `experiments/flash_bwd_forms.py` builds on the card is a text
    edit of `csrc/flash_bwd.cu` that still applies, and its ptxas reading
    tells K7's and K8's registers, spills and serialized wgmmas apart."""
    from vis_zephyr_tpu_torch.experiments import flash_bwd_forms

    committed = flash_bwd_forms.form_source([])
    for name, edits in flash_bwd_forms.FORMS.items():
        assert (flash_bwd_forms.form_source(edits) == committed) == (not edits), name
    log = ("ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions "
           "are serialized due to insufficient register resources for the function "
           "'_ZN_flash_bwd_dkv_kernelE'\n"
           "ptxas info    : Compiling entry function '_ZN_flash_bwd_dq_kernelE' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 168 registers, used 16 barriers\n"
           "ptxas info    : Compiling entry function '_ZN_flash_bwd_dkv_kernelE' for 'sm_90a'\n"
           "    464 bytes stack frame, 920 bytes spill stores, 732 bytes spill loads\n"
           "ptxas info    : Used 168 registers, used 16 barriers\n")
    assert flash_bwd_forms.ptxas_report(log) == {
        "dkv": {"registers": 168, "spill_bytes": 920, "wgmma_serialized": True},
        "dq": {"registers": 168, "spill_bytes": 0, "wgmma_serialized": False}}


@pytest.mark.parametrize("causal,window", [(True, None), (True, 3), (False, None)])
def test_dot_product_attention_matches_jax(causal, window):
    rng = np.random.default_rng(1)
    B, T, S = 2, 7, 9
    q, k, v = _qkv(rng, B, T, S, 4, 2, D=16)
    q_pos = np.tile(np.arange(S - T, S), (B, 1))
    kv_pos = np.tile(np.arange(S), (B, 1))
    kv_valid = np.ones((B, S), bool)
    kv_valid[1, -2:] = False
    jmask = jattn.attention_mask(jnp.asarray(q_pos), jnp.asarray(kv_pos), jnp.asarray(kv_valid),
                                 causal=causal, sliding_window=window)
    tmask = tattn.attention_mask(torch.from_numpy(q_pos), torch.from_numpy(kv_pos),
                                 torch.from_numpy(kv_valid), causal=causal, sliding_window=window)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    want = np.asarray(jattn.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                                  jnp.asarray(v), mask=jmask))
    got = tattn.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), mask=tmask).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name,T,lengths,row_dtype,cache_dtype", [
    ("append", 3, [0, 5, 17], np.float32, "float32"),
    ("clamp_at_S_minus_1", 4, [0, 9, 30], np.float32, "float32"),
    ("cast_to_bf16", 1, [3, 0, 31], np.float32, "bfloat16"),
])
def test_dense_cache_update_matches_jax(name, T, lengths, row_dtype, cache_dtype):
    rng = np.random.default_rng(2)
    L, B, S, Hkv, D = 3, 3, 32, 2, 128
    ck = rng.standard_normal((L, B, S, Hkv, D)).astype(np.float32)
    cv = rng.standard_normal((L, B, S, Hkv, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(row_dtype)
    v = rng.standard_normal((B, T, Hkv, D)).astype(row_dtype)
    lens = np.asarray(lengths, np.int32)
    layer = 1

    jdt = getattr(jnp, cache_dtype)
    want_k, want_v = jax_cache_update(jnp.asarray(ck, jdt), jnp.asarray(cv, jdt), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(lens), layer)
    tdt = getattr(torch, cache_dtype)
    got_k, got_v = torch.from_numpy(ck).to(tdt), torch.from_numpy(cv).to(tdt)
    out = tkv.dense_cache_update(got_k, got_v, torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(lens), layer)
    assert out[0] is got_k and out[1] is got_v  # written in place
    assert got_k.dtype == tdt
    np.testing.assert_array_equal(got_k.float().numpy(), np.asarray(want_k.astype(jnp.float32)))
    np.testing.assert_array_equal(got_v.float().numpy(), np.asarray(want_v.astype(jnp.float32)))
