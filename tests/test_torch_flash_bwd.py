"""The port's flash attention backward (K7, K8) against the JAX package, on the CPU.

- `flash_attention_fwd_plain` (K1's contract with its residuals m and l)
  against the JAX `_flash_forward` in interpret mode.
- `flash_attention_bwd_plain` and the two kernels' plain versions
  (`flash_attention_bwd_dkv_plain`, `flash_attention_bwd_dq_plain`) against
  the JAX `_flash_backward` in interpret mode, both fed the same q, k, v,
  o, l, m and dO (numpy, from a seed): causal and non-causal, a padded
  kv_valid that leaves one q row with no valid key, GQA groups of 2 and 4,
  B <= 2, T = S in {128, 256}, D = 128. The JAX dK and dV per q head are
  summed over each group first. Tolerance 2e-4 in f32, as the JAX package's
  own flash gradient tests (`tests/test_flash_attention.py`).
- The arithmetic K7 and K8 run on the tensor cores (a test-local copy of
  the backward that rounds p, then p (dp - di), to bf16 before the dV, dK
  and dQ products, as the kernels do; the plain versions stay f32) against the
  same JAX results, at `chip_smoke.py`'s gates for the kernels: per tensor
  max-abs <= 1e-2 of its largest value and cosine >= 0.9999. The inputs of
  these comparisons are bf16 values (held in f32), as the kernels read them.
- The autograd Function behind `flash_attention` against `jax.grad` of the
  JAX `flash_attention`; `torch.autograd.gradcheck` in f64.
- A row with no valid key gives dQ = 0 and an invalid key dK = dV = 0,
  exactly; the kernel wrappers refuse CPU tensors.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from vis_zephyr_tpu.ops import flash_attention as jflash
from vis_zephyr_tpu_torch.ops import flash_attention as tflash

TOL = dict(atol=2e-4, rtol=2e-4)
D = 128

CASES = [
    # name, B, T, Hq, Hkv, causal, kv_valid case
    ("causal_128", 1, 128, 4, 2, True, "all"),
    ("causal_256", 2, 256, 4, 2, True, "all"),
    ("non_causal_256", 1, 256, 4, 2, False, "all"),
    ("padded_keyless_row", 2, 256, 4, 2, True, "padded"),
    ("gqa_group_4", 1, 128, 4, 1, True, "all"),
]


def _inputs(B, T, Hq, Hkv, valid_case, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, T, Hq, D)).astype(np.float32)
    valid = np.ones((B, T), bool)
    if valid_case == "padded":
        valid[0, 200:] = False
        valid[1, 0] = False    # causal: q row 0 of batch row 1 has no valid key
        valid[1, 131:] = False
    return q, k, v, do, valid


def _jax_forward(q, k, v, valid, causal, scale, block):
    """JAX `_flash_forward` (interpret) in its [B, H, T, D] layout → numpy
    o [B, T, Hq, D] and m, l [B, Hq, T]."""
    o, l, m = jflash._flash_forward(
        jnp.swapaxes(q, 1, 2), jnp.swapaxes(k, 1, 2), jnp.swapaxes(v, 1, 2),
        jnp.asarray(valid, jnp.int32)[:, None, :], causal, scale, block, block, True)
    return np.asarray(jnp.swapaxes(o, 1, 2)), np.asarray(m[:, :, 0]), np.asarray(l[:, :, 0])


def _jax_backward(q, k, v, valid, o, m, l, do, causal, scale, block):
    """JAX `_flash_backward` (interpret) → numpy dq [B,T,Hq,D] and dk, dv
    [B,S,Hkv,D] (the per-q-head results summed over each group, as
    `_flash_bwd` sums them)."""
    Hq, Hkv = q.shape[2], k.shape[2]
    dq, dk_q, dv_q = jflash._flash_backward(
        jnp.swapaxes(q, 1, 2), jnp.swapaxes(k, 1, 2), jnp.swapaxes(v, 1, 2),
        jnp.asarray(valid, jnp.int32)[:, None, :], jnp.swapaxes(o, 1, 2),
        l[:, :, None, :], m[:, :, None, :], jnp.swapaxes(do, 1, 2),
        causal, scale, block, block, True)
    B, _, S, _ = dk_q.shape
    dk = dk_q.reshape(B, Hkv, Hq // Hkv, S, D).sum(axis=2)
    dv = dv_q.reshape(B, Hkv, Hq // Hkv, S, D).sum(axis=2)
    return tuple(np.asarray(jnp.swapaxes(x, 1, 2)) for x in (dq, dk, dv))


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _bf16(x):
    """f32 values rounded to bf16 (held in f32): what the kernels read."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """A case's bf16-rounded inputs (q, k, v, dO, kv_valid), the JAX forward's
    (o, m, l) and the JAX backward's (dq, dk, dv) on them, computed once for
    the tests that share them (never modified: `_t` copies)."""
    _, B, T, Hq, Hkv, causal, valid_case = next(c for c in CASES if c[0] == name)
    q, k, v, do, valid = _inputs(B, T, Hq, Hkv, valid_case)
    q, k, v, do = (_bf16(x) for x in (q, k, v, do))
    scale = D ** -0.5
    o, m, l = _jax_forward(q, k, v, valid, causal, scale, 128)
    want = _jax_backward(q, k, v, valid, o, m, l, do, causal, scale, 128)
    return (q, k, v, do, valid), (o, m, l), want


@pytest.mark.parametrize("name,B,T,Hq,Hkv,causal,valid_case", CASES, ids=[c[0] for c in CASES])
def test_forward_plain_matches_jax_residuals(name, B, T, Hq, Hkv, causal, valid_case):
    (q, k, v, _, valid), (o_j, m_j, l_j), _ = _jax_case(name)
    scale = D ** -0.5
    o, m, l = tflash.flash_attention_fwd_plain(_t(q), _t(k), _t(v), _t(valid), causal, scale)
    np.testing.assert_allclose(o.numpy(), o_j, **TOL)
    np.testing.assert_allclose(l.numpy(), l_j, **TOL)
    np.testing.assert_allclose(m.numpy(), m_j, **TOL)
    if valid_case == "padded":
        assert m[1, :, 0].eq(tflash.NEG_INF).all() and l[1, :, 0].eq(0).all()
        assert o[1, 0].eq(0).all()


@pytest.mark.parametrize("name,B,T,Hq,Hkv,causal,valid_case", CASES, ids=[c[0] for c in CASES])
def test_backward_plain_matches_jax(name, B, T, Hq, Hkv, causal, valid_case):
    (q, k, v, do, valid), (o, m, l), want = _jax_case(name)
    scale = D ** -0.5
    args = [_t(x) for x in (q, k, v, valid)]
    got = tflash.flash_attention_bwd_plain(*args, _t(o), _t(m), _t(l), _t(do), causal, scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    # The kernels' own plain versions, each from the same di.
    di = tflash.row_dot(_t(o), _t(do))
    dk, dv = tflash.flash_attention_bwd_dkv_plain(*args, _t(do), _t(m), _t(l), di, causal, scale)
    dq = tflash.flash_attention_bwd_dq_plain(*args, _t(do), _t(m), _t(l), di, causal, scale)
    for g, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    if valid_case == "padded":
        assert dq[1, 0].eq(0).all()                       # the row with no valid key
        assert dk[0, 200:].eq(0).all() and dv[0, 200:].eq(0).all()   # invalid keys
        assert dk[1, 0].eq(0).all() and dk[1, 131:].eq(0).all() and dv[1, 131:].eq(0).all()


def _tensor_core_backward(q, k, v, valid, o, m, l, do, causal, scale):
    """(dq, dk, dv) as K7 and K8 compute them: f32 scores and probabilities
    from m and l, p rounded to bf16, then p (dp - di) from that p rounded to
    bf16, before the dV, dK and dQ products (f32 sums); scale applied to dK
    and dQ after, outputs rounded to bf16 once."""
    T, Hq = q.shape[1], q.shape[2]
    S, Hkv = k.shape[1], k.shape[2]
    k_g = tflash._grouped(k, Hq // Hkv, torch.float32)
    v_g = tflash._grouped(v, Hq // Hkv, torch.float32)
    mask = tflash._mask(valid, T, S, causal)
    s = torch.einsum("bthd,bshd->bhts", q, k_g) * scale
    l_inv = torch.where(l == 0, torch.zeros_like(l), 1.0 / l)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros(())) * l_inv[..., None]
    dp = torch.einsum("bthd,bshd->bhts", do, v_g)
    p = p.to(torch.bfloat16).float()
    ds = (p * (dp - tflash.row_dot(o, do)[..., None])).to(torch.bfloat16).float()
    dq = torch.einsum("bhts,bshd->bthd", ds, k_g) * scale
    dk = tflash._group_sum(torch.einsum("bhts,bthd->bshd", ds, q), Hkv) * scale
    dv = tflash._group_sum(torch.einsum("bhts,bthd->bshd", p, do), Hkv)
    return tuple(x.to(torch.bfloat16).float() for x in (dq, dk, dv))


@pytest.mark.parametrize("name,B,T,Hq,Hkv,causal,valid_case", CASES, ids=[c[0] for c in CASES])
def test_tensor_core_rounding_fits_the_chip_gates(name, B, T, Hq, Hkv, causal, valid_case):
    """The CPU's evidence that rounding p and ds to bf16 for the tensor cores
    (a departure from the TPU kernels' f32 products) fits the smoke's K7/K8
    gates: against the JAX backward, per tensor max-abs <= 1e-2 of its
    largest value and cosine >= 0.9999; exact zeros stay exact."""
    (q, k, v, do, valid), (o, m, l), want = _jax_case(name)
    got = _tensor_core_backward(*(_t(x) for x in (q, k, v, valid, o, m, l, do)), causal,
                                D ** -0.5)
    for g, w in zip(got, want):
        w = _t(w).double()
        err, top = float((g.double() - w).abs().max()), float(w.abs().max())
        cos = float(torch.nn.functional.cosine_similarity(g.double().flatten(), w.flatten(),
                                                          dim=0))
        assert 0 < err <= 1e-2 * top and cos >= 0.9999, (err, top, cos)
    dq, dk, dv = got
    if valid_case == "padded":
        assert dq[1, 0].eq(0).all()                       # the row with no valid key
        assert dk[0, 200:].eq(0).all() and dv[0, 200:].eq(0).all()   # invalid keys
        assert dk[1, 0].eq(0).all() and dk[1, 131:].eq(0).all() and dv[1, 131:].eq(0).all()


@pytest.mark.parametrize("name,B,T,Hq,Hkv,causal,valid_case", CASES, ids=[c[0] for c in CASES])
def test_autograd_matches_jax_grad(name, B, T, Hq, Hkv, causal, valid_case):
    q, k, v, _, valid = _inputs(B, T, Hq, Hkv, valid_case, seed=1)
    w = np.random.default_rng(2).standard_normal((B, T, Hq, D)).astype(np.float32)

    def jax_loss(q, k, v):
        out = jflash.flash_attention(q, k, v, kv_valid=jnp.asarray(valid), causal=causal,
                                     block_q=128, block_k=128)
        return (out * w).sum()

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = tflash.flash_attention(tq, tk, tv, kv_valid=_t(valid), causal=causal)
    (out * _t(w)).sum().backward()
    for g, x in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), **TOL)


def test_gradcheck_f64():
    """Full f64 `gradcheck` of the autograd Function behind `flash_attention`
    (the public function's T % 128 rule would force 16 times the Jacobian;
    its gradient routing is covered by `test_autograd_matches_jax_grad`).
    One intra-op thread: its thousands of tiny ops only contend for cores
    with the other test processes otherwise."""
    rng = np.random.default_rng(3)
    B, T, Hq, Hkv, d = 1, 32, 2, 1, 4
    q, k, v = (torch.from_numpy(rng.standard_normal((B, T, h, d))).requires_grad_(True)
               for h in (Hq, Hkv, Hkv))
    valid = torch.ones(B, T, dtype=torch.bool)
    valid[0, 25:] = False

    def fn(q, k, v):
        return tflash.FlashAttention.apply(q, k, v, valid, True, d ** -0.5)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert torch.autograd.gradcheck(fn, (q, k, v), eps=1e-6, atol=1e-5, rtol=1e-4)
    finally:
        torch.set_num_threads(threads)


def test_no_grad_forward_is_the_serving_forward():
    """Without a gradient to take, `flash_attention` is exactly what it was
    before the backward pass existed (`flash_attention_plain` on the CPU)."""
    q, k, v, _, valid = _inputs(2, 128, 4, 2, "padded")
    args = [_t(x) for x in (q, k, v, valid)]
    with torch.no_grad():
        got = tflash.flash_attention(*args[:3], kv_valid=args[3], causal=True)
    want = tflash.flash_attention_plain(*args, True, D ** -0.5)
    assert torch.equal(got, want)


@pytest.mark.parametrize("wrapper", ["flash_attention_bwd_dkv", "flash_attention_bwd_dq"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    q = torch.zeros(1, 128, 2, 128, dtype=torch.bfloat16)
    rows = torch.zeros(1, 2, 128)
    valid = torch.ones(1, 128, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(tflash, wrapper)(q, q, q, valid, q, rows, rows, rows, True, 128 ** -0.5)
