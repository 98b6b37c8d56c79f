"""The port's speculative-verify ops against the JAX package, on the CPU.

- `paged_kv_update{,_q}` (rows at absolute page ids, the verify step's
  single-layer writes): bf16 and int8 pools, split and fused, L = 1 and 2,
  whole pools and scales bit-equal to the JAX Pallas kernels in interpret
  mode, pools passing through the port's layout converters.
- K3's plain version with S = 3, 5 and 8 query rows per slot and no
  self-term (the verify shape), with and without a window, over f32 split
  and int8 fused pools: held against each package's dense oracle
  `paged_attention_reference` (row j of the S-row call is the single-row
  oracle at length `q_offs + j + 1`), and once a pool form against the JAX
  `paged_attention_fa`; f32 to 2e-5 absolute (f32 sums in another order).
- `_paged_verify_step` on equal pools at `smoke_config` (head_dim 128, f32
  weights), over int8 fused and bf16 split pools: greedy tokens equal to the
  JAX step's; pools and scales as the paged batcher's tests hold them (the two
  frameworks' f32 layers round differently, so a written int8 value may move
  by one and a bf16 value by one ulp, almost never).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_port_util import jax_params_numpy, port_config, port_model
from vis_zephyr_tpu.config import smoke_config
from vis_zephyr_tpu.ops import paged_attention as jpa
from vis_zephyr_tpu.serve import paged as jpaged
from vis_zephyr_tpu_torch.ops import paged_attention as tpa
from vis_zephyr_tpu_torch.serve import paged as tpaged

TOL = dict(rtol=0, atol=2e-5)
HQ, HKV, D, PS, PPS, NPAGES = 8, 2, 64, 16, 4, 32


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
    x = np.asarray(x if x.dtype == jnp.int8 else x.astype(jnp.float32))
    return x


# -- paged_kv_update{,_q} ----------------------------------------------------------------


@pytest.mark.parametrize("L", [1, 2])
@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_paged_kv_update_matches_jax_whole_pool(fused, pool, L):
    """Rows of L layers at absolute page ids; two inactive slots write the
    trash page 0 with equal rows (pad tokens), one row lands on a page's last
    row. Active slots own distinct pages, as in the verify step: the TPU
    kernel rewrites whole page blocks, so two slots writing one page in one
    call would lose a row there. The whole pool is compared, so rows the
    write must not touch count too."""
    quant = pool == "int8"
    B, N = 5, 12
    rng = np.random.default_rng(11 + L)
    rows = 2 * PS if fused else PS
    shape = (HKV, N, rows, D)
    if quant:
        kp = rng.integers(-128, 128, shape).astype(np.int8)
        vp = None if fused else rng.integers(-128, 128, shape).astype(np.int8)
        ksc = rng.random((HKV, N, 1, rows)).astype(np.float32)
        vsc = None if fused else rng.random((HKV, N, 1, rows)).astype(np.float32)
        jk, jv = _j(kp), _j(vp)
    else:
        kp = rng.standard_normal(shape).astype(np.float32)
        vp = None if fused else rng.standard_normal(shape).astype(np.float32)
        ksc = vsc = None
        jk = _j(kp).astype(jnp.bfloat16)
        jv = None if vp is None else _j(vp).astype(jnp.bfloat16)
    ks = rng.standard_normal((L, B, HKV, D)).astype(np.float32)
    vs = rng.standard_normal((L, B, HKV, D)).astype(np.float32)
    ks[:, 0, :, 3] = np.abs(ks[:, 0]).max() + 1.0   # a positive absmax element
    # Slots 1 and 4 are inactive: equal rows, in every layer (absolute ids put
    # both layers' trash rows on one row, which the card writes in any order).
    ks[:, [1, 4]], vs[:, [1, 4]] = ks[:1, 1:2], vs[:1, 1:2]
    page_ids = np.array([[3, 0, 5, 8, 0], [9, 0, 11, 7, 0]], np.int32)[:L]
    offsets = np.array([0, 0, PS - 1, 7, 0], np.int32)

    orig = _np32(jk)  # the JAX call donates its pools
    tk, tv, tks, tvs = (_t(a) for a in tpa.pools_from_jax_layout(orig, _np32(jv), ksc, vsc))
    if not quant:
        tk = tk.to(torch.bfloat16)
        tv = None if tv is None else tv.to(torch.bfloat16)
    before = tpa.update_launches
    if quant:
        want = jpa.paged_kv_update_q(jk, jv, _j(ksc), _j(vsc), _j(ks), _j(vs), _j(page_ids),
                                     _j(offsets), interpret=True)
        got = tpa.paged_kv_update_q(tk, tv, tks, tvs, _t(ks), _t(vs), _t(page_ids),
                                    _t(offsets))
        assert got[0] is tk and got[2] is tks  # in place
    else:
        want = jpa.paged_kv_update(jk, jv, _j(ks), _j(vs), _j(page_ids), _j(offsets),
                                   interpret=True) + (None, None)
        got = tpa.paged_kv_update(tk, tv, _t(ks), _t(vs), _t(page_ids), _t(offsets))
        assert got[0] is tk
    assert tpa.update_launches == before  # a CPU tensor takes the plain version
    back = tpa.pools_to_jax_layout(*(_np32(a) for a in (tk, tv, tks, tvs)))
    for name, g, w in zip(("k_pages", "v_pages", "k_scales", "v_scales"), back, want):
        assert (g is None) == (w is None), name
        if g is not None:
            np.testing.assert_array_equal(g, _np32(w), err_msg=name)
    assert (back[0] != orig).any()  # the write changed the pool
    if quant:
        assert tk[3, :, 0, 3].tolist() == [127] * HKV  # saturated, not wrapped


def test_paged_kv_update_refuses_rows_that_do_not_fit():
    kp = torch.zeros(4, HKV, PS, D)
    rows = torch.zeros(1, 2, HKV + 1, D)
    with pytest.raises(ValueError, match="do not fit"):
        tpa.paged_kv_update(kp, kp.clone(), rows, rows, torch.zeros(1, 2, dtype=torch.int32),
                            torch.zeros(2, dtype=torch.int32))


# -- K3 with S query rows and no self-term -------------------------------------------


def verify_case(seed, lengths, S, quant=False, fused=False):
    """Pools in the JAX layout (numpy) holding `lengths` tokens per slot, the
    last S of which are the query rows' own (the verify shape)."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    table = rng.permutation(np.arange(1, NPAGES))[: B * PPS].reshape(B, PPS).astype(np.int32)
    q = rng.standard_normal((B, S, HQ, D)).astype(np.float32)
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
    lengths = np.asarray(lengths, np.int32)
    return q, kp, vp, ksc, vsc, table, lengths, lengths - S


def port_rows(case, window):
    q, kp, vp, ksc, vsc, table, lengths, q_offs = case
    tk, tv, tks, tvs = tpa.pools_from_jax_layout(kp, vp, ksc, vsc)
    return tpa.paged_attention_fa(_t(q), _t(tk), _t(tv), _t(table), _t(lengths), _t(q_offs),
                                  sliding_window=window, k_scales=_t(tks),
                                  v_scales=_t(tvs)).numpy()


def jax_rows(case, window):
    """The JAX kernel in interpret mode, one slot per program (its grouped
    schedule computes the same and compiles four times as long)."""
    q, kp, vp, ksc, vsc, table, lengths, q_offs = case
    return np.asarray(jpa.paged_attention_fa(
        _j(q), _j(kp), _j(vp), _j(table), _j(lengths), _j(q_offs), sliding_window=window,
        k_scales=_j(ksc), v_scales=_j(vsc), interpret=True, slot_block=1))


# Lengths: the query rows start at 0 (a slot that holds only its own rows), cross
# a page boundary, and fill the table.
VERIFY_LENGTHS = [8, PS + 3, 41, PPS * PS]


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("S", [3, 5, 8])
def test_multi_row_plain_matches_reference_and_jax(S, window):
    case = verify_case(20 + S, VERIFY_LENGTHS, S)
    q, kp, vp, _, _, table, lengths, q_offs = case
    got = port_rows(case, window)
    tk, tv, _, _ = tpa.pools_from_jax_layout(kp, vp)
    for j in range(S):  # row j: the single-row oracle over the first q_offs + j + 1 slots
        row_len = q_offs + j + 1
        port_ref = tpa.paged_attention_reference(_t(q[:, j]), _t(tk), _t(tv), _t(table),
                                                 _t(row_len), sliding_window=window).numpy()
        jax_ref = np.asarray(jpa.paged_attention_reference(
            _j(q[:, j]), _j(kp), _j(vp), _j(table), _j(row_len), sliding_window=window))
        np.testing.assert_allclose(got[:, j], port_ref, **TOL, err_msg=f"row {j}")
        np.testing.assert_allclose(port_ref, jax_ref, **TOL, err_msg=f"row {j}")
    if S == 5 and window:  # the JAX kernel once here (each case compiles for seconds)
        np.testing.assert_allclose(got, jax_rows(case, window), **TOL)


@pytest.mark.parametrize("S", [3, 5, 8])
def test_multi_row_plain_over_int8_fused_pools_matches_reference_and_jax(S):
    """Over int8 fused pools: the oracle runs on the dequantized rows split
    into K and V pools (in f32 the scales fold in exactly where the kernel
    folds them, up to rounding)."""
    case = verify_case(30 + S, VERIFY_LENGTHS, S, quant=True, fused=True)
    q, kp, _, ksc, _, table, lengths, q_offs = case
    got = port_rows(case, None)
    deq = np.asarray(jpa.dequant_kv_pool(jnp.asarray(kp), jnp.asarray(ksc), jnp.float32))
    tk, tv, _, _ = tpa.pools_from_jax_layout(deq[:, :, :PS], deq[:, :, PS:])
    for j in range(S):
        want = tpa.paged_attention_reference(_t(q[:, j]), _t(tk), _t(tv), _t(table),
                                             _t(q_offs + j + 1)).numpy()
        np.testing.assert_allclose(got[:, j], want, **TOL, err_msg=f"row {j}")
    if S == 8:  # the JAX kernel once here
        np.testing.assert_allclose(got, jax_rows(case, None), **TOL)


# -- the verify step -------------------------------------------------------------------

SMOKE = smoke_config(vocab_size=256)
SMOKE_T = port_config(SMOKE)


@pytest.fixture(scope="module")
def smoke_models():
    params = jax_params_numpy(SMOKE, 3)
    return params, port_model(params, SMOKE)


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
            off = g != w
            np.testing.assert_allclose(g, w, rtol=2 ** -7, atol=1e-6, err_msg=f"{where} {name}")
            assert off.mean() < 1e-3, (where, name, off.mean())


@pytest.mark.parametrize("pool", ["int8-fused", "bf16-split"])
def test_paged_verify_step_matches_jax(smoke_models, pool):
    """Three slots (fewer than the JAX kernel's four-slot group, whose
    interpret-mode compile takes four times as long): rows crossing a page
    boundary, a slot two rows short of `cache_len` whose padding rows must
    be forced to the trash page, and an inactive one. The pools hold random
    committed rows below each length."""
    params, port = smoke_models
    quant = fused = pool == "int8-fused"
    dec = SMOKE.decoder
    L, Hkv, hd = dec.num_layers, dec.num_kv_heads, dec.head_dim
    ps, pps, P, S = 16, 4, 10, 5
    rng = np.random.default_rng(5)
    rows = 2 * ps if fused else ps
    shape = (Hkv, L * P, rows, hd)
    if quant:
        kp, ksc = (np.asarray(a) for a in jpa.quantize_kv_pool(
            jnp.asarray(rng.standard_normal(shape).astype(np.float32))))
        vp = vsc = None
        jk, jv = _j(kp), None
    else:
        kp = rng.standard_normal(shape).astype(np.float32)
        vp = rng.standard_normal(shape).astype(np.float32)
        ksc = vsc = None
        jk, jv = _j(kp).astype(jnp.bfloat16), _j(vp).astype(jnp.bfloat16)
    table = np.array([[1, 2, 0, 0], [6, 7, 8, 9], [0, 0, 0, 0]], np.int32)
    lengths = np.array([13, pps * ps - 2, 0], np.int32)
    active = np.array([True, True, False])
    toks = rng.integers(3, dec.vocab_size, (3, S)).astype(np.int32)
    toks[2] = dec.pad_token_id

    orig = _np32(jk)  # the JAX step donates its pools
    greedy_j, *pools_j = jpaged._paged_verify_step(
        params, jk, jv, (_j(ksc), _j(vsc)), _j(table), _j(lengths), _j(toks), _j(active), SMOKE)
    kj, vj, (ksj, vsj) = pools_j
    tk, tv, tks, tvs = (_t(a) for a in tpa.pools_from_jax_layout(
        orig, None if vp is None else vp, ksc, vsc))
    if not quant:
        tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
    t_len = _t(lengths)
    greedy_t, logits = tpaged._paged_verify_step(
        port, tk, tv, (tks, tvs), _t(table), t_len, _t(toks).long(), _t(active), SMOKE_T)
    assert logits.shape == (3, S, dec.vocab_size) and torch.isfinite(logits).all()
    assert torch.equal(t_len, _t(lengths))  # the caller rolls lengths back, not the step
    np.testing.assert_array_equal(greedy_t.numpy()[active], np.asarray(greedy_j)[active])
    got = tpa.pools_to_jax_layout(*(_np32(a) for a in (tk, tv, tks, tvs)))
    want = [_np32(a) for a in (kj, vj, ksj, vsj)]
    # The trash page (page 0 of each layer) takes racing writes of rows nothing reads.
    live = np.ones(L * P, bool)
    live[::P] = False
    assert_pools_close([None if a is None else a[:, live] for a in got],
                       [None if a is None else a[:, live] for a in want], pool)
    # The slot two rows short of cache_len: its three padding rows past it went
    # to the trash page, not (clamped) onto rows 0-2 of its last page.
    for last in (9, 9 + P):  # the slot's last page in layers 0 and 1
        np.testing.assert_array_equal(got[0][:, last, :3], orig[:, last, :3])

