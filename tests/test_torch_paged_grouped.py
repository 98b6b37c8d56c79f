"""The port's batched-head and slot-grouped paged attention (kernels K10 and
K11's plain version and wrappers) against the JAX probes
`experiments/batched_paged_attention_probe.py` (`fa_batched`) and
`experiments/paired_slot_attention_probe.py` (`fa_paired`), and
`paged_attention_fa`'s `pages_per_block` / `slot_block` against the JAX
package's, on the CPU.

The JAX probes are loaded from their files and run their Pallas kernels in
interpret mode; the same seeded numpy inputs (KV-fused int8 pools in the JAX
layout, bf16 q, k_new, v_new) reach the port through `from_probe_arrays`.
Cases: `pages_per_block` 1 and 2, P = 2 and 4, a window of 256, mixed
lengths (3 against 505, 130 against 1) with a member of length 0 and NaN in
the scales past every slot's length. K11's plain version with its walk
split in 2, 3 and 4 (each split's probabilities rounded against its own
running maximum, the splits merged in order) is held against the JAX probe
too, and K11's split plan covers every block that holds a key once.

Tolerance: both sides sum in f32 and round the probabilities to bf16 at the
same block boundaries and the output once, but in other orders, so a value
may round the other way: per slot, max-abs error ≤ 1e-2 of the slot's
largest value (a bf16 ulp is at most 0.78 % of a value), and cosine ≥ 0.9999
over all outputs.
"""

import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vis_zephyr_tpu.ops import paged_attention as jpa
from vis_zephyr_tpu_torch.experiments import batched_paged_attention_probe as tbatched
from vis_zephyr_tpu_torch.experiments import paired_slot_attention_probe as tpaired
from vis_zephyr_tpu_torch.ops import paged_attention as tpa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HQ, HKV, D, PS, PPS = 8, 2, 128, 128, 4
MIXED = [3, 505, 130, 1, 0, 257, 512 - 7, 64]


def load_file(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def load_probe(name):
    """A JAX probe module from this checkout's `experiments/` (no package).
    A probe does `from bench import _sync` after putting a fixed absolute
    path first on `sys.path`, so this checkout's `bench.py` is in
    `sys.modules` before the probe runs, and `sys.path` is restored after."""
    saved = list(sys.path)
    try:
        bench = sys.modules.get("bench")
        here = os.path.realpath(os.path.join(REPO, "bench.py"))
        if bench is None or os.path.realpath(getattr(bench, "__file__", "") or "") != here:
            load_file("bench", here)
        return load_file(f"jax_{name}", os.path.join(REPO, "experiments", f"{name}.py"))
    finally:
        sys.path[:] = saved


@pytest.fixture(scope="module")
def jbatched():
    return load_probe("batched_paged_attention_probe")


@pytest.fixture(scope="module")
def jpaired():
    return load_probe("paired_slot_attention_probe")


def probe_arrays(seed, lengths, nan_past_length=False):
    """The probes' inputs in the JAX layout, as JAX arrays: int8 codes
    round(20·N(0, 1)), scales |N(0, 1)| + 0.5 (NaN at and past each slot's
    length when asked), slot b on pages 1 + b·pps …, q_offs = lengths."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    N = 1 + B * PPS
    kq = np.clip(np.rint(rng.standard_normal((HKV, N, 2 * PS, D)) * 20), -127, 127).astype(np.int8)
    ksc = (np.abs(rng.standard_normal((HKV, N, 1, 2 * PS))) + 0.5).astype(np.float32)
    table = (1 + np.arange(B * PPS, dtype=np.int32)).reshape(B, PPS)
    if nan_past_length:
        for b, n in enumerate(lengths):
            for j in range(PPS):
                lo = max(n - j * PS, 0)
                if lo < PS:
                    ksc[:, table[b, j], 0, lo:PS] = np.nan
                    ksc[:, table[b, j], 0, PS + lo:] = np.nan
    lens = np.asarray(lengths, np.int32)
    q = rng.standard_normal((B, 1, HQ, D)).astype(np.float32) * 0.3
    kn = rng.standard_normal((B, HKV, D)).astype(np.float32) * 0.3
    vn = rng.standard_normal((B, HKV, D)).astype(np.float32) * 0.3
    return (jnp.asarray(q, jnp.bfloat16), jnp.asarray(kq), jnp.asarray(table), jnp.asarray(lens),
            jnp.asarray(lens), jnp.asarray(kn, jnp.bfloat16), jnp.asarray(vn, jnp.bfloat16),
            jnp.asarray(ksc))


def assert_close(got, want):
    got = got.float().numpy().astype(np.float64).reshape(got.shape[0], -1)
    want = np.asarray(want.astype(jnp.float32), np.float64).reshape(got.shape[0], -1)
    assert np.isfinite(got).all()
    top = np.abs(want).max(axis=1)
    err = np.abs(got - want).max(axis=1)
    assert (err <= 1e-2 * top).all(), (err, top)
    cos = (got * want).sum() / np.sqrt((got * got).sum() * (want * want).sum())
    assert cos >= 0.9999, cos


@pytest.mark.parametrize("ppcb,window,lengths,nan", [
    (1, None, [0, 3, 130, 512 - 7], True),
    (2, 256, [3, 130, 257, 512 - 7], False),
])
def test_fa_batched_matches_the_jax_probe(jbatched, ppcb, window, lengths, nan):
    args = probe_arrays(ppcb, lengths, nan_past_length=nan)
    want = jbatched.fa_batched(*args, pages_per_block=ppcb, window=window, interpret=True)
    ported = tbatched.from_probe_arrays(*args)
    before = tpa.batched_launches
    got = tbatched.fa_batched(*ported, pages_per_block=ppcb, window=window)
    assert tpa.batched_launches == before  # a CPU tensor takes the plain version
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (len(lengths), 1, HQ, D)
    assert_close(got, want)
    if lengths[0] == 0:  # no key in the pool: the self-term's v_new alone
        np.testing.assert_allclose(got[0, 0].float().numpy().reshape(HKV, -1, D),
                                   ported[6].float().numpy()[0][:, None].repeat(HQ // HKV, 1),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("pair,window", [(2, None), (4, 256)])
def test_fa_paired_matches_the_jax_probe(jpaired, pair, window):
    args = probe_arrays(10 + pair, MIXED, nan_past_length=True)
    want = jpaired.fa_paired(*args, pages_per_block=2, window=window, pair=pair, interpret=True)
    ported = tpaired.from_probe_arrays(*args)
    before = tpa.paired_launches
    got = tpaired.fa_paired(*ported, pages_per_block=2, window=window, pair=pair)
    assert tpa.paired_launches == before
    assert_close(got, want)
    # P does not change a slot's arithmetic: the batched form gives the same bits.
    assert torch.equal(got, tbatched.fa_batched(*ported, pages_per_block=2, window=window))


@pytest.fixture(scope="module")
def paired_one_page(jpaired):
    """The JAX probe at P = 2, one page a block, with its inputs ported."""
    args = probe_arrays(31, MIXED, nan_past_length=True)
    want = jpaired.fa_paired(*args, pages_per_block=1, pair=2, interpret=True)
    return tpaired.from_probe_arrays(*args), want


@pytest.mark.parametrize("splits", [2, 3, 4])
def test_k11_split_walk_plain_version_matches_the_jax_probe(paired_one_page, splits):
    ported, want = paired_one_page
    got = tpa.paged_attention_grouped_plain(*ported, 1, splits=splits)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (len(MIXED), 1, HQ, D)
    assert_close(got, want)
    # The slot of length 0 is its v_new alone, split or not.
    np.testing.assert_allclose(got[4, 0].float().numpy().reshape(HKV, -1, D),
                               ported[6].float().numpy()[4][:, None].repeat(HQ // HKV, 1),
                               rtol=0, atol=0)


@pytest.mark.parametrize("window", [None, 300])
def test_k11_split_plan_covers_every_block_with_a_key_once(window):
    """`paired_split_blocks` (the kernel's `split_blocks`) over the splits of
    `paired_plan` takes each block of `bk` tokens that holds a key of
    [lo, hi) exactly once, in order, and no other; the plan splits only
    where the units leave the card's block slots idle."""
    rng = np.random.default_rng(32)
    ps, pps = 128, 16
    for ppcb in (1, 3, 6):
        bk = ppcb * ps
        for B, Hkv in ((1, 8), (8, 8), (32, 8), (128, 8)):
            splits = tpa.paired_plan(B, Hkv, ps, pps, ppcb, 132)
            assert 1 <= splits <= min(-(-pps // ppcb), tpa.MAX_SPLITS)
            if B * Hkv >= 132 * 3:
                assert splits == 1
            for length in rng.integers(0, pps * ps + 1, 6).tolist() + [0, 1, bk, bk + 1]:
                lo = max(length - window + 1, 0) if window else 0
                hi = min(length, pps * ps)  # q_off = length: the pool's keys
                want = list(range(lo // bk, -(-hi // bk))) if hi > lo else []
                got = []
                for sp in range(splits):
                    first, end = tpa.paired_split_blocks(lo, hi, bk, splits, sp)
                    got += list(range(first, end))
                assert got == want, (ppcb, B, length, splits)


def test_fa_paired_refuses_a_batch_that_is_not_whole_groups():
    ported = tpaired.from_probe_arrays(*probe_arrays(3, MIXED[:6]))
    with pytest.raises(ValueError, match="multiple of pair"):
        tpaired.fa_paired(*ported, pair=4)


def test_paged_attention_fa_slot_block_matches_the_jax_package():
    # B = 5 is not a multiple of slot_block = 2: both pad with an empty slot.
    q, kq, table, lens, q_offs, kn, vn, ksc = probe_arrays(21, [505, 0, 130, 1, 257])
    want = jpa.paged_attention_fa(q, kq, None, table, lens, q_offs, k_scales=ksc, k_new=kn,
                                  v_new=vn, pages_per_block=2, slot_block=2, interpret=True)
    tq, tkp, ttable, tlens, tq_offs, tkn, tvn, tksc = tbatched.from_probe_arrays(
        q, kq, table, lens, q_offs, kn, vn, ksc)
    got = tpa.paged_attention_fa(tq, tkp, None, ttable, tlens, tq_offs, k_scales=tksc,
                                 k_new=tkn, v_new=tvn, pages_per_block=2, slot_block=2)
    assert tuple(got.shape) == (5, 1, HQ, D)
    assert_close(got, want)
    # The K11 route: the grouped plain version at bk = 2 pages over the batch
    # padded with an empty slot (length 0, table row 0), not K3's.
    def pad(t):
        return torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])

    want_port = tpa.paged_attention_grouped_plain(pad(tq), tkp, pad(ttable), pad(tlens),
                                                  pad(tq_offs), pad(tkn), pad(tvn), tksc, 2)
    assert torch.equal(got, want_port[:5])


def test_slot_block_refused_without_the_folded_grid_in_both_packages():
    q, kq, table, lens, q_offs, kn, vn, ksc = probe_arrays(22, [3, 130])
    split = jnp.asarray(np.asarray(kq)[:, :, :PS]), jnp.asarray(np.asarray(kq)[:, :, PS:])
    message = "slot_block requires the folded grid"
    with pytest.raises(ValueError) as refused:
        jpa.paged_attention_fa(q, split[0], split[1], table, lens, q_offs - 1, slot_block=2,
                               fold_heads=False, k_scales=ksc[..., :PS], v_scales=ksc[..., PS:],
                               interpret=True)
    assert str(refused.value).splitlines()[0] == message  # JAX appends a traceback note
    tq, tk, ttable, tlens, tq_offs, _, _, tksc = tbatched.from_probe_arrays(
        q, kq, table, lens, q_offs, kn, vn, ksc)
    with pytest.raises(ValueError, match=f"^{message}$"):
        tpa.paged_attention_fa(tq, tk[:, :, :PS].contiguous(), tk[:, :, PS:].contiguous(), ttable,
                               tlens, tq_offs - 1, slot_block=2, fold_heads=False,
                               k_scales=tksc[..., :PS].contiguous(),
                               v_scales=tksc[..., PS:].contiguous())


def test_tilings_route_to_k3_outside_the_probes_configuration_and_by_default():
    args = probe_arrays(23, [3, 505, 130, 1])
    tq, tkp, ttable, tlens, tq_offs, tkn, tvn, tksc = tbatched.from_probe_arrays(*args)
    fused = dict(k_scales=tksc, k_new=tkn, v_new=tvn)
    # No tiling: K3, as every served step calls it.
    k3 = tpa.paged_attention_fa_plain(tq, tkp, None, ttable, tlens, tq_offs, D ** -0.5, **fused)
    assert torch.equal(tpa.paged_attention_fa(tq, tkp, None, ttable, tlens, tq_offs, **fused), k3)
    # pages_per_block alone on the probes' configuration: K10's arithmetic.
    assert torch.equal(
        tpa.paged_attention_fa(tq, tkp, None, ttable, tlens, tq_offs, pages_per_block=1, **fused),
        tpa.paged_attention_grouped_plain(tq, tkp, ttable, tlens, tq_offs, tkn, tvn, tksc, 1))
    # Split bf16 pools with the self-term: K3 whatever the tilings.
    kb = tkp.float().to(torch.bfloat16)
    split = (kb[:, :, :PS].contiguous(), kb[:, :, PS:].contiguous())
    k3_split = tpa.paged_attention_fa_plain(tq, *split, ttable, tlens, tq_offs, D ** -0.5,
                                            k_new=tkn, v_new=tvn)
    got = tpa.paged_attention_fa(tq, *split, ttable, tlens, tq_offs, k_new=tkn, v_new=tvn,
                                 pages_per_block=2, slot_block=2)
    assert torch.equal(got, k3_split)


def test_grouped_plain_version_agrees_with_k3_and_steps_by_blocks():
    """A block of the whole table and a block of one page give K3's function:
    the block only moves the bf16 rounding of the probabilities."""
    args = probe_arrays(24, [3, 505, 130, 1])
    tq, tkp, ttable, tlens, tq_offs, tkn, tvn, tksc = tbatched.from_probe_arrays(*args)
    k3 = tpa.paged_attention_fa_plain(tq, tkp, None, ttable, tlens, tq_offs, D ** -0.5,
                                      k_scales=tksc, k_new=tkn, v_new=tvn)
    for ppcb in (1, PPS, 3 * PPS):
        got = tpa.paged_attention_grouped_plain(tq, tkp, ttable, tlens, tq_offs, tkn, tvn, tksc,
                                                ppcb)
        assert_close(got, jnp.asarray(k3.float().numpy()))
    # pages_per_block past the table clamps to one block of the whole table.
    assert torch.equal(
        tpa.paged_attention_grouped_plain(tq, tkp, ttable, tlens, tq_offs, tkn, tvn, tksc, PPS),
        tpa.paged_attention_grouped_plain(tq, tkp, ttable, tlens, tq_offs, tkn, tvn, tksc, 99))


def test_tilings_route_to_k3_where_k10_and_k11_do_not_fit():
    """8 query heads a kv head, or a block of tokens whose scores overflow a
    block's shared memory: the tilings run K3 (its plain version here, bit
    for bit), as the JAX package accepts these calls."""
    rng = np.random.default_rng(25)
    B, Hkv, N = 3, 2, 1 + 3 * PPS
    kp = torch.from_numpy(np.clip(np.rint(rng.standard_normal((N, Hkv, 2 * PS, D)) * 20),
                                  -127, 127).astype(np.int8))
    ksc = torch.from_numpy((np.abs(rng.standard_normal((N, Hkv, 2 * PS))) + 0.5).astype(np.float32))
    lens = torch.tensor([3, 300, 0], dtype=torch.int32)
    table = (1 + torch.arange(B * PPS, dtype=torch.int32)).reshape(B, PPS)
    kn, vn = (torch.from_numpy(rng.standard_normal((B, Hkv, D)).astype(np.float32) * 0.3)
              .to(torch.bfloat16) for _ in range(2))

    def both(q, table, **tiling):
        fused = dict(k_scales=ksc, k_new=kn, v_new=vn)
        before = (tpa.attn_launches, tpa.batched_launches, tpa.paired_launches)
        got = tpa.paged_attention_fa(q, kp, None, table, lens, lens, **fused, **tiling)
        assert (tpa.attn_launches, tpa.batched_launches, tpa.paired_launches) == before
        return got, tpa.paged_attention_fa_plain(q, kp, None, table, lens, lens, D ** -0.5, **fused)

    q16 = torch.from_numpy(rng.standard_normal((B, 1, 16, D)).astype(np.float32) * 0.3)
    q16 = q16.to(torch.bfloat16)
    assert not tpa.grouped_fits(16, Hkv, D, D, PS, PPS, 2)
    for tiling in (dict(pages_per_block=2), dict(slot_block=2, pages_per_block=2)):
        got, k3 = both(q16, table, **tiling)
        assert torch.equal(got, k3), tiling
    # A table of 96 pages in one block: 12288 tokens of scores a warp, over 227 KB.
    wide = torch.cat([table, torch.zeros((B, 96 - PPS), dtype=torch.int32)], dim=1)
    q8 = q16[:, :, :8].contiguous()
    assert tpa.grouped_fits(8, Hkv, D, D, PS, 96, 90)
    assert not tpa.grouped_fits(8, Hkv, D, D, PS, 96, 96)
    got, k3 = both(q8, wide, pages_per_block=96)
    assert torch.equal(got, k3)
