"""K3's split plan and its split-and-merge arithmetic, on the CPU.

(a) `ops/paged_attention.py::split_plan` / `SplitPlan.pages`, the launch
plan the wrapper sizes K3's grid and scratch with (the kernel's
`split_pages` is the same arithmetic): every key a query row attends lands
in exactly one split of exactly the row tile that holds the row, and no
split takes a page at or past `length`, wholly after its tile's last query
row or wholly before the window of its first.

(b) A mirror of what K3 computes, in PyTorch: per (slot, kv head, row tile,
split) and per warp (32 keys of each page), an online softmax in base 2 with
the kernel's rounding points (scores in f32 with the K scale after the dot,
the mask's -0.7 * FLT_MAX, probabilities times the V scale rounded to the
working dtype before P.V), the warps merged in order, then the splits in
split order, partials without a key skipped, the self-term last. Held
against the JAX package's `paged_attention_fa` in interpret mode (as
`tests/test_torch_paged_ops.py` runs it): at `TOL` in f32, and in bf16 at
the chip's gate (per slot, max-abs error <= 1e-2 of the slot's largest
value: the two round P to bf16 against different running maxima).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vis_zephyr_tpu.ops import paged_attention as jpa
from vis_zephyr_tpu_torch.ops import paged_attention as tpa

TOL = dict(rtol=0, atol=2e-5)
BF16_SLOT_TOL = 1e-2
LOG2E = 1.4426950408889634
STAGE_KEYS, WARP_KEYS = 128, 32  # a ring stage's keys and a warp's share of them
HQ, HKV, D, PS, PPS, NPAGES = 8, 2, 64, 64, 4, 32


# -- (a) the split plan --------------------------------------------------------------


def attended(length, qpos, window):
    """The pool positions a query row at `qpos` attends."""
    lo = qpos - window + 1 if window else 0
    return set(range(max(0, lo), min(length, qpos + 1)))


@pytest.mark.parametrize("window", [None, 512], ids=["no-window", "window-512"])
@pytest.mark.parametrize("S", [1, 5, 9])
def test_split_plan_covers_every_attended_key_once(S, window):
    ps, pps, Hkv, G, sms = 128, 16, 8, 4, 132
    rng = np.random.default_rng(S * 1000 + (window or 0))
    lengths = [0, 1, 128, 129, 2048] + rng.integers(1, 2049, 11).tolist()
    fewer = 0  # units with fewer valid pages than splits
    for B in (1, 4, 32):  # one slot takes the most splits, 32 none at decode
        plan = tpa.split_plan(B, Hkv, S * G, pps, sms)
        assert plan.tiles * plan.tile_rows >= S * G > (plan.tiles - 1) * plan.tile_rows
        assert 1 <= plan.splits <= min(pps, tpa.MAX_SPLITS)
        assert plan.splits == 1 or B * Hkv * plan.tiles * plan.splits <= sms * tpa.blocks_per_sm(
            True, plan.tile_rows)
        for length in lengths:
            for q_off in ({length} if S == 1 else set()) | ({length - S} if length >= S else set()):
                for tile in range(plan.tiles):
                    rows = range(tile * plan.tile_rows, min(S * G, (tile + 1) * plan.tile_rows))
                    first_pos, last_pos = q_off + rows[0] // G, q_off + rows[-1] // G
                    taken = []
                    for split in range(plan.splits):
                        a, b = plan.pages(split, tile, length, q_off, S, G, ps, pps, window)
                        assert a <= b
                        for page in range(a, b):
                            assert page * ps < length and page < pps      # below length
                            assert page * ps <= last_pos                 # not after the last row
                            if window:                                   # not before the window
                                assert (page + 1) * ps - 1 > first_pos - window
                        taken += [(split, page) for page in range(a, b)]
                    pages = [page for _, page in taken]
                    assert len(pages) == len(set(pages))                 # no page twice
                    fewer += len(pages) < plan.splits
                    for r in rows:
                        keys = [k for page in pages for k in range(page * ps, (page + 1) * ps)]
                        want = attended(length, q_off + r // G, window)
                        assert want <= set(keys)                         # every key, once
                        assert len([k for k in keys if k in want]) == len(want)
    assert fewer > 0


def test_split_plan_from_shapes_only():
    """The served shapes (132 SMs): 32 slots decode (4 rows a kv head) and
    verify (S = 5: 20 rows) without a split, 128 slots without one, one slot
    in as many splits as its table has pages, S = 9 in two tiles."""
    plan = tpa.split_plan
    assert plan(32, 8, 4, 16, 132) == tpa.SplitPlan(16, 1, 1)
    assert plan(32, 8, 20, 16, 132) == tpa.SplitPlan(32, 1, 1)
    assert plan(128, 8, 4, 16, 132) == tpa.SplitPlan(16, 1, 1)
    assert plan(1, 8, 4, 16, 132) == tpa.SplitPlan(16, 1, 16)
    assert plan(32, 8, 36, 16, 132) == tpa.SplitPlan(32, 2, 1)
    assert plan(1, 8, 4, 64, 132).splits == tpa.MAX_SPLITS
    assert plan(0, 8, 4, 16, 132).splits == 16  # no slot: nothing launches


# -- (b) the split-and-merge arithmetic -----------------------------------------------


def merge(parts):
    """(m, l, o) partials in order: the largest m of those holding a key, the
    others rescaled to it; partials with l = 0 skipped. Rows on axis 0."""
    R = parts[0][0].shape[0]
    M = torch.full((R,), -float("inf"))
    for m, l, _ in parts:
        M = torch.where(l > 0, torch.maximum(M, m), M)
    L, O = torch.zeros(R), torch.zeros_like(parts[0][2])
    for m, l, o in parts:
        f = torch.where(l > 0, torch.exp2(torch.where(l > 0, m - M, 0.0)), 0.0)
        L = L + l * f
        O = O + torch.where(l[:, None] > 0, o * f[:, None], 0.0)
    return M, L, O


def k3_mirror(q, k_pages, v_pages, table, lengths, q_offs, scale, window=None, k_scales=None,
              v_scales=None, k_new=None, v_new=None, sms=4):
    """K3's arithmetic as the kernel orders it (the port's pool layout)."""
    B, S, Hq, Dh = q.shape
    fused = v_pages is None
    quant = k_scales is not None
    Hkv = k_pages.shape[1]
    ps = k_pages.shape[2] // 2 if fused else k_pages.shape[2]
    v_lo = ps if fused else 0
    vp, vs = (k_pages, k_scales) if fused else (v_pages, v_scales)
    G = Hq // Hkv
    work = q.dtype if quant else k_pages.dtype
    plan = tpa.split_plan(B, Hkv, S * G, table.shape[1], sms, quant)
    scale2 = scale * LOG2E
    out = torch.zeros(B, S, Hq, Dh)
    for b in range(B):
        length, q_off = int(lengths[b]), int(q_offs[b])
        for h in range(Hkv):
            for tile in range(plan.tiles):
                rows = list(range(tile * plan.tile_rows, min(S * G, (tile + 1) * plan.tile_rows)))
                qt = torch.stack([q[b, r // G, h * G + r % G] for r in rows]).float()
                qpos = torch.tensor([q_off + r // G for r in rows])
                R = len(rows)
                splits = []
                for split in range(plan.splits):
                    first, end = plan.pages(split, tile, length, q_off, S, G, ps,
                                            table.shape[1], window)
                    warps = [[torch.full((R,), -float("inf")), torch.zeros(R), torch.zeros(R, Dh)]
                             for _ in range(STAGE_KEYS // WARP_KEYS)]
                    for pg in range(first, end):
                        entry = int(table[b, pg])
                        n_tok = min(ps, length - pg * ps)
                        for w, state in enumerate(warps):
                            if w * WARP_KEYS >= n_tok:  # the warp's keys all past length
                                continue
                            keys = torch.arange(w * WARP_KEYS, min((w + 1) * WARP_KEYS, ps))
                            pos = pg * ps + keys
                            ok = (keys[None, :] < n_tok) & (pos[None, :] <= qpos[:, None])
                            if window:
                                ok &= pos[None, :] > (qpos[:, None] - window)
                            k = k_pages[entry, h, keys].float()
                            v = vp[entry, h, v_lo + keys].float()
                            s = (qt @ k.T) * scale2
                            if quant:
                                s = s * (k_scales[entry, h, keys] * (1 / tpa.KV_QUANT_MAX))[None]
                            s = torch.where(ok, s, torch.tensor(tpa.NEG_INF, dtype=torch.float32))
                            m_prev, l_prev, acc = state
                            m_next = torch.maximum(m_prev, s.amax(dim=1))
                            alpha = torch.exp2(m_prev - m_next)
                            p = torch.where(ok, torch.exp2(s - m_next[:, None]), 0.0)
                            pv = p * (vs[entry, h, v_lo + keys] * (1 / tpa.KV_QUANT_MAX))[None] \
                                if quant else p
                            pv = torch.where(ok, pv, 0.0).to(work).float()
                            v = torch.where((keys < n_tok)[:, None], v, 0.0)
                            state[:] = [m_next, alpha * l_prev + p.sum(dim=1),
                                        acc * alpha[:, None] + pv @ v]
                    splits.append(merge([tuple(x) for x in warps]))
                M, L, O = merge(splits)
                if k_new is not None:
                    s_self = (qt @ k_new[b, h].float()) * scale2
                    m_next = torch.maximum(M, s_self)
                    alpha = torch.exp2(M - m_next)
                    p_self = torch.exp2(s_self - m_next)
                    L = alpha * L + p_self
                    O = O * alpha[:, None] + p_self[:, None] * v_new[b, h].float()[None]
                res = O * torch.where(L == 0, 0.0, 1.0 / L)[:, None]
                for i, r in enumerate(rows):
                    out[b, r // G, h * G + r % G] = res[i]
    return out.to(q.dtype)


def make_case(seed, lengths, S, quant, fused, dtype):
    """Inputs in the JAX layout (numpy f32) and in the port's (torch, `dtype`)."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    table = rng.permutation(NPAGES)[: B * PPS].reshape(B, PPS).astype(np.int32)
    q = rng.standard_normal((B, S, HQ, D)).astype(np.float32)
    kp = rng.standard_normal((HKV, NPAGES, PS, D)).astype(np.float32)
    vp = rng.standard_normal((HKV, NPAGES, PS, D)).astype(np.float32)
    if dtype == torch.bfloat16:  # the values both sides see
        q, kp, vp = (torch.from_numpy(a).to(dtype).float().numpy() for a in (q, kp, vp))
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
    if dtype == torch.bfloat16:
        k_new, v_new = (torch.from_numpy(a).to(dtype).float().numpy() for a in (k_new, v_new))
    return q, kp, vp, ksc, vsc, table, np.asarray(lengths, np.int32), k_new, v_new


def both(case, S, selfterm, window, dtype, sms):
    """(the mirror, the JAX kernel in interpret mode), as f32 numpy."""
    q, kp, vp, ksc, vsc, table, lengths, k_new, v_new = case
    q_offs = lengths if selfterm else lengths - S
    new = dict(k_new=k_new, v_new=v_new) if selfterm else {}
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def j(a, cast=True):
        return None if a is None else jnp.asarray(a, jd if cast else None)

    want = jpa.paged_attention_fa(
        j(q), j(kp, ksc is None), j(vp, ksc is None), j(table, False), j(lengths, False),
        j(q_offs, False), sliding_window=window, k_scales=j(ksc, False), v_scales=j(vsc, False),
        interpret=True, slot_block=1, **{k: j(v) for k, v in new.items()})
    tk, tv, tks, tvs = (None if a is None else torch.from_numpy(np.ascontiguousarray(a))
                        for a in tpa.pools_from_jax_layout(kp, vp, ksc, vsc))
    if ksc is None:
        tk = tk.to(dtype)
        tv = None if tv is None else tv.to(dtype)
    tnew = {k: torch.from_numpy(v).to(dtype) for k, v in new.items()}
    got = k3_mirror(torch.from_numpy(q).to(dtype), tk, tv, torch.from_numpy(table),
                    torch.from_numpy(lengths), torch.from_numpy(q_offs), D ** -0.5, window,
                    tks, tvs, sms=sms, **tnew)
    return got.float().numpy(), np.asarray(want, np.float32)


# Lengths: one token, past a page boundary, a slot at the table's end
# (at least S when the rows are in the pool).
CASES = {  # quant, fused, S, self-term, window
    "int8-fused-selfterm-window": (True, True, 1, True, 96),
    "int8-fused-S5-pool-only": (True, True, 5, False, None),
    "float-split-selfterm": (False, False, 1, True, None),
    "float-split-S5-window": (False, False, 5, False, 96),
}
# Four runs of the JAX kernel (about 3 s each): each pool form with and
# without the self-term, a window, S = 5, f32 and bf16.
RUNS = [("int8-fused-selfterm-window", torch.float32), ("float-split-S5-window", torch.float32),
        ("int8-fused-S5-pool-only", torch.bfloat16), ("float-split-selfterm", torch.bfloat16)]


@pytest.mark.parametrize("name,dtype", RUNS,
                         ids=[f"{n}-{'f32' if d == torch.float32 else 'bf16'}" for n, d in RUNS])
def test_split_merge_mirror_matches_jax_kernel(name, dtype):
    quant, fused, S, selfterm, window = CASES[name]
    lengths = [max(n, S) for n in (1, PS + 1, 200, PPS * PS)]
    case = make_case(list(CASES).index(name), lengths, S, quant, fused, dtype)
    # A card of as many SMs as make three splits of these six slots' pages.
    tile_rows = 16 if S * HQ // HKV <= 16 else 32
    sms = -(-3 * len(lengths) * HKV // tpa.blocks_per_sm(quant, tile_rows))
    assert tpa.split_plan(len(lengths), HKV, S * HQ // HKV, PPS, sms, quant).splits == 3
    got, want = both(case, S, selfterm, window, dtype, sms)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, **TOL)
    else:
        err = np.abs(got - want).reshape(len(lengths), -1).max(axis=1)
        top = np.abs(want).reshape(len(lengths), -1).max(axis=1)
        assert (err <= BF16_SLOT_TOL * top).all(), (err, top)


def test_split_merge_mirror_matches_plain_version_and_keyless_rows_are_zero():
    """Many splits (one slot, a split a page), splits without a page, and a
    slot with no key: the mirror against the port's plain version, and the
    keyless slot exactly 0."""
    q, kp, vp, ksc, vsc, table, lengths, _, _ = make_case(7, [0, 70, PPS * PS], 2, True, True,
                                                          torch.float32)
    tk, _, tks, _ = (None if a is None else torch.from_numpy(np.ascontiguousarray(a))
                     for a in tpa.pools_from_jax_layout(kp, None, ksc, None))
    tq, ttable, tlens = torch.from_numpy(q), torch.from_numpy(table), torch.from_numpy(lengths)
    q_offs = (tlens - 2).clamp(min=0)
    for sms in (1, 64):  # no split; then as many as the table has pages
        got = k3_mirror(tq, tk, None, ttable, tlens, q_offs, D ** -0.5, k_scales=tks, sms=sms)
        want = tpa.paged_attention_fa_plain(tq, tk, None, ttable, tlens, q_offs, D ** -0.5,
                                            k_scales=tks)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
        assert not got[0].any()
