"""The port's KV row writers against the JAX package, on the CPU.

- `paged_kv_update_layer{,_q}` (kernel K4's one-launch form: a layer's S
  rows a slot, `[B, S, Hkv, D]` as projected, within-layer page ids and
  offsets `[S, B]`): its plain version against S sequential JAX
  `paged_kv_update{,_q}` calls in interpret mode, the JAX verify step's
  writes, over bf16 and int8, split and fused pools. The rows cover a slot
  whose rows share a page and cross into the next, a slot whose last rows
  are forced onto the trash page (where they meet an inactive slot's pad
  rows), and inactive slots. Every page but the trash page is compared with
  JAX's, scales too. The trash page is held to the kernel's rule (its
  header note): where rows meet on one pool row, the last in (s, b) order
  is written. The TPU kernel rewrites a whole page a grid cell, so where
  two cells of one call write different rows of the trash page, one of
  them can keep a stale row: no output reads that page.
- `dense_cache_update_rope` (kernel K2's one-launch form: K's RoPE applied
  as it appends): its plain version against JAX `apply_rope` then
  `dense_cache_update`, with f32 and bf16 rows, clamped tails included,
  bit for bit (on the CPU XLA rounds each bf16 step as eager PyTorch does;
  the kernel repeats those roundings, and the card checks it bit for bit
  against this plain version).
- The served steps' calls: `_paged_verify_step` issues one row write a
  layer with the whole [B, S] block and no per-row work; the writefirst
  step one a layer; the dense-cache forward one K2 call a layer and rotates
  only q outside it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from vis_zephyr_tpu.models.mistral import apply_rope as jax_apply_rope
from vis_zephyr_tpu.ops import paged_attention as jpa
from vis_zephyr_tpu.ops.kv_cache import dense_cache_update as jax_cache_update
from vis_zephyr_tpu_torch import config as tconfig
from vis_zephyr_tpu_torch.models import mistral as tmistral
from vis_zephyr_tpu_torch.models.vis_zephyr import init_vis_zephyr
from vis_zephyr_tpu_torch.ops import kv_cache as tkv
from vis_zephyr_tpu_torch.ops import paged_attention as tpa
from vis_zephyr_tpu_torch.serve import paged as tpaged

HKV, D, PS, PPS, P, L = 2, 64, 16, 4, 10, 2


def _j(x):
    return None if x is None else jnp.asarray(x)


def _np32(x):
    """A JAX or torch array as numpy: int8 stays, floats widen to f32."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return (x if x.dtype == torch.int8 else x.float()).numpy()
    return np.asarray(x if x.dtype == jnp.int8 else x.astype(jnp.float32))


def verify_targets(table, lengths, active, S):
    """Within-layer page ids and offsets [S, B] of the verify step's rows,
    computed as `_paged_verify_step` computes them: rows past the table are
    forced onto the trash page 0, inactive slots write there at 0..S-1."""
    lengths_eff = np.where(active, lengths, 0)
    pos = lengths_eff[:, None] + np.arange(S)[None, :]
    row_idx = pos // PS
    pages = np.take_along_axis(table, np.minimum(row_idx, PPS - 1), axis=1)
    pages = np.where(active[:, None] & (row_idx < PPS), pages, 0)
    return pages.T.astype(np.int32).copy(), (pos % PS).T.astype(np.int32).copy()


@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_layer_write_matches_sequential_jax_calls(fused, pool):
    """Five slots at S = 4: slot 0 at length 13 (rows 13-15 share its first
    page, row 16 starts its second), slots 1 and 4 inactive (pad rows on page
    0 at rows 0-3), slot 2 two rows short of the table (rows 64 and 65 forced
    onto page 0 at rows 0 and 1, over slot 1's and slot 4's), slot 3 at a
    page's last row. Layer 1's write, page base P."""
    quant = pool == "int8"
    S, B, layer = 4, 5, 1
    rng = np.random.default_rng(41 + fused)
    rows = 2 * PS if fused else PS
    shape = (HKV, L * P, rows, D)
    if quant:
        kp = rng.integers(-128, 128, shape).astype(np.int8)
        vp = None if fused else rng.integers(-128, 128, shape).astype(np.int8)
        ksc = rng.random((HKV, L * P, 1, rows)).astype(np.float32)
        vsc = None if fused else rng.random((HKV, L * P, 1, rows)).astype(np.float32)
        jk, jv = _j(kp), _j(vp)
    else:
        kp = rng.standard_normal(shape).astype(np.float32)
        vp = None if fused else rng.standard_normal(shape).astype(np.float32)
        ksc = vsc = None
        jk = _j(kp).astype(jnp.bfloat16)
        jv = None if vp is None else _j(vp).astype(jnp.bfloat16)
    # The rows as the model projects them, bf16 [B, S, Hkv, D].
    k = torch.from_numpy(rng.standard_normal((B, S, HKV, D)).astype(np.float32)).bfloat16()
    v = torch.from_numpy(rng.standard_normal((B, S, HKV, D)).astype(np.float32)).bfloat16()
    k[0, 2, :, 5] = k[0, 2].abs().amax() + 1.0  # a positive absmax element
    table = np.array([[1, 2, 0, 0], [0, 0, 0, 0], [6, 7, 8, 9], [3, 0, 0, 0], [0, 0, 0, 0]],
                     np.int32)
    lengths = np.array([13, 40, PPS * PS - 2, PS - 1, 7], np.int32)
    active = np.array([True, False, True, True, False])
    pages, offsets = verify_targets(table, lengths, active, S)
    assert (pages[2:, 2] == 0).all() and (offsets[2:, 2] == [0, 1]).all()  # forced rows

    orig = _np32(jk)  # the JAX calls donate their pools
    tk, tv, tks, tvs = (torch.from_numpy(np.ascontiguousarray(a)) if a is not None else None
                        for a in tpa.pools_from_jax_layout(orig, _np32(jv), ksc, vsc))
    if not quant:
        tk = tk.bfloat16()
        tv = None if tv is None else tv.bfloat16()
    want = (jk, jv, _j(ksc), _j(vsc))
    kf, vf = k.float().numpy(), v.float().numpy()
    for s in range(S):  # the JAX verify step: one single-layer call a row
        ids = _j((pages[s] + layer * P)[None])
        if quant:
            want = jpa.paged_kv_update_q(*want, _j(kf[None, :, s]), _j(vf[None, :, s]), ids,
                                         _j(offsets[s]), interpret=True)
        else:
            want = jpa.paged_kv_update(want[0], want[1], _j(kf[None, :, s]),
                                       _j(vf[None, :, s]), ids, _j(offsets[s]),
                                       interpret=True) + (None, None)
    before = tpa.update_launches
    t_pages, t_offsets = torch.from_numpy(pages), torch.from_numpy(offsets)
    if quant:
        got = tpa.paged_kv_update_layer_q(tk, tv, tks, tvs, k, v, t_pages, t_offsets,
                                          layer * P)
        assert got[0] is tk and got[2] is tks  # in place
    else:
        got = tpa.paged_kv_update_layer(tk, tv, k, v, t_pages, t_offsets, layer * P)
        assert got[0] is tk
    assert tpa.update_launches == before  # a CPU tensor takes the plain version
    back = tpa.pools_to_jax_layout(*(_np32(a) for a in (tk, tv, tks, tvs)))
    trash = layer * P
    live = np.arange(L * P) != trash
    for name, g, w in zip(("k_pages", "v_pages", "k_scales", "v_scales"), back, want):
        assert (g is None) == (w is None), name
        if g is not None:
            np.testing.assert_array_equal(g[:, live], _np32(w)[:, live], err_msg=name)
    # The trash page: each row the last writer's in (s, b) order, the rest as before.
    rows_k = k.transpose(0, 1).reshape(S * B, HKV, D)
    rows_v = v.transpose(0, 1).reshape(S * B, HKV, D)
    if quant:
        (rows_k, sc_k), (rows_v, sc_v) = tpa.quantize_kv(rows_k), tpa.quantize_kv(rows_v)
    last = {int(off): i for i, (pg, off) in enumerate(zip(pages.reshape(-1), offsets.reshape(-1)))
            if pg == 0}
    assert len(last) == S  # pad rows at 0..S-1, and forced rows over rows 0 and 1
    v_off = PS if fused else 0
    k_page = back[0][:, trash]
    v_page = k_page if fused else back[1][:, trash]
    for off, i in last.items():
        np.testing.assert_array_equal(k_page[:, off], _np32(rows_k[i]), err_msg=f"K row {off}")
        np.testing.assert_array_equal(v_page[:, v_off + off], _np32(rows_v[i]),
                                      err_msg=f"V row {off}")
        if quant:
            v_sc = back[2] if fused else back[3]
            np.testing.assert_array_equal(back[2][:, trash, 0, off], _np32(sc_k[i, :, 0]))
            np.testing.assert_array_equal(v_sc[:, trash, 0, v_off + off], _np32(sc_v[i, :, 0]))
    np.testing.assert_array_equal(k_page[:, S:PS], orig[:, trash, S:PS])  # untouched rows
    if quant:
        assert tk[layer * P + 1, :, 15, 5].tolist() == [127] * HKV  # saturated, not wrapped


def test_layer_write_takes_strided_rows():
    """The writefirst step passes `k[:, :1]` of a [B, T, Hkv, D] block: the
    same pools as the contiguous rows give."""
    rng = np.random.default_rng(3)
    B = 3
    block = torch.from_numpy(rng.standard_normal((B, 4, HKV, D)).astype(np.float32)).bfloat16()
    pages = torch.tensor([[2, 0, 5]], dtype=torch.int32)
    offsets = torch.tensor([[3, 0, 15]], dtype=torch.int32)
    pools = [torch.zeros(L * P, HKV, 2 * PS, D, dtype=torch.int8) for _ in range(2)]
    scales = [torch.zeros(L * P, HKV, 2 * PS) for _ in range(2)]
    tpa.paged_kv_update_layer_q(pools[0], None, scales[0], None, block[:, :1], block[:, 1:2],
                                pages, offsets, P)
    tpa.paged_kv_update_layer_q(pools[1], None, scales[1], None, block[:, :1].contiguous(),
                                block[:, 1:2].contiguous(), pages, offsets, P)
    assert torch.equal(pools[0], pools[1]) and torch.equal(scales[0], scales[1])
    assert pools[0].any()


@pytest.mark.parametrize("row_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,lengths", [(1, [5, 0, 31]), (4, [0, 9, 30]), (3, [29, 17, 2])],
                         ids=["decode", "clamp", "chunk"])
def test_append_with_rope_matches_jax(T, lengths, row_dtype):
    """k before RoPE, the forward's cos / sin tables at the rows' positions,
    rows and cache in `row_dtype`; lengths 30 and 29 clamp a tail onto the
    last slot (S = 32), whose last t must win."""
    rng = np.random.default_rng(7 + T)
    Lc, B, S, hd = 3, 3, 32, 128
    layer = 2
    dt = getattr(torch, row_dtype)
    ck = torch.from_numpy(rng.standard_normal((Lc, B, S, HKV, hd)).astype(np.float32)).to(dt)
    cv = torch.from_numpy(rng.standard_normal((Lc, B, S, HKV, hd)).astype(np.float32)).to(dt)
    k = torch.from_numpy(rng.standard_normal((B, T, HKV, hd)).astype(np.float32)).to(dt)
    v = torch.from_numpy(rng.standard_normal((B, T, HKV, hd)).astype(np.float32)).to(dt)
    lens = np.asarray(lengths, np.int32)
    positions = torch.from_numpy(lens[:, None] + np.arange(T, dtype=np.int32)[None, :])
    cos, sin = tmistral.rope_cos_sin(positions, hd, 10000.0)

    jdt = getattr(jnp, row_dtype)
    jrows = jax_apply_rope(_j(k.float().numpy()).astype(jdt), _j(cos.numpy()), _j(sin.numpy()))
    want_k, want_v = jax_cache_update(_j(ck.float().numpy()).astype(jdt),
                                      _j(cv.float().numpy()).astype(jdt), jrows,
                                      _j(v.float().numpy()).astype(jdt), _j(lens), layer)
    before = tkv.launches
    out = tkv.dense_cache_update_rope(ck, cv, k, v, cos, sin, torch.from_numpy(lens), layer)
    assert out[0] is ck and out[1] is cv and tkv.launches == before  # in place, plain
    np.testing.assert_array_equal(cv.float().numpy(), _np32(want_v))
    np.testing.assert_array_equal(ck.float().numpy(), _np32(want_k))
    # Exactly the plain arithmetic spelled out: rotate, cast, write.
    ref_k, ref_v = ck.clone(), cv.clone()
    tkv.dense_cache_update_plain(ref_k, ref_v, tkv.apply_rope(k, cos, sin), v,
                                 torch.from_numpy(lens), layer)
    assert torch.equal(ref_k, ck) and torch.equal(ref_v, cv)


# -- the served steps' calls ------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    cfg = tconfig.tiny_config(vocab_size=64)
    return init_vis_zephyr(cfg, torch.Generator().manual_seed(0)), cfg


class _Counter:
    def __init__(self, fn):
        self.fn, self.shapes = fn, []

    def __call__(self, *args, **kw):
        self.shapes.append(tuple(a.shape for a in args if isinstance(a, torch.Tensor)))
        return self.fn(*args, **kw)


def _pools(cfg, quant):
    dec = cfg.decoder
    shape = (dec.num_layers * P, dec.num_kv_heads, 2 * PS, dec.head_dim)
    if quant:
        return torch.zeros(shape, dtype=torch.int8), None, (torch.zeros(shape[:3]), None)
    return torch.zeros(shape), None, (None, None)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_verify_step_writes_a_layer_in_one_call(tiny, monkeypatch, quant):
    model, cfg = tiny
    dec = cfg.decoder
    name = "paged_kv_update_layer_q" if quant else "paged_kv_update_layer"
    writer = _Counter(getattr(tpaged, name))
    monkeypatch.setattr(tpaged, name, writer)
    kp, vp, scales = _pools(cfg, quant)
    S, B = 5, 3
    table = torch.tensor([[1, 2, 0, 0], [3, 4, 5, 6], [0, 0, 0, 0]], dtype=torch.int32)
    lengths = torch.tensor([14, PPS * PS - 2, 0], dtype=torch.int32)
    active = torch.tensor([True, True, False])
    toks = torch.randint(3, dec.vocab_size, (B, S), generator=torch.Generator().manual_seed(1))
    greedy, logits = tpaged._paged_verify_step(model, kp, vp, scales, table, lengths, toks,
                                               active, cfg)
    assert greedy.shape == (B, S) and torch.isfinite(logits).all()
    assert len(writer.shapes) == dec.num_layers  # one call a layer, every row in it
    rows = (B, S, dec.num_kv_heads, dec.head_dim)
    assert all(shapes[-4:] == (rows, rows, (S, B), (S, B)) for shapes in writer.shapes)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_writefirst_step_writes_a_layer_in_one_call(tiny, monkeypatch, quant):
    model, cfg = tiny
    dec = cfg.decoder
    name = "paged_kv_update_layer_q" if quant else "paged_kv_update_layer"
    writer = _Counter(getattr(tpaged, name))
    monkeypatch.setattr(tpaged, name, writer)
    kp, vp, scales = _pools(cfg, quant)
    table = torch.tensor([[1, 2, 0, 0], [3, 0, 0, 0]], dtype=torch.int32)
    lengths = torch.tensor([5, 16], dtype=torch.int32)
    active = torch.tensor([True, True])
    token = torch.tensor([7, 9])
    tpaged._paged_step(model, kp, vp, scales, table, lengths, token, active, None, cfg,
                       tpaged.SamplingConfig(), mode="writefirst")
    assert len(writer.shapes) == dec.num_layers
    rows = (2, 1, dec.num_kv_heads, dec.head_dim)
    assert all(shapes[-4:] == (rows, rows, (1, 2), (1, 2)) for shapes in writer.shapes)


def test_dense_cache_forward_appends_once_a_layer_and_rotates_only_q(tiny, monkeypatch):
    model, cfg = tiny
    dec = cfg.decoder
    append = _Counter(tmistral.dense_cache_update_rope)
    rope = _Counter(tmistral.apply_rope)
    monkeypatch.setattr(tmistral, "dense_cache_update_rope", append)
    monkeypatch.setattr(tmistral, "apply_rope", rope)
    cache = tmistral.init_cache(dec, 2, 16, dtype=torch.float32)
    embeds = torch.randn(2, 3, dec.hidden_size, generator=torch.Generator().manual_seed(2))
    positions = torch.arange(3)[None].expand(2, 3)
    logits, new = tmistral.mistral_forward(model.decoder, embeds, dec, positions, cache=cache)
    assert torch.isfinite(logits).all() and new["length"].tolist() == [3, 3]
    assert len(append.shapes) == dec.num_layers
    assert len(rope.shapes) == dec.num_layers  # q only: k is rotated inside K2
    assert all(shapes[0][2] == dec.num_heads for shapes in rope.shapes)
