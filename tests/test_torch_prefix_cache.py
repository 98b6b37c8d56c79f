"""The port's prefix cache (`serve/paged.py`: `PageAllocator`'s holder counts,
`PrefixCache`, `_gather_prefix`, `_warm_scratch` and the paged batcher's warm
admission) against the JAX package's, on the CPU at `tiny_config`.

- the allocator's holder counts and the cache's lookups, inserts, evictions
  and `drop_all` give the JAX classes' pages, hits and reused pages on one
  scripted run; a page released with no holder raises;
- `_gather_prefix` equals the JAX function through the layout converters
  for split and fused pools, f32 and int8, bit for bit (both dequantize in
  f32 as the int8 value times scale · (1 / 127.5), the product XLA makes of
  the JAX function's division);
- the warm batcher gives the JAX warm batcher's greedy tokens on the same
  f32 weights, with pools, table and lengths after every scheduler step
  within `assert_same_state`'s tolerances;
- inside the port: warm equals cold and `generate`, at a page-aligned
  prompt, with sharing stopped at the image sentinel, for a multi-turn
  continuation, and composed with fused pools, int8 pools (deterministic:
  the suffix attends the int8-rounded prefix), lookahead, multi-step and a
  draft model; no page leaks after churn, a cancelled warm prefill and
  `drop_all`.
"""

import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_port_util import (assert_same_state, drive, jax_params_numpy, jax_snapshot,
                             port_config, port_model, port_snapshot)
from vis_zephyr_tpu.config import tiny_config
from vis_zephyr_tpu.constants import IMAGE_TOKEN_INDEX
from vis_zephyr_tpu.serve import generate as jgen
from vis_zephyr_tpu.serve import paged as jpaged
from vis_zephyr_tpu_torch.ops import paged_attention as tpa
from vis_zephyr_tpu_torch.serve import draft as tdraft
from vis_zephyr_tpu_torch.serve import generate as tgen
from vis_zephyr_tpu_torch.serve import paged as tpaged

CFG = tiny_config(vocab_size=256)
TCFG = port_config(CFG)
V = CFG.decoder.vocab_size
# The JAX package's prefix-cache tests' geometry: pages of 16, chunks of 16.
GEOMETRY = dict(max_slots=3, cache_len=96, page_size=16, num_pages=48, prefill_chunk=16)


@pytest.fixture(scope="module")
def models():
    params = jax_params_numpy(CFG, 2)
    return params, port_model(params, CFG)


def greedy(max_new: int):
    return tgen.SamplingConfig(max_new_tokens=max_new, eos_token_id=-1)


def batcher(port, max_new: int = 6, **kw):
    return tpaged.PagedBatcher(port, TCFG, sampling=greedy(max_new), **dict(GEOMETRY, **kw))


def drain(b, requests):
    """Submit (ids, images, patch_valid) requests at once and run to the end."""
    handles = [b.submit(ids, im, pv) for ids, im, pv in requests]
    b.run_until_drained()
    return [list(b.stream(h)) for h in handles]


def solo(port, ids, max_new: int, images=None, valid=None):
    out = tgen.generate(port, torch.from_numpy(ids)[None],
                        None if images is None else torch.from_numpy(images)[None],
                        None if valid is None else torch.from_numpy(valid)[None],
                        TCFG, greedy(max_new))[0]
    return [int(t) for t in out]


def shared_prefix(rng, n_prefix: int, suffixes):
    prefix = rng.integers(5, V, (n_prefix,))
    return [(np.concatenate([prefix, rng.integers(5, V, (t,))]), None, None) for t in suffixes]


# -- host classes ------------------------------------------------------------------------


def test_allocator_holder_counts_match_jax():
    a, j = tpaged.PageAllocator(8), jpaged.PageAllocator(8)
    for alloc in (a, j):
        pages = alloc.alloc(3)
        alloc.retain(pages[:2])         # a second holder on two pages
        alloc.release(pages)            # the first holder goes: one page back
        assert alloc.available == 8 - 1 - 2
        alloc.release(pages[:2])
        assert alloc.available == 7     # all back (page 0 reserved)
    assert a._free == j._free and a._refs == j._refs == {}
    held = a.alloc(2)
    a.release(held)
    with pytest.raises(KeyError):
        a.release(held[:1])             # released twice: it has no holder
    with pytest.raises(KeyError):
        a.retain([held[0]])             # a free page takes no holder


def test_prefix_cache_scripted_run_matches_jax():
    """One script of lookups, inserts (with a duplicate chain), evictions and
    `drop_all` on both packages' classes: the same pages, counters and free
    lists after every operation."""
    caches = []
    for mod in (tpaged, jpaged):
        alloc = mod.PageAllocator(24)
        caches.append((alloc, mod.PrefixCache(alloc, page_size=4)))
    rng = np.random.default_rng(0)
    prompts = [np.arange(100, 120), np.concatenate([np.arange(100, 108), [999] * 12]),
               np.arange(300, 316), rng.integers(5, 50, 20)]
    log = [[], []]
    for side, (alloc, cache) in enumerate(caches):
        out = log[side]
        held = []
        for ids in prompts:
            pages = alloc.alloc(len(ids) // 4)
            cache.insert(ids, pages, len(pages))
            held.append(pages)
        dup = alloc.alloc(4)
        cache.insert(prompts[0], dup, 4)  # chunks already cached: no new holder
        alloc.release(dup)
        for pages in held:
            alloc.release(pages)            # the owners go; the cache keeps them
        out.append(("inserted", alloc.available, list(alloc._free)))
        hits = [cache.lookup(ids, max_pages=5) for ids in prompts + [np.full(20, 7)]]
        out.append(("hits", hits, cache.hits, cache.pages_reused))
        for pages in hits:
            alloc.release(pages)
        out.append(("evicted", cache.evict(3), alloc.available, list(alloc._free)))
        out.append(("after", cache.lookup(prompts[0], max_pages=5), cache.hits,
                    cache.pages_reused))
        alloc.release(out[-1][1])
        out.append(("evicted", cache.evict(100), alloc.available))
        cache.drop_all()
        out.append(("dropped", alloc.available, dict(alloc._refs)))
    assert log[0] == log[1]
    assert log[0][1][2] == 4 and log[0][-1] == ("dropped", 23, {})


# -- device helpers ------------------------------------------------------------------------


@pytest.mark.parametrize("quant,fused", [(False, False), (False, True), (True, False),
                                         (True, True)],
                         ids=["f32-split", "f32-fused", "int8-split", "int8-fused"])
def test_gather_prefix_matches_jax(quant, fused):
    """Pools made in the JAX layout, gathered by both packages' functions."""
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    L, P, Hkv, ps, D = 2, 6, 2, 4, 8
    rows = 2 * ps if fused else ps
    shape = (Hkv, L * P, rows, D)
    if quant:
        pools = [rng.integers(-128, 128, shape).astype(np.int8) for _ in range(1 if fused else 2)]
        scales = [rng.uniform(0.1, 3.0, (Hkv, L * P, 1, rows)).astype(np.float32)
                  for _ in range(1 if fused else 2)]
    else:
        pools = [rng.standard_normal(shape).astype(np.float32) for _ in range(1 if fused else 2)]
        scales = []
    kp, vp = pools[0], (pools[1] if not fused else None)
    ksp = scales[0] if quant else None
    vsp = scales[1] if quant and not fused else None
    pages = np.array([3, 1, 5], np.int32)
    want = jpaged._gather_prefix(*(None if x is None else jnp.asarray(x)
                                   for x in (kp, vp, ksp, vsp)),
                                 jnp.asarray(pages), num_layers=L)
    port = [None if x is None else torch.from_numpy(x)
            for x in tpa.pools_from_jax_layout(kp, vp, ksp, vsp)]
    got = tpaged._gather_prefix(*port, torch.from_numpy(pages.astype(np.int64)), num_layers=L)
    for g, w in zip(got, want):
        assert g.shape == (L, 3 * ps, Hkv, D)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_warm_scratch_writes_the_prefix_rows_in_place():
    from vis_zephyr_tpu_torch.models.mistral import init_cache

    cache = init_cache(TCFG.decoder, 1, 48, dtype=torch.float32)
    k0 = cache["k"]
    pk = torch.randn(TCFG.decoder.num_layers, 32, TCFG.decoder.num_kv_heads,
                     TCFG.decoder.head_dim)
    pv = torch.randn_like(pk)
    tpaged._warm_scratch(cache, pk, pv)
    assert cache["k"] is k0 and int(cache["length"][0]) == 32
    assert torch.equal(cache["k"][:, 0, :32], pk) and torch.equal(cache["v"][:, 0, :32], pv)
    assert not cache["k"][:, 0, 32:].any()


# -- the warm batcher against the JAX package's ---------------------------------------------


def warm_scenario():
    """Three prompts on one 40-token prefix (two pages of 16 shareable, the
    chunk 16); the later two arrive once the first is installed."""
    rng = np.random.default_rng(3)
    prefix = rng.integers(5, V, (40,))
    return [(np.concatenate([prefix, rng.integers(5, V, (t,))]), None, None, None, at)
            for t, at in ((3, 0), (7, 6), (5, 6))]


def test_warm_batcher_matches_jax_warm_batcher(models):
    params, port = models
    kw = dict(GEOMETRY, kv_fused=True, prefix_cache=True)
    jb = jpaged.PagedBatcher(params, CFG, sampling=jgen.SamplingConfig(
        max_new_tokens=6, eos_token_id=-1), **kw)
    tb = batcher(port, kv_fused=True, prefix_cache=True)
    want, _, want_after = drive(jb, warm_scenario(), jax_snapshot)
    got, _, got_after = drive(tb, warm_scenario(), port_snapshot)
    assert got == want and all(len(r) == 6 for r in got)
    assert len(got_after) == len(want_after)
    for i, (g, w) in enumerate(zip(got_after, want_after)):
        assert_same_state(g, w, f"after step {i}")
    assert (tb.prefix_cache.hits, tb.prefix_cache.pages_reused) == (
        jb.prefix_cache.hits, jb.prefix_cache.pages_reused) == (2, 4)
    assert tb.allocator.available == jb.allocator.available
    assert tb.allocator._free == jb.allocator._free


# -- inside the port -------------------------------------------------------------------------


def test_warm_equals_cold_and_solo(models):
    port = models[1]
    requests = shared_prefix(np.random.default_rng(4), 40, (3, 7, 5))
    warm = batcher(port, prefix_cache=True)
    got = drain(warm, requests)
    assert warm.prefix_cache.hits >= 2 and warm.prefix_cache.pages_reused >= 4
    assert got == drain(batcher(port), requests)
    assert got == [solo(port, ids, 6) for ids, _, _ in requests]


def test_exact_page_aligned_prompt(models):
    """A prompt that is the cached prefix and nothing more: one token stays
    unshared, and the reply is the solo run's."""
    port = models[1]
    prefix = np.random.default_rng(5).integers(5, V, (32,))
    warm = batcher(port, max_new=5, prefix_cache=True)
    got = drain(warm, [(prefix.copy(), None, None), (prefix.copy(), None, None)])
    assert warm.prefix_cache.hits >= 1 and warm.prefix_cache.pages_reused == 1
    assert got[0] == got[1] == solo(port, prefix, 5)


def test_sharing_stops_at_the_image_sentinel(models):
    """Two prompts share 33 text tokens before <image> and show other images:
    at most the two pages before the sentinel are shared."""
    port = models[1]
    rng = np.random.default_rng(6)
    side = CFG.vision.image_size
    text = rng.integers(5, V, (33,))
    requests = []
    for _ in range(2):
        ids = np.concatenate([text, [IMAGE_TOKEN_INDEX], rng.integers(5, V, (4,))])
        images = rng.standard_normal((3, side, side, 3)).astype(np.float32)
        requests.append((ids, images, np.ones((3,), bool)))
    warm = batcher(port, max_new=5, prefix_cache=True)
    got = drain(warm, requests)
    assert warm.prefix_cache.hits >= 1 and warm.prefix_cache.pages_reused <= 2
    assert got == [solo(port, ids, 5, im, pv) for ids, im, pv in requests]


def test_multiturn_continuation_hits(models):
    port = models[1]
    rng = np.random.default_rng(7)
    turn1 = rng.integers(5, V, (35,))
    warm = batcher(port, max_new=4, prefix_cache=True)
    (reply,) = drain(warm, [(turn1, None, None)])
    turn2 = np.concatenate([turn1, reply, rng.integers(5, V, (6,))])
    (got,) = drain(warm, [(turn2, None, None)])
    assert warm.prefix_cache.hits == 1 and warm.prefix_cache.pages_reused == 2
    assert got == solo(port, turn2, 4)


@pytest.mark.parametrize("kw", [dict(kv_fused=True), dict(kv_quant=True, kv_fused=True),
                                dict(lookahead=3), dict(multi_step=3), dict(lookahead=3,
                                                                            draft=True)],
                         ids=["fused", "int8-fused", "lookahead", "multi-step", "draft"])
def test_composes_with_serving_features(models, kw):
    """Warm equals the same features' cold batcher; on int8 pools the warm
    suffix attends the int8-rounded prefix, so two warm runs are held to each
    other instead."""
    port = models[1]
    requests = shared_prefix(np.random.default_rng(8), 32, (4, 9))

    def run(prefix_cache):
        options = dict(kw)
        if options.pop("draft", False):
            options["draft"] = tdraft.DraftModel(port, TCFG, max_slots=GEOMETRY["max_slots"],
                                                 cache_len=GEOMETRY["cache_len"])
        b = batcher(port, prefix_cache=prefix_cache, **options)
        return drain(b, requests), b

    got, warm = run(True)
    assert warm.prefix_cache.hits >= 1
    if kw.get("kv_quant"):
        assert got == run(True)[0]
    else:
        assert got == run(False)[0]
    if "draft" in kw:
        assert warm.draft is not None and warm.draft.admissions == 2


def test_no_leaks_after_churn_cancel_and_drop(models):
    port = models[1]
    rng = np.random.default_rng(9)
    warm = batcher(port, max_new=3, prefix_cache=True, num_pages=24, max_slots=2)
    total = warm.allocator.available
    for round_ in range(4):  # distinct prompts force inserts and evictions
        drain(warm, [(rng.integers(5, V, (20 + round_,)), None, None) for _ in range(3)])
    # A warm prefill cancelled mid-way gives its shared pages back.
    prefix = rng.integers(5, V, (48,))
    drain(warm, [(np.concatenate([prefix, [7]]), None, None)])
    h = warm.submit(np.concatenate([prefix, rng.integers(5, V, (20,))]))
    warm.step()
    assert warm._prefilling is not None and warm._prefilling["shared"]
    warm.cancel(h)
    warm.run_until_drained()
    assert list(warm.stream(h)) == [] and not warm.active.any()
    warm.prefix_cache.drop_all()
    assert warm.allocator.available == total and warm.allocator._refs == {}
