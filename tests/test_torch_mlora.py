"""The port's multi-LoRA serving (`ops/mlora.py` and its callers) against the
JAX package's, on the CPU at `tiny_config` in f32.

- `mlora_delta` against the JAX `mlora_delta` on one pack (within 1e-5), a
  base row's delta exactly 0.0, `build_pack`'s rank padding and missing
  targets against the JAX `build_pack`, and the pack carried across from
  the JAX `make_random_pack` with `lora_leaves_for_adapter` giving the JAX
  leaves;
- both batchers with base, alpha and beta requests mixed in one batch
  (the paged one in the JAX test's cases: plain, KV-fused, int8 KV-fused,
  bursts of 3, lookahead 3, chunks of 16): every request's greedy tokens
  equal the port's solo run with that adapter's leaves attached
  (`train/lora.py::attach_lora`, the single-LoRA path) and the JAX dense
  batcher's tokens for the same mixed batch;
- a draft model (its own base weights) beside the adapters gives the
  tokens without it; the prefix cache keeps adapters apart, a
  lazy-allocation swap keeps a slot's adapter, an unknown adapter raises `KeyError`, the engine routes
  adapters and a serialized engine refuses them, and `load_lora_pack`
  reads peft dirs written here as the JAX `load_lora_pack` reads them.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import MockTokenizer
from torch_port_util import jax_params_numpy, one_torch_thread, port_config, port_model  # noqa: F401
from vis_zephyr_tpu.config import tiny_config
from vis_zephyr_tpu.models import builder as jbuilder
from vis_zephyr_tpu.ops import mlora as jmlora
from vis_zephyr_tpu.serve import batching as jbatching
from vis_zephyr_tpu.serve import generate as jgen
from vis_zephyr_tpu_torch.models import builder as tbuilder
from vis_zephyr_tpu_torch.ops import mlora as tmlora
from vis_zephyr_tpu_torch.serve import batching as tbatching
from vis_zephyr_tpu_torch.serve import engine as tengine
from vis_zephyr_tpu_torch.serve import generate as tgen
from vis_zephyr_tpu_torch.serve import paged as tpaged
from vis_zephyr_tpu_torch.train.lora import attach_lora
from vis_zephyr_tpu_torch.utils.metrics import ServingMetrics

CFG = tiny_config(vocab_size=256)
TCFG = port_config(CFG)
L = CFG.decoder.num_layers
NAMES = {"alpha": 1, "beta": 2}
MAX_NEW = 6
PAGED = dict(max_slots=4, cache_len=64, page_size=16, num_pages=32)
PAGED_CASES = {"plain": {}, "kv_fused": dict(kv_fused=True),
               "kv_quant_fused": dict(kv_quant=True, kv_fused=True), "multi_step": dict(multi_step=3),
               "lookahead": dict(lookahead=3), "prefill_chunk": dict(prefill_chunk=16)}
DENSE_CASES = {"whole": {}, "chunked": dict(prefill_chunk=16), "burst": dict(multi_step=3),
               "lookahead": dict(lookahead=3)}


def greedy(max_new=MAX_NEW):
    return tgen.SamplingConfig(max_new_tokens=max_new, temperature=0.0, eos_token_id=-1)


def from_jax_leaves(jpack, adapter: int):
    """One adapter of a JAX pack in `attach_lora` form, from its numpy leaves."""
    out = {}
    for group, kids in jpack.items():
        for name, t in kids.items():
            module = tmlora.MODULES[f"{group}/{name}"]
            for i in range(L):
                out[f"decoder.model.layers.{i}.{module}"] = {
                    "lora_a": torch.tensor(np.asarray(t["a"])[i, adapter]),
                    "lora_b": torch.tensor(np.asarray(t["b"])[i, adapter]),
                    "lora_scale": torch.tensor(float(np.asarray(t["scale"])[i, adapter]))}
    return out


@pytest.fixture(scope="module")
def setup():
    """(JAX params, port model, JAX pack, the port's pack of the same leaves)."""
    params = jax_params_numpy(CFG, 0)
    make = jax.jit(jmlora.make_random_pack, static_argnums=(0, 1, 2))  # 2.7 s, 6.5 op by op
    jpack = jax.tree_util.tree_map(np.asarray, make(CFG, 2, 4, jax.random.PRNGKey(7)))
    tpack = tmlora.build_pack([from_jax_leaves(jpack, j) for j in (1, 2)], L)
    return params, port_model(params, CFG), jpack, tpack


def scenario():
    """[(ids, adapter)]: beta, base, alpha and alpha in one batch of 4 slots."""
    rng = np.random.default_rng(0)
    return [(rng.integers(5, CFG.decoder.vocab_size, (T,)).astype(np.int64), ad)
            for T, ad in ((5, "beta"), (9, None), (6, "alpha"), (8, "alpha"))]


def run(batcher, reqs):
    handles = [batcher.submit(ids, adapter=ad) for ids, ad in reqs]
    batcher.run_until_drained()
    return [list(batcher.stream(h)) for h in handles]


def attached(model, tpack, adapter: int):
    """The port model with one adapter's leaves attached (a copy)."""
    return attach_lora(copy.deepcopy(model), tmlora.lora_leaves_for_adapter(tpack, adapter))


def solo_tokens(model, ids, max_new=MAX_NEW):
    b = tbatching.ContinuousBatcher(model, TCFG, max_slots=1, cache_len=64,
                                    sampling=greedy(max_new))
    return run(b, [(ids, None)])[0]


@pytest.fixture(scope="module")
def solo(setup):
    """Each scenario request alone on the model with its adapter attached."""
    _, port, _, tpack = setup
    models = {ad: attached(port, tpack, NAMES[ad]) for ad in NAMES}
    models[None] = port
    return [solo_tokens(models[ad], ids) for ids, ad in scenario()]


@pytest.fixture(scope="module")
def jax_tokens(setup):
    """The JAX dense batcher's tokens for the scenario's mixed batch."""
    params, _, jpack, _ = setup
    b = jbatching.ContinuousBatcher(
        params, CFG, max_slots=4, cache_len=64, mlora=jax.tree_util.tree_map(jnp.asarray, jpack),
        adapter_names=NAMES,
        sampling=jgen.SamplingConfig(max_new_tokens=MAX_NEW, temperature=0.0, eos_token_id=-1))
    return run(b, scenario())


# -- the op --------------------------------------------------------------------------


@pytest.mark.parametrize("target", ["attn/q", "attn/k", "attn/out", "mlp/down"])
def test_delta_matches_jax(setup, target):
    _, _, jpack, tpack = setup
    group, name = target.split("/")
    layer = 1
    jt = {k: jnp.asarray(v[layer]) for k, v in jpack[group][name].items()}
    idx = np.array([2, 0, 1, 2, 0], np.int32)
    ctx = tmlora.mlora_ctx(tpack, torch.from_numpy(idx), torch.float32)
    tt = tmlora.layer_targets(tpack, layer, ctx)[tmlora.PROJ_INDEX[target]]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 2, tt["a_cat"].shape[0])).astype(np.float32)
    want = np.asarray(jmlora.mlora_delta(jnp.asarray(x), jt, jmlora.ragged_ctx(jnp.asarray(idx), 3)))
    got = tmlora.mlora_delta(torch.from_numpy(x), tt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.abs(got[[1, 4]]).max() == 0.0  # the base rows
    # The decoder's form: the delta added to a projection in the epilogue.
    out = rng.standard_normal(got.shape).astype(np.float32)
    added = tmlora.mlora_add(torch.from_numpy(out), torch.from_numpy(x), tt).numpy()
    np.testing.assert_allclose(added, out + want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(added[[1, 4]], out[[1, 4]])


def test_base_rows_delta_exactly_zero(setup):
    """Base rows get exactly 0.0, beside adapted rows and whatever the pack's
    other panels hold."""
    tpack = setup[3]
    rng = np.random.default_rng(5)
    ctx = tmlora.mlora_ctx(tpack, torch.tensor([0, 1, 0, 2]), torch.float32)
    for index, target in tmlora.layer_targets(tpack, 0, ctx).items():
        K, M = target["a_cat"].shape[0], target["b_cat"].shape[1]
        x = torch.from_numpy(rng.standard_normal((4, 3, K)).astype(np.float32) * 100)
        d = tmlora.mlora_delta(x, target)
        assert (d[[0, 2]] == 0.0).all() and d[[1, 3]].abs().max() > 0, index
        out = torch.from_numpy(rng.standard_normal((4, 3, M)).astype(np.float32))
        assert torch.equal(tmlora.mlora_add(out, x, target)[[0, 2]], out[[0, 2]]), index
    # The panels are views of the pack: nothing is copied a step.
    q = tmlora.layer_targets(tpack, 1, ctx)[0]
    assert q["a_cat"].untyped_storage().data_ptr() == tpack["attn"]["q"]["a"].untyped_storage().data_ptr()
    assert q["b_cat"].untyped_storage().data_ptr() == tpack["attn"]["q"]["b"].untyped_storage().data_ptr()


def test_build_pack_rank_padding_and_missing_targets_match_jax():
    dec = CFG.decoder
    D, nq, I = dec.hidden_size, dec.num_heads * dec.head_dim, dec.intermediate_size
    rng = np.random.default_rng(1)

    def adapter(r, targets):
        return {t: {"lora_a": rng.standard_normal((L, K, r)).astype(np.float32),
                    "lora_b": rng.standard_normal((L, r, M)).astype(np.float32),
                    "lora_scale": np.full((L,), 16.0 / r, np.float32)}
                for t, (K, M) in targets.items()}

    jax_form = [adapter(2, {"attn/q": (D, nq)}),
                adapter(4, {"attn/q": (D, nq), "mlp/down": (I, D)})]
    want = jmlora.build_pack([{f"decoder/layers/{t}": v for t, v in ad.items()}
                              for ad in jax_form], L)
    port_form = [{f"decoder.model.layers.{i}.{tmlora.MODULES[t]}":
                  {k: torch.as_tensor(v[i]) for k, v in leaves.items()}
                  for t, leaves in ad.items() for i in range(L)} for ad in jax_form]
    got = tmlora.build_pack(port_form, L)
    assert tmlora.pack_num_adapters(got) == jmlora.pack_num_adapters(want) == 3
    assert {g: set(k) for g, k in got.items()} == {"attn": {"q"}, "mlp": {"down"}}
    assert got["attn"]["q"]["a"].shape == (L, 3, D, 4)  # padded to the largest rank
    for group, kids in want.items():
        for name, t in kids.items():
            for leaf in ("a", "b", "scale"):
                np.testing.assert_array_equal(got[group][name][leaf].numpy(), np.asarray(t[leaf]))
    assert float(got["mlp"]["down"]["a"][:, 1].abs().max()) == 0.0  # a1 lacks mlp/down
    with pytest.raises(ValueError, match="covers"):
        tmlora.build_pack([{k: v for k, v in port_form[0].items() if "layers.0." in k}], L)


def test_pack_carried_across_from_jax(setup):
    _, _, jpack, tpack = setup
    for group, kids in jpack.items():
        for name, t in kids.items():
            for leaf in ("a", "b", "scale"):
                np.testing.assert_array_equal(tpack[group][name][leaf].numpy(), t[leaf])
    want = jmlora.lora_leaves_for_adapter(jpack, 2)
    got = tmlora.lora_leaves_for_adapter(tpack, 2)
    assert len(got) == 7 * L
    for target in tmlora.TARGETS:
        for i in range(L):
            leaves = got[f"decoder.model.layers.{i}.{tmlora.MODULES[target]}"]
            for leaf in ("lora_a", "lora_b", "lora_scale"):
                np.testing.assert_array_equal(leaves[leaf].numpy(),
                                              np.asarray(want[f"decoder/layers/{target}"][leaf])[i])
    # A random pack from a generator: the base index is zero, the adapters not.
    rand = tmlora.make_random_pack(TCFG, 2, 8, torch.Generator().manual_seed(0))
    q = rand["attn"]["q"]
    assert q["a"].shape == (L, 3, CFG.decoder.hidden_size, 8)
    assert float(q["a"][:, 0].abs().max()) == float(q["scale"][:, 0].abs().max()) == 0.0
    assert float(q["a"][:, 1:].abs().min()) >= 0 and float(q["b"][:, 1:].abs().max()) > 0
    assert tmlora.pack_bytes(rand) == sum(
        t.numel() * 4 for g in rand.values() for tgt in g.values() for t in tgt.values())


# -- the batchers ----------------------------------------------------------------------


def test_adapters_change_the_tokens(solo, setup):
    """The oracle is not trivial: each adapter changes its request's tokens."""
    port = setup[1]
    for (ids, ad), want in zip(scenario(), solo):
        if ad is not None:
            assert solo_tokens(port, ids) != want, ad


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_batcher_mixed_adapters(setup, solo, jax_tokens, case):
    _, port, _, tpack = setup
    b = tbatching.ContinuousBatcher(port, TCFG, max_slots=4, cache_len=64, sampling=greedy(),
                                    mlora=tpack, adapter_names=NAMES, **DENSE_CASES[case])
    got = run(b, scenario())
    assert got == solo and got == jax_tokens
    assert int(b.slot_adapter.abs().sum()) == 0  # every slot back at the base
    if case == "lookahead":
        assert b.verify_steps > 0


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_batcher_mixed_adapters(setup, solo, jax_tokens, case):
    _, port, _, tpack = setup
    b = tpaged.PagedBatcher(port, TCFG, sampling=greedy(), mlora=tpack, adapter_names=NAMES,
                            **PAGED, **PAGED_CASES[case])
    got = run(b, scenario())
    assert got == solo and got == jax_tokens
    if case == "multi_step":
        assert b.bursts > 0
    if case == "lookahead":
        assert b.verify_steps > 0


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_draft_model_with_adapters_gives_the_tokens_without_it(setup, solo, kind):
    """A draft model proposes with its own base weights; each slot's verify
    step applies the slot's adapter, so the tokens are those of the batch
    without the draft (the solo runs)."""
    from vis_zephyr_tpu_torch.serve.draft import DraftModel

    _, port, _, tpack = setup
    draft = DraftModel(port, TCFG, max_slots=4, cache_len=64)
    kw = dict(sampling=greedy(), mlora=tpack, adapter_names=NAMES, lookahead=3, draft=draft)
    b = (tbatching.ContinuousBatcher(port, TCFG, max_slots=4, cache_len=64, **kw)
         if kind == "dense" else tpaged.PagedBatcher(port, TCFG, **PAGED, **kw))
    assert run(b, scenario()) == solo
    assert draft.admissions == 4 and draft.steps > 0 and b.proposed > 0


def test_prefix_cache_keeps_adapters_apart(setup):
    """The same prompt under alpha, beta, alpha: each gives its solo tokens,
    beta reuses no page of alpha's, and alpha's repeat hits."""
    _, port, _, tpack = setup
    b = tpaged.PagedBatcher(port, TCFG, max_slots=2, cache_len=64, page_size=16, num_pages=32,
                            sampling=greedy(), mlora=tpack, adapter_names=NAMES,
                            prefill_chunk=16, prefix_cache=True)
    ids = np.random.default_rng(9).integers(5, CFG.decoder.vocab_size, (37,)).astype(np.int64)
    outs, reused = [], []
    for ad in ("alpha", "beta", "alpha"):
        outs.append(run(b, [(ids, ad)])[0])
        reused.append(b.prefix_cache.pages_reused)
    assert reused[:2] == [0, 0] and reused[2] == 2 and b.prefix_cache.hits == 1
    for ad, got in zip(("alpha", "beta", "alpha"), outs):
        assert got == solo_tokens(attached(port, tpack, NAMES[ad]), ids), ad
    assert b._pc_salt(b.submit(ids, adapter="beta")) == b"a2|"
    assert b._pc_salt(b.submit(ids)) == b""


def test_lazy_alloc_swap_keeps_the_adapter(setup):
    """A pool too small for the four spans forces swaps; every request, each
    under its own adapter, gives the eager ample pool's tokens and its solo
    tokens."""
    _, port, _, tpack = setup
    kw = dict(max_slots=4, cache_len=64, page_size=16, sampling=greedy(40), mlora=tpack,
              adapter_names=NAMES)
    metrics = ServingMetrics()
    lazy = run(tpaged.PagedBatcher(port, TCFG, num_pages=9, lazy_alloc=True, metrics=metrics,
                                   **kw), scenario())
    eager = run(tpaged.PagedBatcher(port, TCFG, num_pages=64, **kw), scenario())
    assert metrics.preempt_swap_out > 0 and metrics.preempt_swap_in > 0
    assert lazy == eager
    models = {ad: attached(port, tpack, NAMES[ad]) for ad in NAMES}
    models[None] = port
    for (ids, ad), got in zip(scenario(), lazy):
        assert got == solo_tokens(models[ad], ids, 40), ad


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_unknown_adapter_raises_key_error(setup, kind):
    _, port, _, tpack = setup
    if kind == "dense":
        b = tbatching.ContinuousBatcher(port, TCFG, max_slots=2, cache_len=64, mlora=tpack,
                                        adapter_names=NAMES)
    else:
        b = tpaged.PagedBatcher(port, TCFG, max_slots=2, cache_len=64, page_size=16, mlora=tpack,
                                adapter_names=NAMES)
    with pytest.raises(KeyError, match="nope"):
        b.submit(np.asarray([5, 6, 7]), adapter="nope")
    assert b.submit(np.asarray([5, 6, 7]), adapter="base").adapter == 0
    assert b.submit(np.asarray([5, 6, 7]), adapter="beta").adapter == 2


# -- the engine and the loader ----------------------------------------------------------


def test_engine_routes_adapters_and_serialized_refuses(setup):
    _, port, _, tpack = setup
    kw = dict(max_new_tokens=4, temperature=0.0)
    engine = tengine.ChatEngine(port, TCFG, MockTokenizer(), continuous_batching=True,
                                max_slots=2, cache_len=128, kv_cache="paged", page_size=16,
                                prefill_chunk=16, mlora=tpack, adapter_names=NAMES, **kw)
    alone = tengine.ChatEngine(attached(port, tpack, 1), TCFG, MockTokenizer(), **kw)
    plain = tengine.ChatEngine(port, TCFG, MockTokenizer(), **kw)
    try:
        base = engine.chat_text("s1", "hello w1 w2")
        alpha = engine.chat_text("s2", "hello w1 w2", adapter="alpha")
        assert base != alpha
        assert base == plain.chat_text("s1", "hello w1 w2")
        assert alpha == alone.chat_text("s1", "hello w1 w2")
        got = list(engine.generate_request("hello w1 w2", adapter="alpha"))
        assert got == list(alone.generate_request("hello w1 w2"))
        with pytest.raises(KeyError):
            engine.generate_request("hello", adapter="nope")
        for refused in (lambda: plain.chat_text("s3", "hello", adapter="alpha"),
                        lambda: plain.generate_request("hello", adapter="alpha")):
            with pytest.raises(ValueError, match="continuous-batching"):
                refused()
        assert plain.chat_text("s4", "hello", adapter="base")
    finally:
        for e in (engine, alone, plain):
            e.close()


def write_peft_dir(path, rng, r, modules, alpha):
    from safetensors.numpy import save_file

    dec = CFG.decoder
    D, I = dec.hidden_size, dec.intermediate_size
    nq, nkv = dec.num_heads * dec.head_dim, dec.num_kv_heads * dec.head_dim
    dims = {"self_attn.q_proj": (D, nq), "self_attn.k_proj": (D, nkv),
            "self_attn.v_proj": (D, nkv), "self_attn.o_proj": (nq, D),
            "mlp.gate_proj": (D, I), "mlp.up_proj": (D, I), "mlp.down_proj": (I, D)}
    sd = {}
    for i in range(L):
        for m in modules:
            K, M = dims[m]
            pre = f"base_model.model.model.layers.{i}.{m}"
            sd[f"{pre}.lora_A.weight"] = rng.standard_normal((r, K)).astype(np.float32)
            sd[f"{pre}.lora_B.weight"] = rng.standard_normal((M, r)).astype(np.float32)
    path.mkdir()
    save_file(sd, str(path / "adapter_model.safetensors"))
    (path / "adapter_config.json").write_text(json.dumps({"r": r, "lora_alpha": alpha}))
    return str(path)


def test_load_lora_pack_matches_jax(tmp_path):
    rng = np.random.default_rng(11)
    dirs = {"alpha": write_peft_dir(tmp_path / "a", rng, 4, ["self_attn.q_proj",
                                                             "mlp.down_proj"], 8),
            "beta": write_peft_dir(tmp_path / "b", rng, 2, ["self_attn.q_proj",
                                                            "self_attn.v_proj"], 16)}
    want, want_names = jbuilder.load_lora_pack(dirs, CFG)
    got, names = tbuilder.load_lora_pack(dirs, TCFG)
    assert names == want_names == NAMES
    assert {g: set(k) for g, k in got.items()} == {g: set(k) for g, k in want.items()}
    for group, kids in want.items():
        for name, t in kids.items():
            for leaf in ("a", "b", "scale"):
                np.testing.assert_allclose(got[group][name][leaf].numpy(), np.asarray(t[leaf]),
                                           rtol=1e-6, atol=1e-6)
    bf16, _ = tbuilder.load_lora_pack(dirs, TCFG, dtype=torch.bfloat16)
    assert bf16["attn"]["q"]["a"].dtype == torch.bfloat16
    assert bf16["attn"]["q"]["scale"].dtype == torch.float32
