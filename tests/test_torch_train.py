"""The port's trainer (stage 1 and stage 2) against the JAX package, on the CPU.

One JAX parameter tree (f32, seeded) feeds both packages through the weight
bridge, at `tiny_config` (the decoder's head_dim 16 takes plain attention in
both packages on the CPU); batches are seeded numpy arrays.

- `cross_entropy` and `loss_fn` equal to JAX's.
- One `train_step` for stage 1 and for stage 2 (LoRA adapters bridged from
  JAX with a non-zero `lora_b`, dropout 0): the same loss, token count and
  grad_norm as the JAX `make_train_step` (relative 1e-4).
- After 3 optimizer steps with warmup, cosine, the clip engaged and two
  parameter groups (decay / no decay), the projector's (stage 1) and the
  adapters' (stage 2) updates agree with JAX's: cosine >= 0.9999 and max-abs
  within 5 % of the largest update.
- The schedule equals optax's; grad accumulation 2 × B/2 equals one batch
  of B; remat on equals remat off with LoRA dropout on.
- The LoRA structure (targets, zero init, merge, split / attach).
- `preprocess`, `Collator` and `train()` end to end are held in
  `test_torch_train_loop.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_port_util import jax_params_numpy, port_config, port_model
from vis_zephyr_tpu.config import tiny_config
from vis_zephyr_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from vis_zephyr_tpu.train import lora as jlora
from vis_zephyr_tpu.train import optimizer as jopt
from vis_zephyr_tpu.train import steps as jsteps
from vis_zephyr_tpu_torch.models import mistral as tmistral
from vis_zephyr_tpu_torch.models.convert import state_dict_from_jax
from vis_zephyr_tpu_torch.train import lora as tlora
from vis_zephyr_tpu_torch.train import optimizer as topt
from vis_zephyr_tpu_torch.train import steps as tsteps

CFG = tiny_config()
TCFG = port_config(CFG)
V = CFG.decoder.vocab_size
LORA = dict(r=4, alpha=8)


def _batch(seed: int, B: int = 2, T: int = 12, P: int = 3, images: bool = True):
    """A right-padded multimodal batch (numpy): the sentinel at position 1,
    row 1 padded from 9 on with one invalid crop; labels IGNORE over BOS,
    the sentinel and the padding."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, V, (B, T))
    valid = np.ones((B, T), bool)
    valid[1, 9:] = False
    ids[~valid] = CFG.decoder.pad_token_id
    labels = np.where(valid, ids, IGNORE_INDEX)
    labels[:, 0] = IGNORE_INDEX
    batch = {"input_ids": ids, "labels": labels, "text_valid": valid}
    if images:
        ids[:, 1] = IMAGE_TOKEN_INDEX
        labels[:, 1] = IGNORE_INDEX
        s = CFG.vision.image_size
        batch["images"] = rng.standard_normal((B, P, s, s, 3)).astype(np.float32)
        batch["patch_valid"] = np.array([[True] * P, [True] * (P - 1) + [False]])
    return batch


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _with_lora(params, seed: int = 1):
    """JAX params with LoRA adapters whose `lora_b` is random (non-zero), so
    both adapter matrices get gradients."""
    lp = jlora.add_lora(params, jlora.LoraConfig(**LORA), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict) and "lora_b" in node:
            node = dict(node)
            node["lora_b"] = jnp.asarray(0.1 * rng.standard_normal(node["lora_b"].shape),
                                         jnp.float32)
            return node
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    return jax.tree_util.tree_map(np.asarray, walk(lp))


def _port_with_lora(lparams):
    """The port's model carrying the JAX tree `lparams`, adapters included."""
    from vis_zephyr_tpu_torch.models.vis_zephyr import VisZephyr

    model = VisZephyr(TCFG)
    tlora.add_lora(model, tlora.LoraConfig(**LORA), torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_jax(lparams, TCFG), strict=True)
    return model.requires_grad_(False).eval()


@pytest.fixture(scope="module")
def params():
    return jax_params_numpy(CFG, 0)


@pytest.fixture(scope="module")
def lora_params(params):
    return _with_lora(params)


# -- loss ------------------------------------------------------------------------------


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 7))
    labels[0, :3] = IGNORE_INDEX
    want_loss, want_n = jsteps.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got_loss, got_n = tsteps.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-6)
    assert int(got_n) == int(want_n) == 10
    # Every target ignored: loss 0 over a count of 0, no NaN.
    none = np.full((2, 7), IGNORE_INDEX)
    got_loss, got_n = tsteps.cross_entropy(torch.from_numpy(logits), torch.from_numpy(none))
    assert float(got_loss) == 0.0 and int(got_n) == 0


# The JAX reference jitted once for both cases: op by op, its first call
# compiles every primitive on its own (19 s against 4 s jitted).
_jax_loss = jax.jit(jsteps.loss_fn, static_argnums=(2,), static_argnames=("remat",))


@pytest.mark.parametrize("images", [True, False], ids=["multimodal", "text_only"])
def test_loss_fn_matches_jax(params, images):
    batch = _batch(3, images=images)
    want, wmet = _jax_loss(params, _jnp(batch), CFG, remat=False)
    with torch.no_grad():
        got, gmet = tsteps.loss_fn(port_model(params, CFG), _torch(batch), TCFG, remat=False)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    assert int(gmet["tokens"]) == int(wmet["tokens"])


# -- one step, and three --------------------------------------------------------------


def _jax_run(params, stage, opt_cfg, batches):
    """JAX make_train_step over `batches` → (per-step metrics, final params)."""
    tx = jopt.build_optimizer(params, opt_cfg, stage=stage)
    step = jax.jit(jsteps.make_train_step(CFG, tx, remat=False,
                                          trainable=jopt.trainable_mask(params, stage)))
    state = jsteps.init_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx)
    metrics = []
    for b in batches:
        state, m = step(state, _jnp(b))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree_util.tree_map(np.asarray, state["params"])


def _port_run(model, stage, opt_cfg, batches):
    optimizer = topt.build_optimizer(model, opt_cfg, stage=stage)
    step = tsteps.make_train_step(model, TCFG, optimizer, remat=False,
                                  trainable=topt.trainable_mask(model, stage))
    state = tsteps.init_train_state(model, optimizer)
    metrics = []
    for b in batches:
        state, m = step(state, _torch(b))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics


def _assert_metrics(got, want):
    for g, w in zip(got, want):
        for key in ("loss", "tokens", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("stage", ["1", "2"])
def test_one_train_step_matches_jax(params, lora_params, stage):
    tree = params if stage == "1" else lora_params
    model = port_model(tree, CFG) if stage == "1" else _port_with_lora(tree)
    opt_cfg = jopt.OptimizerConfig(learning_rate=1e-3, projector_lr=1e-2, total_steps=10)
    batches = [_batch(5)]
    want, _ = _jax_run(tree, stage, opt_cfg, batches)
    got = _port_run(model, stage, topt.OptimizerConfig(**dataclasses.asdict(opt_cfg)), batches)
    _assert_metrics(got, want)
    # Only the stage's parameters got gradients.
    trained = {n for n, p in model.named_parameters() if p.requires_grad}
    if stage == "1":
        assert trained and all(n.startswith("projector.") for n in trained)
    else:
        assert trained and all(n.rsplit(".", 1)[-1] in ("lora_a", "lora_b") for n in trained)
    assert all(p.grad is None for p in model.parameters())


def _flat_updates(before, after, names):
    return np.concatenate([(after[n] - before[n]).ravel() for n in names])


@pytest.mark.parametrize("stage", ["1", "2"])
def test_three_step_updates_match_jax(params, lora_params, stage):
    """Warmup of one step then cosine (lr at counts 0, 1, 2 is 1, 1, 0.5 of
    the peak), weight decay 0.1 on the decay group and none on the other,
    and a clip at 1e-3, far under every step's grad_norm. Adam divides each
    gradient by its own running RMS, so the update's direction is what the
    gradient's signs and ratios decide: cosine 0.9999 and 5 % of the largest
    element leave room only for f32 summation order."""
    tree = params if stage == "1" else lora_params
    model = port_model(tree, CFG) if stage == "1" else _port_with_lora(tree)
    opt_cfg = jopt.OptimizerConfig(learning_rate=5e-3, projector_lr=1e-2, weight_decay=0.1,
                                   warmup_ratio=0.5, total_steps=3, max_grad_norm=1e-3)
    batches = [_batch(10 + i) for i in range(3)]
    want, jparams = _jax_run(tree, stage, opt_cfg, batches)
    before = {n: p.detach().clone().numpy() for n, p in model.named_parameters()}
    got = _port_run(model, stage, topt.OptimizerConfig(**dataclasses.asdict(opt_cfg)), batches)
    _assert_metrics(got, want)
    assert all(m["grad_norm"] > 10 * opt_cfg.max_grad_norm for m in got)  # the clip engaged

    after = {n: p.detach().numpy() for n, p in model.named_parameters()}
    jafter = {n: v.numpy() for n, v in state_dict_from_jax(jparams, TCFG).items()}
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    got_u, want_u = _flat_updates(before, after, names), _flat_updates(before, jafter, names)
    cos = float(got_u @ want_u / (np.linalg.norm(got_u) * np.linalg.norm(want_u)))
    assert cos >= 0.9999, cos
    assert np.abs(got_u - want_u).max() <= 0.05 * np.abs(want_u).max()
    # The frozen rest did not move.
    for n, p in model.named_parameters():
        if not p.requires_grad:
            np.testing.assert_array_equal(after[n], before[n])


def test_optimizer_groups_and_schedule_match_optax():
    """Four labels as the JAX `build_optimizer` assigns them, and the
    schedule equal to optax's at every count (warmup 3 of 10, cosine)."""
    opt_cfg = topt.OptimizerConfig(learning_rate=2e-5, projector_lr=2e-3, warmup_ratio=0.3,
                                   total_steps=10)
    j_cfg = jopt.OptimizerConfig(**dataclasses.asdict(opt_cfg))
    for lr in (2e-5, 2e-3):
        sched = jopt._make_schedule(j_cfg, lr)
        for count in range(12):
            np.testing.assert_allclose(topt.schedule_value(opt_cfg, lr, count),
                                       float(sched(count)), rtol=1e-6)
    const = dataclasses.replace(opt_cfg, schedule="constant")
    sched = jopt._make_schedule(dataclasses.replace(j_cfg, schedule="constant"), 1.0)
    for count in range(12):
        np.testing.assert_allclose(topt.schedule_value(const, 1.0, count), float(sched(count)),
                                   rtol=1e-6)
    assert topt.learning_rates_at(opt_cfg, 4) == pytest.approx(jopt.learning_rates_at(j_cfg, 4))

    from vis_zephyr_tpu_torch.models.vis_zephyr import VisZephyr

    model = VisZephyr(TCFG)
    opt = topt.build_optimizer(model, opt_cfg, stage="full")
    labels = {g["label"]: len(g["params"]) for g in opt.adamw.param_groups}
    assert set(labels) == {"projector_decay", "projector_no_decay", "base_decay", "base_no_decay"}
    names = {id(p): n for n, p in model.named_parameters()}
    no_decay = {names[id(p)] for g in opt.adamw.param_groups if g["label"].endswith("no_decay")
                for p in g["params"]}
    assert "projector.learned_queries" in no_decay and "projector.norm.weight" in no_decay
    assert "decoder.model.layers.0.input_layernorm.weight" in no_decay
    assert "projector.blocks.0.ffn.0.bias" in no_decay
    assert "projector.blocks.0.ffn.0.weight" not in no_decay
    trained = {names[id(p)] for g in opt.adamw.param_groups for p in g["params"]}
    assert trained and not any(n.startswith("vision.") for n in trained)


def test_grad_accumulation_matches_big_batch(params):
    """Two micro-steps of B/2 through `accum=2` equal one step of B: the
    mean of the micro-batch means equals the big batch's mean loss when the
    halves hold equal token counts, and so do the updates."""
    def text_batch(seed):
        r = np.random.default_rng(seed)
        return {"input_ids": r.integers(5, V, (2, 8)), "labels": r.integers(5, V, (2, 8))}

    micro1, micro2 = text_batch(1), text_batch(2)
    big = {k: np.concatenate([micro1[k], micro2[k]]) for k in micro1}
    opt_cfg = topt.OptimizerConfig(learning_rate=1e-2, projector_lr=None, total_steps=4,
                                   warmup_ratio=0.0, schedule="constant")

    acc_model = port_model(params, CFG)
    opt = topt.build_optimizer(acc_model, opt_cfg, stage="full", accum=2)
    step = tsteps.make_train_step(acc_model, TCFG, opt, remat=False)
    state = tsteps.init_train_state(acc_model, opt)
    w0 = acc_model.decoder.lm_head.weight.detach().clone()
    state, m1 = step(state, _torch(micro1))
    assert torch.equal(acc_model.decoder.lm_head.weight, w0)  # mid-accumulation
    state, m2 = step(state, _torch(micro2))

    big_model = port_model(params, CFG)
    opt_big = topt.build_optimizer(big_model, opt_cfg, stage="full")
    big_step = tsteps.make_train_step(big_model, TCFG, opt_big, remat=False)
    _, mb = big_step(tsteps.init_train_state(big_model, opt_big), _torch(big))

    np.testing.assert_allclose((float(m1["loss"]) + float(m2["loss"])) / 2, float(mb["loss"]),
                               rtol=1e-5)
    for (n, a), b in zip(acc_model.named_parameters(), big_model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-3,
                                   atol=1e-4, err_msg=n)


def test_remat_equals_no_remat_with_lora_dropout(lora_params):
    """Each dropout mask comes from a seed folded from (step seed, layer,
    projection), so the recompute under `checkpoint` draws the masks the
    forward drew: loss and adapter gradients equal with remat on and off."""
    model = _port_with_lora(lora_params)
    opt = topt.build_optimizer(model, topt.OptimizerConfig(), stage="2")
    batch = _torch(_batch(7))

    def loss_and_grads(remat, rng, rate=0.5):
        loss, _ = tsteps.loss_fn(model, batch, TCFG, remat=remat, lora_dropout=rate,
                                 dropout_rng=rng)
        return float(loss.detach()), torch.autograd.grad(loss, opt.params)

    loss_off, grads_off = loss_and_grads(False, 1234)
    loss_on, grads_on = loss_and_grads(True, 1234)
    assert loss_on == pytest.approx(loss_off, rel=1e-6)
    for a, b in zip(grads_on, grads_off):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    # The masks are real: another seed, or no dropout, gives another loss.
    assert loss_and_grads(False, 99)[0] != loss_off
    assert loss_and_grads(False, 1234, rate=0.0)[0] != loss_off
    assert loss_and_grads(False, None)[0] == loss_and_grads(False, 1234, rate=0.0)[0]


def test_fold_seed_is_a_function_of_its_inputs():
    seeds = {tmistral.fold_seed(7, layer, proj) for layer in range(32) for proj in range(7)}
    assert len(seeds) == 32 * 7 and all(0 <= s < 2 ** 63 for s in seeds)
    assert tmistral.fold_seed(7, 3, 1) == tmistral.fold_seed(7, 3, 1) != tmistral.fold_seed(8, 3, 1)


# -- LoRA structure (as tests/test_lora.py) -----------------------------------------------


def test_lora_targets_decoder_linears_only(params):
    model = port_model(params, CFG)
    tlora.add_lora(model, tlora.LoraConfig(**LORA), torch.Generator().manual_seed(0))
    wrapped = {n for n, m in model.named_modules() if isinstance(m, tlora.LoraLinear)}
    want = {f"decoder.model.layers.{i}.{p}" for i in range(CFG.decoder.num_layers)
            for p in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                      "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")}
    assert wrapped == want
    q = model.decoder.model.layers[0].self_attn.q_proj
    assert q.lora_a.shape == (CFG.decoder.hidden_size, LORA["r"])
    assert q.lora_b.shape == (LORA["r"], CFG.decoder.num_heads * CFG.decoder.head_dim)
    assert float(q.lora_b.abs().max()) == 0.0 and float(q.lora_scale) == 2.0
    assert set(tlora.lora_trainable_mask(model).values()) == {True, False}
    assert all(v == (n.endswith("lora_a") or n.endswith("lora_b"))
               for n, v in tlora.lora_trainable_mask(model).items())
    # The JAX package's own LoRA leaves land on exactly these names.
    lp = jax.tree_util.tree_map(np.asarray, jlora.add_lora(params, jlora.LoraConfig(**LORA),
                                                           jax.random.PRNGKey(0)))
    assert set(state_dict_from_jax(lp, TCFG)) == set(model.state_dict())


def test_lora_zero_init_preserves_forward(params):
    ids = torch.from_numpy(np.random.default_rng(0).integers(5, V, (1, 6)))
    pos = torch.arange(6)[None]
    base = port_model(params, CFG)
    want, _ = tmistral.mistral_forward(base.decoder, tmistral.embed(base.decoder, ids),
                                       TCFG.decoder, pos)
    tlora.add_lora(base, tlora.LoraConfig(**LORA), torch.Generator().manual_seed(0))
    got, _ = tmistral.mistral_forward(base.decoder, tmistral.embed(base.decoder, ids),
                                      TCFG.decoder, pos)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_lora_merge_and_split_attach(lora_params):
    ids = torch.from_numpy(np.random.default_rng(1).integers(5, V, (1, 5)))
    pos = torch.arange(5)[None]

    def logits(m):
        with torch.no_grad():
            return tmistral.mistral_forward(m.decoder, tmistral.embed(m.decoder, ids),
                                            TCFG.decoder, pos)[0]

    live = _port_with_lora(lora_params)
    want = logits(live)
    # split / attach round trip: same modules, same state dict, same logits.
    keys = set(live.state_dict())
    base, adapters = tlora.split_lora(live)
    assert adapters and all(set(a) == {"lora_a", "lora_b", "lora_scale"} for a in adapters.values())
    assert not any(k.endswith("lora_a") for k in base.state_dict())
    back = tlora.attach_lora(base, adapters)
    assert set(back.state_dict()) == keys
    torch.testing.assert_close(logits(back), want)
    # merge: folded into the base weights, the same logits.
    merged = tlora.merge_lora(back)
    assert not any(isinstance(m, tlora.LoraLinear) for m in merged.modules())
    torch.testing.assert_close(logits(merged), want, rtol=2e-5, atol=2e-5)
    # and equal to the JAX merge of the same adapters.
    jmerged = jax.tree_util.tree_map(np.asarray, jlora.merge_lora(lora_params))
    for name, value in state_dict_from_jax(jmerged, TCFG).items():
        torch.testing.assert_close(merged.state_dict()[name], value, rtol=1e-5, atol=1e-6)


def test_lora_refuses_a_quantized_base(params):
    from vis_zephyr_tpu_torch.models.builder import quantize_weights

    model = quantize_weights(port_model(params, CFG), bits=8)
    with pytest.raises(NotImplementedError, match="step 10"):
        tlora.add_lora(model, tlora.LoraConfig(**LORA), torch.Generator().manual_seed(0))
