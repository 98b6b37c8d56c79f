"""The port's load paths against the JAX package's, on the CPU: the port's own
checkpoint, the image-token alignment and the orbax export.

- The port trainer's own checkpoint (`state/state.pt`), params only and as a
  full train state with its optimizer state, carrying non-zero LoRA
  adapters: the loaded weights equal the JAX `merge_lora` of the same tree
  (carried by the weight bridge), and greedy tokens equal the JAX
  package's on the merged tree; tables sized from the saved tensors; an
  orbax `state/` refused naming the export script.
- `initialize_vision_tokenizer`: the rows it adds, their count and the no-op
  on resized tables against JAX; then a penalized batched step at the
  resized vocabulary against the JAX step, and the dense batcher's penalty
  counts sized to it.
- `scripts/export_orbax_to_torch.py` on a tiny orbax checkpoint: the port
  serves the export with the JAX builder's greedy tokens.

The released forms are in `tests/test_torch_load_hf.py`, the trainer and the
CLI in `tests/test_torch_load_train.py`.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import _with_lora
from torch_port_util import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_port_util import (assert_state_matches, jax_params_numpy, port_config,
                             port_model, word_list, word_tokenizer)
from vis_zephyr_tpu.config import tiny_config
from vis_zephyr_tpu.constants import IMAGE_TOKEN_INDEX
from vis_zephyr_tpu.models import builder as jbuilder
from vis_zephyr_tpu.models import vis_zephyr as jvz
from vis_zephyr_tpu.serve import batching as jbatching
from vis_zephyr_tpu.serve import generate as jgen
from vis_zephyr_tpu.train import lora as jlora
from vis_zephyr_tpu_torch.models import builder as tbuilder
from vis_zephyr_tpu_torch.models import vis_zephyr as tvz
from vis_zephyr_tpu_torch.models.convert import state_dict_from_jax
from vis_zephyr_tpu_torch.serve import batching as tbatching
from vis_zephyr_tpu_torch.serve import generate as tgen
from vis_zephyr_tpu_torch.train import checkpoints as tckpt
from vis_zephyr_tpu_torch.train import lora as tlora
from vis_zephyr_tpu_torch.train.optimizer import OptimizerConfig, build_optimizer

CFG = tiny_config()
TCFG = port_config(CFG)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = word_list(CFG.decoder.vocab_size)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _greedy_inputs(cfg, seed: int = 0):
    rng = np.random.default_rng(seed)
    ids = np.array([[1, 5, IMAGE_TOKEN_INDEX, 7, 9, 11]], np.int64)
    side = cfg.vision.image_size
    pixels = rng.standard_normal((1, 4, side, side, 3)).astype(np.float32)
    valid = np.array([[True, True, True, False]])
    return ids, pixels, valid


def _greedy(jax_params, port, cfg, tcfg):
    """(JAX package's, port's) greedy tokens of one multimodal request."""
    ids, pixels, valid = _greedy_inputs(cfg)
    want = jgen.generate(jax_params, ids, pixels, valid, cfg, jgen.SamplingConfig(max_new_tokens=6))
    got = tgen.generate(port, torch.from_numpy(ids), torch.from_numpy(pixels),
                        torch.from_numpy(valid), tcfg, tgen.SamplingConfig(max_new_tokens=6))
    return np.asarray(want), np.asarray(got)


# -- (a) the port trainer's own checkpoint ---------------------------------------------


@pytest.fixture(scope="module")
def lora_params():
    return _with_lora(jax_params_numpy(CFG, 3))


@pytest.fixture(scope="module")
def merged(lora_params):
    """The JAX merge of the LoRA tree, and the JAX package's greedy tokens on it."""
    params = _np_tree(jlora.merge_lora(lora_params))
    ids, pixels, valid = _greedy_inputs(CFG)
    tokens = jgen.generate(params, ids, pixels, valid, CFG, jgen.SamplingConfig(max_new_tokens=6))
    return params, np.asarray(tokens)


def _port_with_lora(lparams):
    model = tvz.VisZephyr(TCFG)
    tlora.add_lora(model, tlora.LoraConfig(r=4, alpha=8), torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_jax(lparams, TCFG), strict=True)
    return model.requires_grad_(False).eval()


@pytest.mark.parametrize("form", ["params", "full_state"])
def test_port_state_merges_lora_like_jax(tmp_path, lora_params, merged, form):
    model = _port_with_lora(lora_params)
    if form == "full_state":
        # An optimizer state with moments for every adapter, as after a step
        # (written directly: the weights, and so the expected merge, stay).
        opt = build_optimizer(model, OptimizerConfig(total_steps=2), stage="2")
        for p in opt.params:
            opt.adamw.state[p] = {"step": torch.tensor(1.0), "exp_avg": torch.randn_like(p),
                                  "exp_avg_sq": torch.rand_like(p)}
        assert len(opt.state_dict()["adamw"]["state"]) == len(opt.params)
        model_dir = tckpt.save_checkpoint(str(tmp_path / "run"),
                                          {"params": model, "opt_state": opt, "step": 2}, step=2)
    else:
        model_dir = str(tmp_path / "model")
        os.makedirs(os.path.join(model_dir, "state"))
        torch.save(model.state_dict(), os.path.join(model_dir, "state", "state.pt"))
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        f.write(CFG.to_json())

    _, loaded, cfg, ctx = tbuilder.load_pretrained_model(model_dir, dtype=torch.float32,
                                                         device="cpu")
    assert cfg == TCFG and ctx == CFG.tokenizer_model_max_length
    assert not any(isinstance(m, tlora.LoraLinear) for m in loaded.modules())
    want_params, want_tokens = merged
    assert_state_matches(loaded.state_dict(), state_dict_from_jax(want_params, TCFG),
                          rtol=1e-5, atol=1e-6)
    ids, pixels, valid = _greedy_inputs(CFG)
    got = tgen.generate(loaded, torch.from_numpy(ids), torch.from_numpy(pixels),
                        torch.from_numpy(valid), TCFG, tgen.SamplingConfig(max_new_tokens=6))
    np.testing.assert_array_equal(np.asarray(got), want_tokens)


def test_port_state_tables_sized_from_the_saved_tensors(tmp_path):
    """A checkpoint whose tables grew past its config's vocabulary loads at
    the saved size, and the returned config says so."""
    model = port_model(jax_params_numpy(CFG, 4), CFG)
    cfg2, n = tvz.initialize_vision_tokenizer(model, word_tokenizer(WORDS), TCFG,
                                              mm_use_im_start_end=True)
    assert n == 2 and cfg2.decoder.vocab_size == CFG.decoder.vocab_size + 2
    os.makedirs(tmp_path / "state")
    torch.save({"params": model.state_dict()}, tmp_path / "state" / "state.pt")
    (tmp_path / "config.json").write_text(CFG.to_json())  # the config's vocabulary: 256
    _, loaded, cfg, _ = tbuilder.load_pretrained_model(str(tmp_path), dtype=torch.float32,
                                                       device="cpu")
    assert cfg.decoder.vocab_size == loaded.decoder.lm_head.weight.shape[0] == 258
    assert_state_matches(loaded.state_dict(), model.state_dict(), rtol=0, atol=0)


def test_orbax_state_is_refused_naming_the_export(tmp_path):
    (tmp_path / "state").mkdir()
    (tmp_path / "state" / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match="orbax.*export_orbax_to_torch"):
        tbuilder.load_pretrained_model(str(tmp_path), device="cpu")


# -- the image-token alignment ---------------------------------------------------------


@pytest.mark.parametrize("flags", [dict(mm_use_im_patch_token=True),
                                   dict(mm_use_im_start_end=True),
                                   dict(mm_use_im_patch_token=True, mm_use_im_start_end=True,
                                        pretrained="new rows")])
def test_initialize_vision_tokenizer_matches_jax(flags):
    flags = dict(flags)
    pretrained = flags.pop("pretrained", None)
    params = jax_params_numpy(CFG, 5)
    n_flag = flags.get("mm_use_im_patch_token", False) + 2 * flags.get("mm_use_im_start_end", False)
    pre = (np.random.default_rng(0).standard_normal((n_flag, CFG.decoder.hidden_size))
           .astype(np.float32) if pretrained else None)
    jtok, ttok = word_tokenizer(WORDS), word_tokenizer(WORDS)
    jparams, jn = jvz.initialize_vision_tokenizer(params, jtok, pretrained_embed_tokens=pre, **flags)
    model = port_model(params, CFG)
    cfg, tn = tvz.initialize_vision_tokenizer(
        model, ttok, TCFG, pretrained_embed_tokens=None if pre is None else torch.from_numpy(pre),
        **flags)
    V = CFG.decoder.vocab_size + n_flag
    assert jn == tn == n_flag and len(jtok) == len(ttok) == V
    assert cfg.decoder.vocab_size == V and model.cfg is cfg and model.decoder.cfg is cfg.decoder
    np.testing.assert_allclose(model.decoder.model.embed_tokens.weight.numpy(),
                               np.asarray(jparams["decoder"]["embed_tokens"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(model.decoder.lm_head.weight.numpy(),
                               np.asarray(jparams["decoder"]["lm_head"]["kernel"]).T,
                               rtol=1e-6, atol=1e-7)
    # Resized tables: a second call adds nothing, in both packages.
    before = model.decoder.model.embed_tokens.weight.clone()
    assert jvz.initialize_vision_tokenizer(jparams, jtok, **flags)[1] == 0
    cfg2, again = tvz.initialize_vision_tokenizer(model, ttok, cfg, **flags)
    assert again == 0 and cfg2.decoder.vocab_size == V
    assert torch.equal(model.decoder.model.embed_tokens.weight, before)


def test_penalized_batched_step_at_the_resized_vocabulary():
    """After the alignment (V = 259): one dense decode step over 4 slots with
    penalties and logprobs against the JAX step on the resized tree, and the
    port's dense batcher serving a penalized request with counts [slots, V]."""
    params = jax_params_numpy(CFG, 6)
    flags = dict(mm_use_im_patch_token=True, mm_use_im_start_end=True)
    jparams, _ = jvz.initialize_vision_tokenizer(params, word_tokenizer(WORDS), **flags)
    jparams = _np_tree(jparams)
    model = port_model(params, CFG)
    cfg, _ = tvz.initialize_vision_tokenizer(model, word_tokenizer(WORDS), TCFG, **flags)
    jcfg = dataclasses.replace(CFG, decoder=dataclasses.replace(CFG.decoder, vocab_size=259))
    V, dec = 259, CFG.decoder
    assert cfg.decoder.vocab_size == V
    rng = np.random.default_rng(3)
    shape = (dec.num_layers, 4, 64, dec.num_kv_heads, dec.head_dim)
    k = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    v = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    lengths = np.array([5, 0, 37, 20], np.int32)
    token = np.array([7, 1, 257, 3], np.int64)  # 257: <im_start>
    active = np.array([True, False, True, True])
    counts = rng.integers(0, 3, (4, V)).astype(np.float32)
    freq = np.array([0.5, 0.0, 0.0, 1.0], np.float32)
    pres = np.array([1.0, 0.0, 2.0, 0.0], np.float32)
    sampling = dict(max_new_tokens=4, temperature=0.0, eos_token_id=-1)
    cache = {"k": jnp.asarray(k), "v": jnp.asarray(v), "length": jnp.asarray(lengths)}
    want_tok, _, _, want_counts = jbatching._batch_step(
        jparams, cache, jnp.asarray(token, jnp.int32), jnp.asarray(active),
        jax.random.PRNGKey(0), jcfg, jgen.SamplingConfig(**sampling), want_logprobs=True,
        penalties=(jnp.asarray(freq), jnp.asarray(pres), jnp.asarray(counts)))
    tcache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
              "length": torch.from_numpy(lengths.copy())}
    tcounts = torch.from_numpy(counts.copy())
    got_tok, logits = tbatching._batch_step(
        model, tcache, torch.from_numpy(token.copy()), torch.from_numpy(active), None, cfg,
        tgen.SamplingConfig(**sampling),
        penalties=(torch.from_numpy(freq), torch.from_numpy(pres), tcounts))
    assert logits.shape[-1] == V
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(want_counts))

    b = tbatching.ContinuousBatcher(model, cfg, max_slots=2, cache_len=64,
                                    sampling=tgen.SamplingConfig(max_new_tokens=4, eos_token_id=-1))
    handle = b.submit(np.array([1, 257, 9, 258, 11], np.int64), presence_penalty=1.5,
                      frequency_penalty=0.5)
    b.run_until_drained()
    assert b.counts.shape == (2, V)
    assert len(list(b.stream(handle))) == 4


# -- the orbax export ------------------------------------------------------------------


def _export_module():
    spec = importlib.util.spec_from_file_location(
        "export_orbax_to_torch", os.path.join(REPO, "scripts", "export_orbax_to_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_export_orbax_to_torch_serves_the_jax_tokens(tmp_path, lora_params):
    from vis_zephyr_tpu.train.checkpoints import save_checkpoint as jsave

    src = tmp_path / "jax_model"
    path = jsave(str(tmp_path / "ckpts"), {"params": lora_params}, step=1)
    src.mkdir()
    os.rename(os.path.join(path, "state"), src / "state")
    (src / "config.json").write_text(CFG.to_json())
    word_tokenizer(WORDS).save_pretrained(str(src))

    out = tmp_path / "port_model"
    written = _export_module().export(str(src), str(out))
    assert written == str(out / "state" / "state.pt")
    assert {"config.json", "tokenizer.json", "state"} <= set(os.listdir(out))
    assert os.listdir(src / "state") and not os.path.exists(src / "state" / "state.pt")

    _, jparams, jcfg, _ = jbuilder.load_pretrained_model(str(src), dtype=jnp.float32)
    tok, loaded, cfg, _ = tbuilder.load_pretrained_model(str(out), dtype=torch.float32,
                                                         device="cpu")
    assert len(tok) == CFG.decoder.vocab_size
    want, got = _greedy(_np_tree(jparams), loaded, jcfg, cfg)
    np.testing.assert_array_equal(got, want)


