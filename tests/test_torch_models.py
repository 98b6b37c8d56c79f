"""PyTorch port models against the JAX package, on the CPU, at `tiny_config`.

One JAX parameter tree (f32, seeded) feeds both packages: the port loads it
through the weight bridge (`models/convert.py`). Inputs are seeded numpy
arrays. Tolerance atol = rtol = 1e-4: sums run in another order over up to 22
ViT layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vis_zephyr_tpu.config import tiny_config
from vis_zephyr_tpu.constants import IMAGE_TOKEN_INDEX
from vis_zephyr_tpu.models import clip_vit as jclip
from vis_zephyr_tpu.models import fusion as jfusion
from vis_zephyr_tpu.models import hf_convert
from vis_zephyr_tpu.models import mistral as jmistral
from vis_zephyr_tpu.models import qformer as jqformer
from vis_zephyr_tpu.models import vis_zephyr as jvz
from vis_zephyr_tpu.ops import splice as jsplice
from vis_zephyr_tpu_torch.models import clip_vit as tclip
from vis_zephyr_tpu_torch.models import fusion as tfusion
from vis_zephyr_tpu_torch.models import mistral as tmistral
from vis_zephyr_tpu_torch.models import vis_zephyr as tvz
from vis_zephyr_tpu_torch.models.convert import state_dict_from_jax
from vis_zephyr_tpu_torch.ops import splice as tsplice
from torch_port_util import port_config

TOL = dict(atol=1e-4, rtol=1e-4)
CFG = tiny_config(vocab_size=256)
TCFG = port_config(CFG)  # the port's own dataclasses, field for field

# The JAX side runs jitted: one compile is far cheaper than op-by-op dispatch.
j_init = jax.jit(jvz.init_vis_zephyr, static_argnums=(0,))
j_clip = jax.jit(jclip.clip_vit_forward, static_argnums=(2,))
j_qformer = jax.jit(jqformer.qformer_forward, static_argnums=(2,))
j_mistral = jax.jit(jmistral.mistral_forward, static_argnums=(2,),
                    static_argnames=("logits_slice", "return_kv"))
j_forward = jax.jit(jvz.vis_zephyr_forward, static_argnums=(4,))
j_splice = jax.jit(jsplice.splice_image_tokens, static_argnames=("max_length", "pad_to_multiple"))


@pytest.fixture(scope="module")
def models():
    params = jax.tree_util.tree_map(np.asarray, j_init(CFG, jax.random.PRNGKey(0)))
    port = tvz.VisZephyr(TCFG)
    port.load_state_dict(state_dict_from_jax(params, TCFG), strict=True)
    return params, port.requires_grad_(False).eval()


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _images(rng, n):
    s = CFG.vision.image_size
    return rng.standard_normal((n, s, s, 3)).astype(np.float32)


@pytest.mark.parametrize("part", ["vision", "projector", "decoder"])
def test_weight_bridge_round_trip(models, part):
    """hf_convert reads the port's state_dict() back into the JAX params."""
    params, port = models
    convert = {"vision": (hf_convert.convert_clip_vision, CFG.vision),
               "projector": (hf_convert.convert_qformer, CFG.projector),
               "decoder": (hf_convert.convert_mistral, CFG.decoder)}[part]
    back = convert[0](getattr(port, part).state_dict(), convert[1])
    want_leaves, want_tree = jax.tree_util.tree_flatten(params[part])
    got_leaves, got_tree = jax.tree_util.tree_flatten(back)
    assert got_tree == want_tree
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(np.asarray(g), w)


def test_clip_all_hidden_states(models):
    params, port = models
    images = _images(np.random.default_rng(0), 2)
    want = j_clip(params["vision"], jnp.asarray(images), CFG.vision)
    got = port.vision(_t(images))
    assert got.shape == (CFG.vision.num_layers + 1, 2, CFG.vision.tokens_per_image + 1,
                         CFG.vision.hidden_size)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(tclip.select_and_stack(got, TCFG.vision)),
                               np.asarray(jclip.select_and_stack(want, CFG.vision)), **TOL)


def test_fusion(models):
    stacked = np.random.default_rng(1).standard_normal((21, 2, 16, 32)).astype(np.float32)
    want = jfusion.dense_channel_fusion(jnp.asarray(stacked), 4)
    got = tfusion.dense_channel_fusion(_t(stacked), 4)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_qformer_text_conditioning(models, masked):
    params, port = models
    rng = np.random.default_rng(2)
    P = CFG.projector
    visual = rng.standard_normal((2, 16, P.visual_hidden_size)).astype(np.float32)
    text = rng.standard_normal((2, 5, P.hidden_size)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], bool) if masked else None
    want = j_qformer(params["projector"], jnp.asarray(visual), P,
                     text_embeddings=jnp.asarray(text),
                     text_mask=None if mask is None else jnp.asarray(mask))
    got = port.projector(_t(visual), _t(text), None if mask is None else _t(mask))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def _splice_inputs(rng):
    B, T, N, D = 2, 9, 12, 8
    ids = rng.integers(3, 200, (B, T)).astype(np.int64)
    ids[0, 2] = IMAGE_TOKEN_INDEX
    ids[1, 0] = IMAGE_TOKEN_INDEX
    text_valid = np.ones((B, T), bool)
    text_valid[1, 6:] = False
    num = np.array([8, 12], np.int32)
    text = rng.standard_normal((B, T, D)).astype(np.float32)
    image = rng.standard_normal((B, N, D)).astype(np.float32)
    return ids, text, image, num, text_valid


@pytest.mark.parametrize("max_length,pad_to_multiple", [
    (None, None), (None, 128), (14, None), (14, 128)])
def test_splice(max_length, pad_to_multiple):
    ids, text, image, num, valid = _splice_inputs(np.random.default_rng(3))
    want = j_splice(jnp.asarray(ids), jnp.asarray(text), jnp.asarray(image), jnp.asarray(num),
                    text_valid=jnp.asarray(valid), max_length=max_length,
                    pad_to_multiple=pad_to_multiple)
    got = tsplice.splice_image_tokens(_t(ids), _t(text), _t(image), _t(num), text_valid=_t(valid),
                                      max_length=max_length, pad_to_multiple=pad_to_multiple)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(_np(got[key]), np.asarray(want[key]), err_msg=key)


def test_compact_text_ids():
    ids, _, _, _, valid = _splice_inputs(np.random.default_rng(4))
    want = jsplice.compact_text_ids(jnp.asarray(ids), 2, text_valid=jnp.asarray(valid))
    got = tsplice.compact_text_ids(_t(ids), 2, text_valid=_t(valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def _decoder_inputs(rng, B=2, T=10):
    ids = rng.integers(0, CFG.decoder.vocab_size, (B, T))
    valid = np.ones((B, T), bool)
    valid[1, 7:] = False
    positions = np.where(valid, np.cumsum(valid, 1) - 1, 0).astype(np.int32)
    return ids, valid, positions


def test_mistral_prefill_logits_and_kv(models):
    params, port = models
    ids, valid, positions = _decoder_inputs(np.random.default_rng(5))
    emb = np.asarray(jmistral.embed(params["decoder"], jnp.asarray(ids)))
    want, (wk, wv) = j_mistral(params["decoder"], jnp.asarray(emb), CFG.decoder,
                               jnp.asarray(positions), attn_valid=jnp.asarray(valid),
                               return_kv=True)
    got, (gk, gv) = tmistral.mistral_forward(port.decoder, _t(emb), TCFG.decoder, _t(positions),
                                             attn_valid=_t(valid), return_kv=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(gk), np.asarray(wk), **TOL)
    np.testing.assert_allclose(_np(gv), np.asarray(wv), **TOL)


def test_mistral_dense_cache_decode(models):
    """Prefill into a dense cache, then 4 single-token decode steps."""
    params, port = models
    rng = np.random.default_rng(6)
    ids, valid, positions = _decoder_inputs(rng)
    B, T, S = ids.shape[0], ids.shape[1], 32
    emb = np.asarray(jmistral.embed(params["decoder"], jnp.asarray(ids)))
    _, (k, v) = j_mistral(params["decoder"], jnp.asarray(emb), CFG.decoder,
                          jnp.asarray(positions), attn_valid=jnp.asarray(valid), return_kv=True)
    pad = ((0, 0), (0, 0), (0, S - T), (0, 0), (0, 0))
    k0, v0 = np.pad(np.asarray(k), pad), np.pad(np.asarray(v), pad)
    lengths = valid.sum(1).astype(np.int32)
    jcache = {"k": jnp.asarray(k0), "v": jnp.asarray(v0), "length": jnp.asarray(lengths)}
    tcache = {"k": _t(k0.copy()), "v": _t(v0.copy()), "length": _t(lengths.copy())}
    for _ in range(4):
        tok = rng.integers(0, CFG.decoder.vocab_size, (B, 1))
        e = np.asarray(jmistral.embed(params["decoder"], jnp.asarray(tok)))
        want, jcache = j_mistral(params["decoder"], jnp.asarray(e), CFG.decoder,
                                 jcache["length"][:, None], cache=jcache, logits_slice="last")
        got, tcache = tmistral.mistral_forward(port.decoder, _t(e), TCFG.decoder,
                                               tcache["length"][:, None], cache=tcache,
                                               logits_slice="last")
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_array_equal(_np(tcache["length"]), np.asarray(jcache["length"]))
    np.testing.assert_allclose(_np(tcache["k"]), np.asarray(jcache["k"]), **TOL)
    np.testing.assert_allclose(_np(tcache["v"]), np.asarray(jcache["v"]), **TOL)


def test_vis_zephyr_forward(models):
    params, port = models
    rng = np.random.default_rng(7)
    B, T, P = 2, 8, 4
    ids = rng.integers(3, CFG.decoder.vocab_size, (B, T))
    ids[:, 1] = IMAGE_TOKEN_INDEX
    text_valid = np.ones((B, T), bool)
    text_valid[1, 6:] = False
    images = _images(rng, B * P).reshape((B, P) + _images(rng, 1).shape[1:])
    patch_valid = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
    want, waux = j_forward(params, jnp.asarray(ids), jnp.asarray(images),
                           jnp.asarray(patch_valid), CFG, text_valid=jnp.asarray(text_valid))
    got, gaux = tvz.vis_zephyr_forward(port, _t(ids), _t(images), _t(patch_valid), TCFG,
                                       text_valid=_t(text_valid))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for key in ("valid", "positions", "lengths"):
        np.testing.assert_array_equal(_np(gaux[key]), np.asarray(waux[key]), err_msg=key)


@pytest.mark.parametrize("form", ["port", "orbax"])
def test_builder_names_the_checkpoint_form(form, tmp_path):
    """A model directory with a `state/` is refused under its true form:
    the port trainer's own `state/state.pt` (written here by
    `train/checkpoints.py::save_checkpoint`) by that name, pointing to the
    roadmap steps that will load it; a directory orbax wrote as orbax."""
    from vis_zephyr_tpu_torch.models.builder import load_pretrained_model
    from vis_zephyr_tpu_torch.train import checkpoints as tckpt

    if form == "port":
        layer = torch.nn.Linear(2, 2)
        model_dir = tckpt.save_checkpoint(
            str(tmp_path), {"params": layer, "step": 1,
                            "opt_state": torch.optim.SGD(layer.parameters(), lr=0.1)}, step=1)
        match = r"the port trainer's own checkpoint .*state\.pt.*Queue A steps 1 and 5"
    else:
        (tmp_path / "model" / "state").mkdir(parents=True)
        (tmp_path / "model" / "state" / "_CHECKPOINT_METADATA").write_text("{}")
        model_dir = str(tmp_path / "model")
        match = "is a native orbax checkpoint"
    with pytest.raises(NotImplementedError, match=match) as refused:
        load_pretrained_model(model_dir, device="cpu")
    assert ("orbax" in str(refused.value)) == (form == "orbax")


def test_builder_loads_hf_layout(models, tmp_path):
    """`load_pretrained_model`'s HF path: a safetensors decoder, a torch .bin
    CLIP tower with HF's prefix and unused keys, and a prefixed
    mm_projector.bin load back into the same weights."""
    from safetensors.torch import save_file

    from vis_zephyr_tpu_torch.models.builder import load_pretrained_model

    _, port = models
    base, tower, model_dir = (tmp_path / name for name in ("base", "tower", "model"))
    for d in (base, tower, model_dir):
        d.mkdir()
    save_file({k: v.contiguous() for k, v in port.decoder.state_dict().items()},
              str(base / "model.safetensors"))
    vision = {f"vision_model.{k}": v for k, v in port.vision.state_dict().items()}
    vision["vision_model.post_layernorm.weight"] = torch.ones(CFG.vision.hidden_size)
    torch.save(vision, tower / "pytorch_model.bin")
    torch.save({f"model.mm_projector.{k}": v for k, v in port.projector.state_dict().items()},
               model_dir / "mm_projector.bin")
    (model_dir / "config.json").write_text(CFG.to_json())

    _, loaded, cfg, context_len = load_pretrained_model(
        str(model_dir), model_base=str(base), vision_tower_path=str(tower),
        dtype=torch.float32, device="cpu")
    assert cfg == TCFG and context_len == CFG.tokenizer_model_max_length
    want = port.state_dict()
    got = loaded.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
