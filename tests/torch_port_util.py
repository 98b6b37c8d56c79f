"""Shared helpers of the `tests/test_torch_*.py` files.

The PyTorch port keeps its own config dataclasses; the tests build the JAX
package's config and rebuild the port's from it field by field, so both
packages run the same model. The paged batchers' scripted drive and state
snapshots (`drive`, `jax_snapshot`, `port_snapshot`, `assert_same_state`)
serve the paged serving and prefix-cache tests. `one_torch_thread` is the
autouse fixture that every port test file imports.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from vis_zephyr_tpu_torch import config as tconfig
from vis_zephyr_tpu_torch.ops import paged_attention as tpa


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread while a port test module runs. The suite
    runs several pytest workers on a few cores, and each worker's default
    pool (a thread a core) oversubscribes them: tiny models' small ops then
    spend their time waiting for threads. A module imports this fixture to
    take it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_config(jax_cfg) -> tconfig.VisZephyrConfig:
    """The port's `VisZephyrConfig` with every field of the JAX package's."""
    raw = dataclasses.asdict(jax_cfg)
    return tconfig.VisZephyrConfig(
        vision=tconfig.VisionConfig(**raw.pop("vision")),
        projector=tconfig.ProjectorConfig(**raw.pop("projector")),
        decoder=tconfig.DecoderConfig(**raw.pop("decoder")),
        **raw,
    )


def jax_params_numpy(jax_cfg, seed: int):
    """Random JAX-package parameters as a tree of numpy arrays."""
    from vis_zephyr_tpu.models.vis_zephyr import init_vis_zephyr

    init = jax.jit(init_vis_zephyr, static_argnums=(0,))
    return jax.tree_util.tree_map(np.asarray, init(jax_cfg, jax.random.PRNGKey(seed)))


def port_model(params, jax_cfg):
    """The port's `VisZephyr` carrying the JAX parameters `params`."""
    from vis_zephyr_tpu_torch.models.convert import state_dict_from_jax
    from vis_zephyr_tpu_torch.models.vis_zephyr import VisZephyr

    tcfg = port_config(jax_cfg)
    model = VisZephyr(tcfg)
    model.load_state_dict(state_dict_from_jax(params, tcfg), strict=True)
    return model.requires_grad_(False).eval()


def word_list(vocab_size: int):
    """"<s>", "</s>", "<unk>", "<image>", then "w0", "w1", ...: `vocab_size` words."""
    return ["<s>", "</s>", "<unk>", "<image>"] + [f"w{i}" for i in range(vocab_size - 4)]


def word_tokenizer(words):
    """An offline HF fast tokenizer of whole words (ids 0..len(words)-1), with
    HF's added-token machinery (`add_tokens`, `len`), saved and reloaded like
    a downloaded one."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    return PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>", eos_token="</s>",
                                   pad_token="</s>", unk_token="<unk>", model_max_length=512)


def assert_state_matches(got: dict, want: dict, **tol):
    """Two state dicts with the same keys and shapes, values within `tol`
    (numpy's `assert_allclose` keywords), compared in f32."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for key, value in want.items():
        assert got[key].shape == value.shape, key
        np.testing.assert_allclose(got[key].float().numpy(), value.float().numpy(),
                                   err_msg=key, **tol)


def drive(batcher, requests, snapshot, max_steps=200):
    """Run a scripted scenario, [(ids, images, patch_valid, max_new_tokens,
    submit before step N)], through either package's paged batcher; returns
    (tokens per request, snapshots before each step, snapshots after each
    step)."""
    handles = {}
    before, after = [], []
    for step in range(max_steps):
        for i, (ids, images, valid, max_new, at) in enumerate(requests):
            if at == step:
                handles[i] = batcher.submit(ids, images, valid, max_new_tokens=max_new)
        if len(handles) == len(requests) and not batcher.has_work:
            break
        before.append(snapshot(batcher))
        batcher.step()
        after.append(snapshot(batcher))
    assert not batcher.has_work
    return [list(batcher.stream(handles[i])) for i in range(len(requests))], before, after


def jax_snapshot(b):
    """A JAX paged batcher's pools, scales, table, lengths, tokens and active set."""
    return dict(pools=tuple(None if a is None else np.asarray(a)
                            for a in (b.kp, b.vp, b.ksp, b.vsp)),
                table=np.asarray(b.page_table), lengths=np.asarray(b.lengths),
                token=np.asarray(b.token), active=b.active.copy())


def port_snapshot(b):
    """The port's paged batcher's state as `jax_snapshot` gives it (the pools
    through the layout converters)."""
    pools = tpa.pools_to_jax_layout(*(None if a is None else a.numpy().copy()
                                      for a in (b.kp, b.vp, b.ksp, b.vsp)))
    return dict(pools=pools, table=b.page_table.numpy().copy(),
                lengths=b.lengths.numpy().copy(), token=b.token.numpy().copy(),
                active=b.active.copy())


def assert_same_state(got, want, where):
    """Table, lengths, active set and tokens equal; f32 pools and scales to
    1e-4; int8 values within 1 and almost all equal (the two frameworks' f32
    matmuls round differently through the layers, which can move a value
    across a rounding boundary)."""
    np.testing.assert_array_equal(got["table"], want["table"], err_msg=where)
    np.testing.assert_array_equal(got["lengths"], want["lengths"], err_msg=where)
    np.testing.assert_array_equal(got["active"], want["active"], err_msg=where)
    np.testing.assert_array_equal(got["token"], want["token"], err_msg=where)
    for name, g, w in zip(("k_pages", "v_pages", "k_scales", "v_scales"),
                          got["pools"], want["pools"]):
        assert (g is None) == (w is None), (where, name)
        if g is None:
            continue
        if g.dtype == np.int8:
            diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1 and (diff != 0).mean() < 1e-3, (where, name, diff.max())
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=f"{where} {name}")
