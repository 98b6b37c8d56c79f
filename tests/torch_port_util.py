"""Shared helpers of the `tests/test_torch_*.py` files.

The PyTorch port keeps its own config dataclasses; the tests build the JAX
package's config and rebuild the port's from it field by field, so both
packages run the same model.
"""

import dataclasses

import jax
import numpy as np

from vis_zephyr_tpu_torch import config as tconfig


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
