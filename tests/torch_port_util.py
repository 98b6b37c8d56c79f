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
