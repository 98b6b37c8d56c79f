"""Export a JAX model dir (orbax `state/`) to the PyTorch port's checkpoint form.

The PyTorch port reads the `torch.save` layout its trainer writes
(`state/state.pt`) and refuses an orbax `state/`, since orbax does not run
where the port serves. This script restores the orbax dir with the JAX
package's builder (`vis_zephyr_tpu/models/builder.py::load_pretrained_model`:
a params-only or full train state, LoRA adapters merged, the image-token
alignment applied where the config asks for it), maps the parameters with the
port's weight bridge (`vis_zephyr_tpu_torch/models/convert.py::
state_dict_from_jax`) and writes `OUT/state/state.pt` ({"params": state
dict}, float32) beside a copy of every other file of the model dir (`config.json`,
the tokenizer files). It imports both packages, as the tests do, and changes
nothing in the source dir.

    VZT_PLATFORM=cpu python scripts/export_orbax_to_torch.py \\
        --model-path JAX_MODEL_DIR --out PORT_MODEL_DIR

Then serve the export with the port, e.g.
`python -m vis_zephyr_tpu_torch.serve.cli --model-path PORT_MODEL_DIR
--image-file demo.jpg --device cpu`.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def export(model_path: str, out: str) -> str:
    """Write the port's checkpoint of `model_path` into `out`; returns the
    path of the written `state.pt`."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from vis_zephyr_tpu.models.builder import load_pretrained_model
    from vis_zephyr_tpu_torch.config import VisZephyrConfig
    from vis_zephyr_tpu_torch.models.convert import state_dict_from_jax

    _, params, jcfg, _ = load_pretrained_model(model_path, dtype=jnp.float32)
    missing = {"vision", "projector", "decoder"} - set(params)
    if missing:
        raise ValueError(f"{model_path}: the checkpoint has no {sorted(missing)} parameters")
    params = jax.tree_util.tree_map(np.asarray, params)
    sd = state_dict_from_jax(params, VisZephyrConfig.from_json(jcfg.to_json()))

    os.makedirs(out, exist_ok=True)
    for name in os.listdir(model_path):
        src = os.path.join(model_path, name)
        if name != "state" and os.path.isfile(src):
            shutil.copy2(src, os.path.join(out, name))
    os.makedirs(os.path.join(out, "state"), exist_ok=True)
    path = os.path.join(out, "state", "state.pt")
    torch.save({"params": sd}, path)
    return path


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model-path", required=True, help="a JAX model dir: state/ (orbax), "
                   "config.json and tokenizer files")
    p.add_argument("--out", required=True, help="the port's model dir to write")
    a = p.parse_args(argv)
    path = export(a.model_path, a.out)
    print(f"wrote {path} ({os.path.getsize(path) / 2**20:.1f} MiB)")


if __name__ == "__main__":
    main()
