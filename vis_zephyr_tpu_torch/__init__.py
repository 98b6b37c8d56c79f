"""vis_zephyr_tpu_torch — the PyTorch / CUDA port of vis_zephyr_tpu for one
NVIDIA H100.

The JAX package `vis_zephyr_tpu` stays the reference. This package mirrors
its module names (`models/mistral.py` ↔ `models/mistral.py`), imports
`torch` and never `jax`, and reuses the JAX package's framework-free modules
(`config`, `constants`, `conversation`, `data/anyres`, `data/tokenization`).
Parameters carry HF state-dict names, so `vis_zephyr_tpu/models/hf_convert.py`
reads the port's `state_dict()` as it is.

Every Pallas kernel on the ported path has a hand-written CUDA counterpart
in `csrc/`, built with nvcc for sm_90a at first use (`ops/_kernels.py`).
"""

__version__ = "0.1.0"
