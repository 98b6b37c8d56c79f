"""Visual prompting (ViP): alpha-blended shape overlays + entity-tag text
rewriting for VCR-style region-grounded data.

Reference subsystem: `vis_zephyr/model/vip_processor/` (C9-C13 in SURVEY §2).
This rebuild is dependency-light: polygon math that the reference delegates
to shapely/scipy (point containment, bounds, gaussian/uniform in-polygon
sampling) is implemented in numpy (`geometry.py`), rasterization uses PIL,
and all randomness flows through an explicit seeded `random.Random` so
train-time augmentation is reproducible.

The port's own copy of the JAX package's `vis_zephyr_tpu/data/vip/`: the same
code, imported without JAX (`tests/test_torch_imports.py` holds each function
to its original).
"""

from .processor import supports, visual_prompt_process
from .config import VIP_TRAIN_STYLES, VIP_TEST_STYLES, COLOR_POOL
