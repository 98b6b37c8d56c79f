"""Framework-wide constants (the port's own copy of the JAX package's
`constants.py`).

Parity surface: reference `vis_zephyr/constants.py:5-20` (the vestigial
LLaVA controller-heartbeat constants are intentionally dropped — nothing in
the reference consumes them).
"""

# Label value ignored by the cross-entropy loss.
IGNORE_INDEX = -100

# Sentinel token id marking an image placeholder inside a token sequence.
# Negative so it can never collide with a real vocab id.
IMAGE_TOKEN_INDEX = -200

# Text-side placeholder strings.
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"
IMAGE_PLACEHOLDER = "<image-placeholder>"
