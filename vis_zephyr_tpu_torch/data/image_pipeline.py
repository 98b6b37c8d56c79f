"""Host image preprocessing: anyres tiling + CLIP normalization (numpy + PIL).

Port of the host half of `vis_zephyr_tpu/data/image_pipeline.py`
(`anyres_preprocess_host`, `preprocess_mode_host`), on top of the JAX
package's jax-free `data/anyres` geometry. PIL is imported inside the
functions only, so the module imports where PIL is absent.

Output contract for one image: `pixels [P_max, S, S, 3]` float32 (NHWC,
normalized; slot 0 = global LANCZOS-resized image, then row-major tiles,
then zero padding) and `patch_valid [P_max]` bool.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from vis_zephyr_tpu.data import anyres

# OpenAI CLIP normalization constants (CLIPImageProcessor defaults).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _normalize(arr: np.ndarray) -> np.ndarray:
    return (arr - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(CLIP_STD, np.float32)


def anyres_preprocess_host(
    pil_image,
    grid_pinpoints,
    target_size: int = 336,
    max_patches: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """PIL LANCZOS resize, black pad to the best-fit canvas, tile, CLIP
    normalize. Returns (pixels [P_max, S, S, 3], patch_valid [P_max])."""
    from PIL import Image

    pinpoints = anyres.parse_grid_pinpoints(grid_pinpoints)
    if max_patches is None:
        max_patches = anyres.max_anyres_patches(pinpoints, target_size)

    best_fit = anyres.select_best_fit_resolution(pil_image.size, pinpoints)
    (nw, nh), (px, py) = anyres.resize_pad_geometry(pil_image.size, best_fit)
    resized = pil_image.resize((nw, nh), Image.Resampling.LANCZOS)
    canvas = Image.new("RGB", best_fit, (0, 0, 0))
    canvas.paste(resized, (px, py))

    crops = [canvas.crop(box) for box in anyres.tile_boxes(best_fit, target_size)]
    global_view = pil_image.resize((target_size, target_size), Image.Resampling.LANCZOS)
    patches = [global_view] + crops

    arr = _normalize(np.stack([np.asarray(p, dtype=np.float32) / 255.0 for p in patches]))
    n = arr.shape[0]
    out = np.zeros((max_patches,) + arr.shape[1:], np.float32)
    out[:n] = arr
    return out, np.arange(max_patches) < n


def expand2square_host(pil_image, background_color):
    """Pad to a square with a background color."""
    from PIL import Image

    w, h = pil_image.size
    if w == h:
        return pil_image
    side = max(w, h)
    result = Image.new(pil_image.mode, (side, side), background_color)
    result.paste(pil_image, ((side - w) // 2, (side - h) // 2))
    return result


def preprocess_mode_host(pil_image, mode: str, target_size: int = 336) -> np.ndarray:
    """Non-anyres modes: 'pad' → expand2square(mean color); 'resize' →
    direct resize; 'square' → center crop to the short side. Then
    CLIPImageProcessor: shortest edge → target (bicubic), center crop,
    normalize. Returns [S, S, 3]."""
    from PIL import Image

    if mode == "pad":
        img = expand2square_host(pil_image, tuple(int(x * 255) for x in CLIP_MEAN))
    elif mode == "square":
        w, h = pil_image.size
        s = min(w, h)
        left, top = (w - s) // 2, (h - s) // 2
        img = pil_image.crop((left, top, left + s, top + s))
    else:
        img = pil_image

    w, h = img.size
    scale = target_size / min(w, h)
    img = img.resize((max(1, round(w * scale)), max(1, round(h * scale))),
                     Image.Resampling.BICUBIC)
    w, h = img.size
    left, top = (w - target_size) // 2, (h - target_size) // 2
    img = img.crop((left, top, left + target_size, top + target_size))
    return _normalize(np.asarray(img, dtype=np.float32) / 255.0)
