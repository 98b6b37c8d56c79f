"""Any-resolution (anyres) tiling geometry — pure integer math, host-side.

These functions decide how a variable-resolution image is mapped onto a grid
of fixed-size vision-encoder crops. They are deterministic and golden-tested.

Behavioral parity: reference `vis_zephyr/model/multi_scale_process.py`:
- `select_best_fit_resolution`  (:29-68)
- `resize_pad_geometry`         (:71-95, geometry portion of resize_pad_image)
- `tile_boxes`                  (:98-114, divide_to_patches crop boxes)
- `calculate_grid_shape`        (:117-133)
- `unpad_slice`                 (:188-211, geometry portion of unpad_image)

The port's own copy of the JAX package's `data/anyres.py`. The pixel work
itself (resize / pad / normalize) lives in `data/image_pipeline.py`: the
host picks the grid, the device does fixed-shape tensor work.
"""

from __future__ import annotations

import ast
from typing import List, Sequence, Tuple

# Default grid pinpoints used by the released checkpoint
# (reference `script/pretrain.sh:24`, `checkpoints/.../config.json`).
DEFAULT_GRID_PINPOINTS: List[Tuple[int, int]] = [
    (336, 672),
    (672, 336),
    (336, 1008),
    (1008, 336),
]


def robust_literal_eval(value):
    """Evaluate a (possibly repeatedly quoted) string literal.

    Shell scripts pass grid pinpoints as e.g. ``"'[[336, 672]]'"``; peel
    string layers until a non-string results (reference
    `multi_scale_process.py:12-26`).
    """
    result = value
    while isinstance(result, str):
        try:
            result = ast.literal_eval(result)
        except (ValueError, SyntaxError):
            return result
    return result


def parse_grid_pinpoints(grid_pinpoints) -> List[Tuple[int, int]]:
    """Normalize a pinpoints spec (string or list) to a list of (w, h)."""
    if grid_pinpoints is None:
        return list(DEFAULT_GRID_PINPOINTS)
    parsed = robust_literal_eval(grid_pinpoints)
    if not isinstance(parsed, (list, tuple)):
        raise ValueError(f"grid_pinpoints did not evaluate to a list: {grid_pinpoints!r}")
    return [tuple(p) for p in parsed]


def select_best_fit_resolution(
    original_resolution: Tuple[int, int],
    possible_resolutions: Sequence[Tuple[int, int]],
) -> Tuple[int, int]:
    """Pick the candidate (w, h) that maximizes effective resolution and,
    among ties, minimizes wasted padding area.

    "Effective resolution" is the area of the image after fit-within scaling
    into the candidate, capped at the original area; "waste" is the candidate
    area not covered by the scaled image.
    """
    ow, oh = original_resolution
    best = None
    best_effective = 0
    best_waste = float("inf")
    for w, h in possible_resolutions:
        scale = min(w / ow, h / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        effective = min(dw * dh, ow * oh)
        waste = w * h - effective
        if effective > best_effective or (effective == best_effective and waste < best_waste):
            best_effective = effective
            best_waste = waste
            best = (w, h)
    if best is None:
        raise ValueError("possible_resolutions is empty")
    return best


def resize_pad_geometry(
    original_size: Tuple[int, int], target_size: Tuple[int, int]
) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Geometry of fit-within resize + center pad.

    Returns ``((new_w, new_h), (paste_x, paste_y))``: the scaled image size
    and the top-left offset at which it is pasted onto the target canvas.
    """
    ow, oh = original_size
    tw, th = target_size
    scale = min(tw / ow, th / oh)
    nw, nh = int(ow * scale), int(oh * scale)
    return (nw, nh), ((tw - nw) // 2, (th - nh) // 2)


def tile_boxes(image_size: Tuple[int, int], patch_size: int) -> List[Tuple[int, int, int, int]]:
    """Non-overlapping ``patch_size`` crop boxes covering the image,
    row-major (top-to-bottom, left-to-right). Boxes are (left, top, right,
    bottom)."""
    w, h = image_size
    boxes = []
    for top in range(0, h, patch_size):
        for left in range(0, w, patch_size):
            boxes.append((left, top, left + patch_size, top + patch_size))
    return boxes


def calculate_grid_shape(
    image_size: Tuple[int, int], grid_pinpoints, patch_size: int
) -> Tuple[int, int]:
    """(num_tiles_wide, num_tiles_tall) of the best-fit grid for an image."""
    possible = parse_grid_pinpoints(grid_pinpoints)
    w, h = select_best_fit_resolution(image_size, possible)
    return w // patch_size, h // patch_size


def num_anyres_patches(image_size: Tuple[int, int], grid_pinpoints, patch_size: int) -> int:
    """Total encoder forwards for one anyres image: 1 global + the tiles."""
    gw, gh = calculate_grid_shape(image_size, grid_pinpoints, patch_size)
    return 1 + gw * gh


def max_anyres_patches(grid_pinpoints, patch_size: int) -> int:
    """Static upper bound on patches per image for a pinpoint set — used to
    pick padded batch shapes."""
    best = 1
    for w, h in parse_grid_pinpoints(grid_pinpoints):
        best = max(best, 1 + (w // patch_size) * (h // patch_size))
    return best


def unpad_slice(
    original_size: Tuple[int, int], current_size: Tuple[int, int]
) -> Tuple[slice, slice]:
    """Slices (over width, height) that crop a letterboxed feature map back
    to the original aspect ratio.

    ``current_size`` is the (w, h) of the padded map. Returns
    ``(w_slice, h_slice)`` to be applied to the corresponding axes.
    """
    ow, oh = original_size
    cw, ch = current_size
    if ow / oh > cw / ch:
        # Original wider: vertical padding was added.
        new_h = int(oh * (cw / ow))
        pad = (ch - new_h) // 2
        return slice(None), slice(pad, ch - pad)
    new_w = int(ow * (ch / oh))
    pad = (cw - new_w) // 2
    return slice(pad, cw - pad), slice(None)
