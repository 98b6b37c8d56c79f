"""Shape rasterizers + alpha compositing for visual prompts.

Eight primitives drawn onto an RGBA overlay then alpha-composited
(reference `vis_zephyr/model/vip_processor/shape_draw.py:14-260` +
`conversation_generator.py:13-148`). All randomness flows through an
explicit `random.Random`. Line widths scale with
`max_image_size / image_size_anchor` exactly like the reference so overlay
thickness is resolution-invariant.

The port's own copy of the JAX package's `vis_zephyr_tpu/data/vip/draw.py`:
the same code, imported without JAX (`tests/test_torch_imports.py` holds each
function to its original).
"""

from __future__ import annotations

import math
import random
from typing import Optional, Sequence, Tuple

from .geometry import (
    PolygonSet,
    cubic_bezier,
    gaussian_point_in_polygon,
    max_angle_below,
    uniform_point_in_bbox,
    uniform_point_in_polygon,
)


def _rand_point(poly: Optional[PolygonSet], bbox, rng):
    if poly is not None:
        return uniform_point_in_polygon(poly, rng)
    return uniform_point_in_bbox(bbox, rng)


def draw_arrow(canvas, bbox, color, line_width, rng, max_arrow_length=100,
               max_image_size=336, anchor=336):
    left, top, right, bottom = bbox
    cx = (left + right) / 2 + rng.uniform(-0.25, 0.25) * (right - left)
    cy = (top + bottom) / 2 + rng.uniform(-0.25, 0.25) * (bottom - top)

    side = min(right - left, bottom - top)
    length = rng.uniform(0.8 * side, max(max_arrow_length, 0.8 * side + 1e-6))
    angle = rng.uniform(0, 2 * math.pi)
    head = max(rng.uniform(0.2, 0.5) * length, int(6 * max_image_size / anchor))

    end_x = cx + (length - head) * math.cos(angle)
    end_y = cy + (length - head) * math.sin(angle)

    if rng.random() < 0.5:  # hand-drawn wobble through a midpoint
        scale = int(max_image_size / anchor)
        mid = ((cx + end_x) / 2 + rng.uniform(-5, 5) * scale,
               (cy + end_y) / 2 + rng.uniform(-5, 5) * scale)
        canvas.line([(cx, cy), mid, (end_x, end_y)], fill=color, width=line_width)
    else:
        canvas.line([(cx, cy), (end_x, end_y)], fill=color, width=line_width)

    # Head sits at the (jittered) center, pointing back along the shaft.
    tip = [
        (cx + head * math.cos(angle + math.pi / 3), cy + head * math.sin(angle + math.pi / 3)),
        (cx, cy),
        (cx + head * math.cos(angle - math.pi / 3), cy + head * math.sin(angle - math.pi / 3)),
    ]
    if rng.random() < 0.5:
        canvas.polygon(tip, fill=color)
    else:
        canvas.line(tip, fill=color, width=line_width)


def draw_rectangle(canvas, bbox, color, line_width):
    left, top, right, bottom = bbox
    canvas.rectangle([(left, top), (right, bottom)], outline=color, width=line_width)


def draw_ellipse(canvas, bbox, poly: Optional[PolygonSet], color, line_width,
                 size_ratio=1.0, aspect_ratio=1.0):
    min_x, min_y, max_x, max_y = poly.bounds if poly is not None else bbox
    cx, cy = (min_x + max_x) / 2, (min_y + max_y) / 2
    w = (max_x - min_x) * size_ratio * aspect_ratio
    h = (max_y - min_y) * size_ratio / aspect_ratio
    canvas.ellipse([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                   outline=color, width=line_width)


def draw_point(canvas, bbox, poly: Optional[PolygonSet], color, rng,
               radius=3, aspect_ratio=1.0):
    bounds = poly.bounds if poly is not None else bbox
    x, y = gaussian_point_in_polygon(poly, bounds, rng)
    rx, ry = radius * aspect_ratio, radius / aspect_ratio
    canvas.ellipse([x - rx, y - ry, x + rx, y + ry], fill=color, outline=color)


def draw_scribble(canvas, bbox, poly: Optional[PolygonSet], color, line_width, rng,
                  max_image_size=336, anchor=336):
    pts = [_rand_point(poly, bbox, rng) for _ in range(4)]
    curve = cubic_bezier(*pts, num=int(1000 * max_image_size / anchor))
    for a, b in zip(curve[:-1], curve[1:]):
        canvas.line([tuple(a), tuple(b)], fill=color, width=line_width)


def _bbox_ring(bbox) -> Sequence[Sequence[float]]:
    l, t, r, b = bbox
    return [[l, t, l, b, r, b, r, t]]


def draw_mask_contour(canvas, bbox, segmentations, color, width=1):
    segs = segmentations if segmentations is not None else _bbox_ring(bbox)
    for seg in segs:
        coords = [(seg[i], seg[i + 1]) for i in range(0, len(seg), 2)]
        for dx in range(-width, width + 1):
            for dy in range(-width, width + 1):
                canvas.polygon([(x + dx, y + dy) for x, y in coords], outline=color)


def draw_mask(canvas, bbox, segmentations, color):
    segs = segmentations if segmentations is not None else _bbox_ring(bbox)
    for seg in segs:
        coords = [(seg[i], seg[i + 1]) for i in range(0, len(seg), 2)]
        canvas.polygon(coords, outline=None, fill=color)


def draw_triangle(canvas, bbox, poly: Optional[PolygonSet], color, line_width, rng,
                  max_attempts=100):
    for _ in range(max_attempts):
        pts = [_rand_point(poly, bbox, rng) for _ in range(3)]
        if max_angle_below(pts, 150.0):
            break
    canvas.line([pts[0], pts[1], pts[2], pts[0]], fill=color, width=line_width, joint="curve")


def blend_shape(
    image,
    shape: str,
    bbox: Optional[Tuple[float, float, float, float]],
    segmentations: Optional[Sequence[Sequence[float]]],
    rgb_color: Tuple[int, int, int],
    rng: random.Random,
    image_size_anchor: int = 336,
    line_style: Optional[str] = None,
    alpha: Optional[int] = None,
    width: Optional[float] = None,
):
    """Rasterize one shape on a transparent overlay and alpha-composite it
    (reference `conversation_generator.py:13-148` image_blending)."""
    from PIL import Image, ImageDraw

    image = image.convert("RGB")
    img_w, img_h = image.size
    m = max(img_w, img_h)  # max_image_size
    a = image_size_anchor

    overlay = Image.new("RGBA", (img_w, img_h), (0, 0, 0, 0))
    canvas = ImageDraw.Draw(overlay)

    if alpha is None:
        alpha = rng.randint(48, 128) if shape == "mask" else rng.randint(96, 255)
    color = tuple(rgb_color) + (alpha,)

    poly = None
    if segmentations:
        try:
            poly = PolygonSet.from_flat(segmentations)
        except (ValueError, IndexError):
            poly = None

    def scaled(lo, hi):
        if width is not None:
            return max(int(width * m / a), 1)
        return max(rng.randint(int(lo * m / a), int(hi * m / a)), 1)

    if shape == "rectangle":
        lw = max(int(3 * m / a), 1) if line_style == "constant" and width is None else scaled(2, 8)
        draw_rectangle(canvas, bbox, color, lw)
    elif shape == "ellipse":
        draw_ellipse(canvas, bbox, poly, color, scaled(2, 8),
                     size_ratio=rng.uniform(1, 1.5))
    elif shape == "arrow":
        draw_arrow(canvas, bbox, color, scaled(1, 6), rng,
                   max_arrow_length=max(int(50 * m / a), 1),
                   max_image_size=m, anchor=a)
    elif shape == "triangle":
        draw_triangle(canvas, bbox, poly, color, scaled(2, 8), rng)
    elif shape == "point":
        radius = (max(int(8 * m / a), 1) if line_style == "constant"
                  else max(rng.randint(int(5 * m / a), int(20 * m / a)), 1))
        ar = 1.0 if (line_style == "constant" or rng.random() < 0.5) else rng.uniform(0.5, 2.0)
        draw_point(canvas, bbox, poly, color, rng, radius=radius, aspect_ratio=ar)
    elif shape == "scribble":
        draw_scribble(canvas, bbox, poly, color, scaled(2, 12), rng,
                      max_image_size=m, anchor=a)
    elif shape == "mask contour":
        draw_mask_contour(canvas, bbox, segmentations, color, width=scaled(1, 2))
    elif shape == "mask":
        lw = rng.randint(0, int(2 * m / a)) if width is None else max(int(width * m / a), 1)
        del lw  # fill has no outline width; kept for RNG-stream parity
        draw_mask(canvas, bbox, segmentations, color)
    else:
        raise ValueError(f"unknown visual prompt shape: {shape}")

    out = Image.alpha_composite(image.convert("RGBA"), overlay)
    return out.convert("RGB")
