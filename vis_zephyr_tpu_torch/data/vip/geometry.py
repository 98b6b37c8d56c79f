"""Pure-numpy polygon geometry for ViP rasterization.

Replaces the reference's shapely/scipy usage
(`vis_zephyr/model/vip_processor/shape_draw.py:10-11, 219-260`):
`Polygon.bounds`, `Polygon.contains`, `unary_union` (only its bounds /
containment are ever consumed), gaussian point sampling
(`multivariate_normal.rvs`) and in-polygon rejection sampling.

The port's own copy of the JAX package's
`vis_zephyr_tpu/data/vip/geometry.py`: the same code, imported without JAX
(`tests/test_torch_imports.py` holds each function to its original).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np


class PolygonSet:
    """One or more simple polygons treated as a union (bounds + containment
    are the only queries the pipeline needs)."""

    def __init__(self, polygons: Sequence[np.ndarray]):
        # Each polygon: [N, 2] float array of vertices.
        self.polygons = [np.asarray(p, dtype=np.float64).reshape(-1, 2) for p in polygons]
        if not self.polygons:
            raise ValueError("empty polygon set")

    @classmethod
    def from_flat(cls, segmentations: Sequence[Sequence[float]]) -> "PolygonSet":
        """From flat [x0, y0, x1, y1, ...] coordinate lists."""
        return cls([np.asarray(s, np.float64).reshape(-1, 2) for s in segmentations])

    @property
    def bounds(self) -> Tuple[float, float, float, float]:
        mins = np.min([p.min(axis=0) for p in self.polygons], axis=0)
        maxs = np.max([p.max(axis=0) for p in self.polygons], axis=0)
        return float(mins[0]), float(mins[1]), float(maxs[0]), float(maxs[1])

    def contains(self, x: float, y: float) -> bool:
        return any(point_in_polygon(x, y, p) for p in self.polygons)

    def single(self, index: int) -> "PolygonSet":
        return PolygonSet([self.polygons[index]])

    def __len__(self):
        return len(self.polygons)


def point_in_polygon(x: float, y: float, polygon: np.ndarray) -> bool:
    """Even-odd rule ray casting."""
    px, py = polygon[:, 0], polygon[:, 1]
    nx, ny = np.roll(px, -1), np.roll(py, -1)
    crosses = ((py > y) != (ny > y)) & (
        x < (nx - px) * (y - py) / (ny - py + 1e-30) + px
    )
    return bool(np.count_nonzero(crosses) % 2)


def gaussian_point(bounds, rng) -> Tuple[float, float]:
    """Sample around the bbox center with variance = extent/8 per axis
    (reference `shape_draw.py:106-116`)."""
    min_x, min_y, max_x, max_y = bounds
    mean = np.array([(max_x + min_x) / 2.0, (max_y + min_y) / 2.0])
    var = np.array([max(max_x - min_x, 1e-6) / 8.0, max(max_y - min_y, 1e-6) / 8.0])
    x = rng.gauss(mean[0], math.sqrt(var[0]))
    y = rng.gauss(mean[1], math.sqrt(var[1]))
    return x, y


def gaussian_point_in_polygon(poly: Optional[PolygonSet], bounds, rng, max_tries: int = 10):
    """Gaussian sample, rejected into the polygon; after `max_tries`
    failures, return one last unconditioned sample
    (reference `shape_draw.py:112-128`)."""
    for _ in range(max_tries):
        x, y = gaussian_point(bounds, rng)
        if poly is None or poly.contains(x, y):
            return x, y
    return gaussian_point(bounds, rng)


def uniform_point_in_bbox(bbox, rng) -> Tuple[float, float]:
    left, top, right, bottom = bbox
    return rng.uniform(left, right), rng.uniform(top, bottom)


def uniform_point_in_polygon(poly: PolygonSet, rng, max_tries: int = 50):
    """Uniform rejection sampling in the union; falls back to a bbox sample
    (reference `shape_draw.py:227-242`)."""
    min_x, min_y, max_x, max_y = poly.bounds
    for _ in range(max_tries):
        x = rng.uniform(min_x, max_x)
        y = rng.uniform(min_y, max_y)
        if poly.contains(x, y):
            return x, y
    return rng.uniform(min_x, max_x), rng.uniform(min_y, max_y)


def max_angle_below(points: Sequence[Tuple[float, float]], limit_deg: float = 150.0) -> bool:
    """True if every interior angle of the triangle is below the limit
    (reference `shape_draw.py:244-260`)."""
    pts = [np.asarray(p, np.float64) for p in points]
    for i in range(3):
        p1, p2, p3 = pts[i], pts[(i + 1) % 3], pts[(i + 2) % 3]
        a = np.linalg.norm(p3 - p2)
        b = np.linalg.norm(p1 - p3)
        c = np.linalg.norm(p1 - p2)
        if a * c == 0:
            return False
        cosine = np.clip((a * a + c * c - b * b) / (2 * a * c), -1.0, 1.0)
        if math.degrees(math.acos(cosine)) > limit_deg:
            return False
    return True


def cubic_bezier(p0, p1, p2, p3, num: int) -> np.ndarray:
    """[num, 2] points along a cubic Bézier curve."""
    t = np.linspace(0.0, 1.0, num)[:, None]
    p0, p1, p2, p3 = (np.asarray(p, np.float64)[None] for p in (p0, p1, p2, p3))
    return ((1 - t) ** 3) * p0 + 3 * ((1 - t) ** 2) * t * p1 + 3 * (1 - t) * t ** 2 * p2 + (t ** 3) * p3
