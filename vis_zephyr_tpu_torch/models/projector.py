"""Projector dispatch. Port of `vis_zephyr_tpu/models/projector.py` for the
`qformer` route (the reference's real projector); `mlp2x_gelu` is not
ported yet and is refused."""

from __future__ import annotations

from ..config import VisZephyrConfig

from .qformer import QFormer


def build_projector(cfg: VisZephyrConfig, device=None, dtype=None) -> QFormer:
    if cfg.mm_projector_type != "qformer":
        raise NotImplementedError(
            f"mm_projector_type={cfg.mm_projector_type!r} is not ported yet (qformer only)")
    return QFormer(cfg.projector, device, dtype)
