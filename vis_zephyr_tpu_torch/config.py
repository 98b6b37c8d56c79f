"""One typed configuration tree shared by the port's models and serving code.

The port's own copy of the JAX package's `config.py`, field for field (the
tests hold the two against each other), so that nothing here imports that
package.

Replaces the reference's three-way split (HF `VisZephyrConfig(MistralConfig)`
ad-hoc `mm_*` attributes + `HfArgumentParser` dataclasses + argparse CLIs —
reference `vis_zephyr/model/language_model/vis_zephyr.py:19`,
`train/train.py:59-175`) with plain dataclasses. Knob names match the
reference surface (`mm_grid_pinpoints`, `image_aspect_ratio`,
`mm_patch_merge_type`, ...) for drop-in familiarity.

All configs are frozen, hence hashable.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """CLIP ViT vision tower (defaults = openai/clip-vit-large-patch14-336)."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    # Multi-layer feature selection: the fusion consumes the last
    # `num_fusion_groups * layers_per_group` intermediate hidden states plus
    # the final one (reference `vision_encoder.py:64`: hidden_states[-21:]).
    num_fusion_groups: int = 4
    layers_per_group: int = 5
    select_feature: str = "patch"  # "patch" drops CLS; "cls_patch" keeps it

    @property
    def tokens_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def tokens_per_image(self) -> int:
        return self.tokens_per_side ** 2

    @property
    def num_selected_layers(self) -> int:
        return self.num_fusion_groups * self.layers_per_group + 1

    @property
    def fused_hidden_size(self) -> int:
        # 4 group-means + final layer, concatenated on channels → 5×1024.
        return self.hidden_size * (self.num_fusion_groups + 1)


@dataclasses.dataclass(frozen=True)
class ProjectorConfig:
    """Text-conditioned Q-Former projector (the reference's multimodal
    projector)."""

    num_queries: int = 32
    hidden_size: int = 4096          # decoder hidden size
    visual_hidden_size: int = 5120   # fused vision feature dim
    num_blocks: int = 8
    num_heads: int = 8
    ffn_dim: int = 8192              # hidden_size * 2
    layer_norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Mistral/Zephyr-7B-β decoder
    (reference `checkpoints/vis-zephyr-7b-v1-pretrain/config.json`)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = 4096
    max_position_embeddings: int = 32768
    bos_token_id: int = 1
    eos_token_id: int = 2
    pad_token_id: int = 2


@dataclasses.dataclass(frozen=True)
class VisZephyrConfig:
    """Full multimodal model config."""

    vision: VisionConfig = VisionConfig()
    projector: ProjectorConfig = ProjectorConfig()
    decoder: DecoderConfig = DecoderConfig()

    # Multimodal plumbing (names match the reference config surface).
    # mm_projector_type: "qformer" (the reference's actual projector: its
    # projector factory ignores the config string and always returns the
    # Q-Former) or "mlp2x_gelu" (the type the reference config *claims*; in
    # the JAX package a live option, a 2-layer GELU MLP keeping all 576 patch
    # tokens; the port refuses it until the spatial merge is ported).
    mm_projector_type: str = "qformer"
    mm_patch_merge_type: str = "flat"
    image_aspect_ratio: str = "anyres"  # anyres | pad | resize | square
    mm_grid_pinpoints: str = "[[336, 672], [672, 336], [336, 1008], [1008, 336]]"
    mm_use_im_start_end: bool = False
    mm_use_im_patch_token: bool = False
    tokenizer_model_max_length: int = 2048
    tokenizer_padding_side: str = "right"

    @property
    def tokens_per_patch(self) -> int:
        """Projected tokens one encoder crop contributes before merging:
        the Q-Former emits `num_queries`; the MLP keeps every patch token."""
        if self.mm_projector_type == "mlp2x_gelu":
            return self.vision.tokens_per_image
        return self.projector.num_queries

    def max_extra_merge_tokens(self) -> int:
        """Static upper bound on tokens the patch merge ADDS beyond
        `valid_patches * tokens_per_patch` — nonzero only for
        `spatial_unpad`, whose newline column adds one token per feature
        row (≤ max-grid-height rows over the pinpoints)."""
        if "unpad" not in self.mm_patch_merge_type:
            return 0
        from .data.anyres import parse_grid_pinpoints

        tps = self.vision.tokens_per_side
        side = self.vision.image_size
        best = 1  # single-image case appends one newline token
        for w, h in parse_grid_pinpoints(self.mm_grid_pinpoints):
            best = max(best, (h // side) * tps)
        return best

    def replace(self, **kwargs) -> "VisZephyrConfig":
        return dataclasses.replace(self, **kwargs)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "VisZephyrConfig":
        raw = json.loads(text)
        return cls(
            vision=VisionConfig(**raw.pop("vision", {})),
            projector=ProjectorConfig(**raw.pop("projector", {})),
            decoder=DecoderConfig(**raw.pop("decoder", {})),
            **raw,
        )


def tiny_config(vocab_size: int = 256) -> VisZephyrConfig:
    """A structurally identical but tiny config for tests / compile checks."""
    return VisZephyrConfig(
        vision=VisionConfig(
            hidden_size=32,
            intermediate_size=64,
            num_layers=22,  # still ≥ 21 selected layers so fusion math is real
            num_heads=4,
            image_size=56,
            patch_size=14,
        ),
        projector=ProjectorConfig(
            num_queries=8,
            hidden_size=64,
            visual_hidden_size=160,  # 32 * 5
            num_blocks=2,
            num_heads=4,
            ffn_dim=128,
        ),
        decoder=DecoderConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            sliding_window=None,
        ),
        mm_grid_pinpoints="[[56, 112], [112, 56], [56, 168], [168, 56]]",
        tokenizer_model_max_length=512,
    )


def smoke_config(vocab_size: int = 256) -> VisZephyrConfig:
    """tiny_config with PRODUCTION kernel geometry: head_dim 128 (one full
    lane tile) and a real GQA split, but only 2 decoder layers.

    The hand-written kernels take head_dim 128 only, so a run on the card
    that should stay small uses this config, not `tiny_config`."""
    cfg = tiny_config(vocab_size)
    return dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, hidden_size=256, intermediate_size=512,
        num_heads=4, num_kv_heads=2, head_dim=128))
