"""Dense channel-integration fusion of multi-layer ViT features.

Port of `vis_zephyr_tpu/models/fusion.py`: the trailing intermediate layers
are split into `num_groups` contiguous groups, each mean-pooled across
layers, and the group means plus the final layer are concatenated on the
channel axis: [S, B, T, C] → [B, T, (G+1)*C]. No parameters.
"""

from __future__ import annotations

import torch


def dense_channel_fusion(stacked_features: torch.Tensor, num_groups: int = 4) -> torch.Tensor:
    S, B, T, C = stacked_features.shape
    num_intermediate = S - 1
    if num_intermediate % num_groups != 0:
        raise ValueError(
            f"{num_intermediate} intermediate layers not divisible by {num_groups} groups")
    per_group = num_intermediate // num_groups
    intermediates = stacked_features[:-1].reshape(num_groups, per_group, B, T, C)
    group_means = intermediates.mean(dim=1)                            # [G, B, T, C]
    parts = torch.cat([group_means, stacked_features[-1:]], dim=0)    # [G+1, B, T, C]
    return parts.permute(1, 2, 0, 3).reshape(B, T, (num_groups + 1) * C)
