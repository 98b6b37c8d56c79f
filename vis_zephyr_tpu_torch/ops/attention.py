"""Attention ops with a uniform masking formulation (plain PyTorch).

Port of `vis_zephyr_tpu/ops/attention.py`. Position `(q, kv)` may attend iff

    kv_valid[kv]  AND  kv_pos[kv] <= q_pos[q]            (causal)
                  AND  q_pos[q] - kv_pos[kv] < window     (sliding window)

`dot_product_attention` is the plain version of the flash kernel's contract
and the decode-time attention over the dense cache (which the JAX package
also leaves to XLA).
"""

from __future__ import annotations

from typing import Optional

import torch


def attention_mask(
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    kv_valid: Optional[torch.Tensor] = None,
    causal: bool = True,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Boolean mask [B, Tq, Tkv] per the module-level rule."""
    mask = torch.ones((q_positions.shape[0], q_positions.shape[1], kv_positions.shape[1]),
                      dtype=torch.bool, device=q_positions.device)
    if causal:
        mask &= kv_positions[:, None, :] <= q_positions[:, :, None]
    if sliding_window is not None:
        mask &= q_positions[:, :, None] - kv_positions[:, None, :] < sliding_window
    if kv_valid is not None:
        mask &= kv_valid[:, None, :].bool()
    return mask


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-query attention. q [B, Tq, Hq, D], k/v [B, Tkv, Hkv, D]
    (Hq % Hkv == 0, q head h reads kv head h // (Hq/Hkv)), mask bool
    [B, Tq, Tkv]. Scores are softmaxed in f32; masked scores get -1e30.
    Returns [B, Tq, Hq, D]."""
    B, Tq, Hq, D = q.shape
    Hkv = k.shape[2]
    groups = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale

    qg = q.reshape(B, Tq, Hkv, groups, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * scale
    scores = scores.float()
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Tq, Hq, D)
