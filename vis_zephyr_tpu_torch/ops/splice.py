"""Multimodal token splice, PyTorch.

Port of `vis_zephyr_tpu/ops/splice.py`: each IMAGE_TOKEN_INDEX sentinel of
a right-padded token batch is replaced by its block of projected image
tokens, giving embeddings, validity, positions and lengths of a static
output length. Every input position gets an expansion size (1 for text, the
image's token count for a sentinel, 0 for padding); exclusive cumsums give
each input token its output offset, and each output slot finds its source
token with a batched `searchsorted`. Differentiable in `image_embeds` (and
`text_embeds`): stage-1 training reaches the projector only through it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX


def splice_image_tokens(
    input_ids: torch.Tensor,
    text_embeds: torch.Tensor,
    image_embeds: torch.Tensor,
    num_image_tokens: torch.Tensor,
    text_valid: Optional[torch.Tensor] = None,
    labels: Optional[torch.Tensor] = None,
    max_length: Optional[int] = None,
    pad_to_multiple: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Expand each row's image sentinel into its image-embedding block.

    input_ids [B, T]; text_embeds [B, T, D]; image_embeds [B, N, D];
    num_image_tokens [B] (the real rows of image_embeds); text_valid [B, T]
    bool; labels [B, T] (optional): image rows and padding become
    IGNORE_INDEX. `max_length` truncates the output, `pad_to_multiple` rounds
    its length up (the validity mask covers the rest). One image per row: the
    JAX version's multi-image `[B, K]` counts are not ported, since no caller
    passes them (training passes `[B]`, as serving does).

    Returns embeds [B, T_out, D], valid [B, T_out], positions [B, T_out]
    int32, lengths [B] int32 and, with `labels`, labels [B, T_out];
    T_out = T - 1 + N.
    """
    B, T = input_ids.shape
    N = image_embeds.shape[1]
    dev = input_ids.device
    T_out = T - 1 + N
    if max_length is not None:
        T_out = min(T_out, max_length)
    if pad_to_multiple:
        T_out = -(-T_out // pad_to_multiple) * pad_to_multiple
    if num_image_tokens.dim() != 1:
        raise ValueError(f"num_image_tokens must be [B], got {tuple(num_image_tokens.shape)}")

    text_valid = (torch.ones((B, T), dtype=torch.bool, device=dev)
                  if text_valid is None else text_valid.bool())
    is_sentinel = (input_ids == IMAGE_TOKEN_INDEX) & text_valid
    sizes = torch.where(is_sentinel, num_image_tokens.long()[:, None], 1)
    sizes = torch.where(text_valid, sizes, torch.zeros_like(sizes))
    starts = sizes.cumsum(dim=1) - sizes                                # exclusive
    lengths = sizes.sum(dim=1)

    # Output slot j's source: the last input i with starts[i] <= j.
    out_idx = torch.arange(T_out, device=dev)
    src = torch.searchsorted(starts.contiguous(), out_idx.expand(B, T_out).contiguous(),
                             right=True) - 1
    src = torch.clamp(src, 0, T - 1)                                    # [B, T_out]

    batch = torch.arange(B, device=dev)[:, None]
    src_is_img = torch.gather(is_sentinel, 1, src)
    offset = out_idx[None, :] - torch.gather(starts, 1, src)            # row in the block
    valid = out_idx[None, :] < lengths[:, None]

    img_rows = image_embeds[batch, torch.clamp(offset, 0, N - 1)]
    txt_rows = text_embeds[batch, src]
    embeds = torch.where((src_is_img & valid)[..., None], img_rows, txt_rows)
    embeds = torch.where(valid[..., None], embeds, torch.zeros((), dtype=embeds.dtype, device=dev))
    out = {
        "embeds": embeds,
        "valid": valid,
        "positions": torch.where(valid, out_idx[None, :], 0).to(torch.int32),
        "lengths": torch.clamp(lengths, max=T_out).to(torch.int32),
    }
    if labels is not None:
        lab = torch.gather(labels, 1, src)
        out["labels"] = torch.where(src_is_img | ~valid, torch.full_like(lab, IGNORE_INDEX), lab)
    return out


def compact_text_ids(input_ids: torch.Tensor, pad_id: int,
                     text_valid: Optional[torch.Tensor] = None):
    """Remove the image sentinel from each row, shifting the tail left and
    keeping length T-1 (rows without a sentinel lose their last token).

    Returns (compacted_ids [B, T-1], compacted_valid [B, T-1]); the validity
    mask travels through the same permutation, so batch padding can be kept
    out of the Q-Former conditioning."""
    B, T = input_ids.shape
    if text_valid is None:
        text_valid = torch.ones((B, T), dtype=torch.bool, device=input_ids.device)
    is_sentinel = input_ids == IMAGE_TOKEN_INDEX
    # A stable sort of the sentinel flag moves text tokens to the front in
    # their order and the sentinel to the back.
    order = torch.sort(is_sentinel.int(), dim=1, stable=True).indices
    compacted = torch.gather(input_ids, 1, order)[:, : T - 1]
    valid = torch.gather(text_valid.bool(), 1, order)[:, : T - 1]
    valid &= compacted != IMAGE_TOKEN_INDEX
    return torch.where(valid, compacted, torch.full_like(compacted, pad_id)), valid
