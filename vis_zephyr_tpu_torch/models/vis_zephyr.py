"""VisZephyr — CLIP tower → multi-layer fusion → text-conditioned Q-Former →
token splice → Mistral decoder, PyTorch.

Port of `vis_zephyr_tpu/models/vis_zephyr.py` (`encode_images`,
`prepare_multimodal` with the flat patch merge, `vis_zephyr_forward`). The
JAX functions take a parameter pytree; these take a `VisZephyr` module whose
`vision`, `projector` and `decoder` submodules each carry HF state-dict
names.

Data model (host collators produce these):
- `input_ids`   [B, T]   right-padded, one IMAGE_TOKEN_INDEX per multimodal row,
- `text_valid`  [B, T]   bool,
- `images`      [B, P, H, W, 3] normalized pixels (global view first, then
                         tiles, then padding),
- `patch_valid` [B, P]   bool, valid patches contiguous from index 0.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..config import VisZephyrConfig

from ..ops.splice import compact_text_ids, splice_image_tokens
from .clip_vit import CLIPVisionTower, select_and_stack
from .fusion import dense_channel_fusion
from .mistral import MistralForCausalLM, embed, mistral_forward
from .projector import build_projector


class VisZephyr(nn.Module):
    def __init__(self, cfg: VisZephyrConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.vision = CLIPVisionTower(cfg.vision, device, dtype)
        self.projector = build_projector(cfg, device, dtype)
        self.decoder = MistralForCausalLM(cfg.decoder, device, dtype)

    @property
    def dtype(self) -> torch.dtype:
        return self.decoder.model.embed_tokens.weight.dtype

    @property
    def device(self) -> torch.device:
        return self.decoder.model.embed_tokens.weight.device


def init_vis_zephyr(cfg: VisZephyrConfig, generator: torch.Generator, device=None,
                    dtype=torch.float32) -> VisZephyr:
    """A model with random weights drawn from `generator` (which must live on
    `device`), at each submodule's `init_random` scales, every parameter
    frozen (a trainer sets `requires_grad` from its trainable mask)."""
    model = VisZephyr(cfg, device=device, dtype=dtype)
    model.vision.init_random(generator)
    model.projector.init_random(generator)
    model.decoder.init_random(generator)
    return model.requires_grad_(False).eval()


def encode_images(
    model: VisZephyr,
    images: torch.Tensor,
    cfg: VisZephyrConfig,
    text_embeddings: Optional[torch.Tensor] = None,
    text_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """images [N, H, W, 3] → projected visual tokens [N, num_queries, D].

    The pixels are cast to the weights' dtype first: PyTorch does not mix
    dtypes in a matmul, so a bf16 model runs its vision stack, Q-Former and
    decoder prefill in bf16. The JAX engine's f32 pixels promote all of that
    to f32 over the same bf16 weights; `chip_smoke.py` measures the gap at
    full width against an f32 run of the same weights.

    The tower and the fusion run without autograd: the JAX package stops the
    gradient after the fusion (frozen tower), and so no ViT activation of
    the crops is kept for a backward pass."""
    with torch.no_grad():
        hidden = model.vision(images.to(model.dtype))
        stacked = select_and_stack(hidden, cfg.vision)      # [S, N, T, C]
        fused = dense_channel_fusion(stacked, cfg.vision.num_fusion_groups)
    return model.projector(fused, text_embeddings=text_embeddings, text_mask=text_mask)


def prepare_multimodal(
    model: VisZephyr,
    input_ids: torch.Tensor,
    images: torch.Tensor,
    patch_valid: torch.Tensor,
    cfg: VisZephyrConfig,
    text_valid: Optional[torch.Tensor] = None,
    labels: Optional[torch.Tensor] = None,
    pad_to_multiple: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Encode images with Q-Former text conditioning, merge patch tokens
    flat, splice embeddings (and labels). Returns the `splice_image_tokens`
    dict."""
    if cfg.mm_patch_merge_type != "flat":
        raise NotImplementedError(
            f"mm_patch_merge_type={cfg.mm_patch_merge_type!r} is not ported yet (flat only)")
    B = input_ids.shape[0]
    P = images.shape[1]
    Q = cfg.tokens_per_patch

    # Q-Former conditioning: the prompt without its sentinel, embedded,
    # repeated per patch; batch padding is masked out of block 0.
    text_ids, cond_valid = compact_text_ids(input_ids, cfg.decoder.pad_token_id,
                                            text_valid=text_valid)
    cond = embed(model.decoder, text_ids)
    cond = cond * cond_valid[..., None].to(cond.dtype)
    cond = cond.repeat_interleave(P, dim=0)                 # [B*P, T-1, D]
    cond_mask = cond_valid.repeat_interleave(P, dim=0)

    flat_images = images.reshape((B * P,) + tuple(images.shape[2:]))
    projected = encode_images(model, flat_images, cfg, text_embeddings=cond, text_mask=cond_mask)

    image_embeds = projected.reshape(B, P * Q, -1)          # flat patch merge
    num_image_tokens = patch_valid.to(torch.int64).sum(dim=1) * Q

    return splice_image_tokens(
        input_ids,
        embed(model.decoder, input_ids),
        image_embeds,
        num_image_tokens,
        text_valid=text_valid,
        labels=labels,
        max_length=cfg.tokenizer_model_max_length,
        pad_to_multiple=pad_to_multiple,
    )


def vis_zephyr_forward(
    model: VisZephyr,
    input_ids: torch.Tensor,
    images: Optional[torch.Tensor],
    patch_valid: Optional[torch.Tensor],
    cfg: VisZephyrConfig,
    text_valid: Optional[torch.Tensor] = None,
    labels: Optional[torch.Tensor] = None,
    return_kv: bool = False,
    pad_to_multiple: Optional[int] = None,
    remat: bool = False,
    lora_dropout: float = 0.0,
    dropout_rng: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict]:
    """Full multimodal forward (prefill or training step). Returns (logits,
    aux) where aux carries the spliced labels (when `labels` is given) and
    valid/positions/lengths and, with `return_kv`, the per-layer "kv".
    `remat`, `lora_dropout` and `dropout_rng` go to `mistral_forward`."""
    if images is None:
        B, T = input_ids.shape
        valid = (torch.ones((B, T), dtype=torch.bool, device=input_ids.device)
                 if text_valid is None else text_valid.bool())
        positions = torch.where(valid, valid.long().cumsum(dim=1) - 1, 0).to(torch.int32)
        prepared = {
            "embeds": embed(model.decoder, input_ids),
            "valid": valid,
            "positions": positions,
            "lengths": valid.sum(dim=1).to(torch.int32),
        }
        if labels is not None:
            prepared["labels"] = labels
    else:
        prepared = prepare_multimodal(model, input_ids, images, patch_valid, cfg,
                                      text_valid=text_valid, labels=labels,
                                      pad_to_multiple=pad_to_multiple)

    logits, extra = mistral_forward(
        model.decoder, prepared["embeds"], cfg.decoder, prepared["positions"],
        attn_valid=prepared["valid"], return_kv=return_kv, remat=remat,
        lora_dropout=lora_dropout, dropout_rng=dropout_rng,
    )
    aux = {k: v for k, v in prepared.items() if k != "embeds"}
    if extra is not None:
        aux["kv"] = extra
    return logits, aux
