"""CLIP ViT vision encoder (HF `CLIPVisionModel` computation), PyTorch.

Port of `vis_zephyr_tpu/models/clip_vit.py`: patch embed + CLS + learned
positions → pre-LayerNorm → pre-LN blocks with QuickGELU MLPs → every
hidden state (no post-LayerNorm). Parameters carry the HF state-dict names
(`embeddings.patch_embedding.weight`, `encoder.layers.{i}.mlp.fc1.weight`,
`pre_layrnorm.weight`, ...), so `hf_convert.convert_clip_vision` reads
`state_dict()` as it is.

Images are NHWC. The patch embedding is patchify + one matmul, as in the
JAX package, and not a `Conv2d` call (which cuDNN would run in TF32 by
default). The ViT's head_dim of 64 fails the flash kernel's gate, so its
attention is plain matmul + f32 softmax.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vis_zephyr_tpu.config import VisionConfig


def layer_norm_f32(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm computed in float32 whatever the compute dtype."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(), ln.eps)
    return y.to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    # OpenAI CLIP activation: x * sigmoid(1.702 * x).
    return x * torch.sigmoid(1.702 * x)


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, H, W, 3] → [B, (H/p)*(W/p), p*p*3] row-major patches."""
    B, H, W, C = images.shape
    gh, gw = H // patch_size, W // patch_size
    x = images.reshape(B, gh, patch_size, gw, patch_size, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch_size * patch_size * C)


class PatchEmbedding(nn.Module):
    """Holds the HF conv weight [D, 3, p, p]; applies it as patchify + matmul."""

    def __init__(self, cfg: VisionConfig, device=None, dtype=None):
        super().__init__()
        self.patch_size = cfg.patch_size
        self.weight = nn.Parameter(torch.empty(cfg.hidden_size, 3, cfg.patch_size,
                                               cfg.patch_size, device=device, dtype=dtype))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        # Patch pixel (ph, pw, c) sits at flat index ph*p*3 + pw*3 + c.
        kernel = self.weight.permute(2, 3, 1, 0).reshape(-1, self.weight.shape[0])
        return patchify(images, self.patch_size) @ kernel


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: VisionConfig, device=None, dtype=None):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden_size, device=device, dtype=dtype))
        self.patch_embedding = PatchEmbedding(cfg, device, dtype)
        self.position_embedding = nn.Embedding(cfg.tokens_per_image + 1, cfg.hidden_size,
                                               device=device, dtype=dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.patch_embedding(images)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1)
        return x + self.position_embedding.weight[None, : x.shape[1]]


class CLIPAttention(nn.Module):
    """Bidirectional multi-head attention (no mask — full visual field)."""

    def __init__(self, cfg: VisionConfig, device=None, dtype=None):
        super().__init__()
        D = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.q_proj = nn.Linear(D, D, device=device, dtype=dtype)
        self.k_proj = nn.Linear(D, D, device=device, dtype=dtype)
        self.v_proj = nn.Linear(D, D, device=device, dtype=dtype)
        self.out_proj = nn.Linear(D, D, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        hd = D // self.num_heads
        q = self.q_proj(x).reshape(B, T, self.num_heads, hd)
        k = self.k_proj(x).reshape(B, T, self.num_heads, hd)
        v = self.v_proj(x).reshape(B, T, self.num_heads, hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * (hd ** -0.5)
        probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, D)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, cfg: VisionConfig, device=None, dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size, device=device, dtype=dtype)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: VisionConfig, device=None, dtype=None):
        super().__init__()
        D, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.layer_norm1 = nn.LayerNorm(D, eps=eps, device=device, dtype=dtype)
        self.self_attn = CLIPAttention(cfg, device, dtype)
        self.layer_norm2 = nn.LayerNorm(D, eps=eps, device=device, dtype=dtype)
        self.mlp = CLIPMLP(cfg, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(layer_norm_f32(x, self.layer_norm1))
        return x + self.mlp(layer_norm_f32(x, self.layer_norm2))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: VisionConfig, device=None, dtype=None):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg, device, dtype)
                                    for _ in range(cfg.num_layers))


class CLIPVisionTower(nn.Module):
    def __init__(self, cfg: VisionConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = CLIPEmbeddings(cfg, device, dtype)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                                         device=device, dtype=dtype)  # (sic) HF spelling
        self.encoder = CLIPEncoder(cfg, device, dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] normalized pixels (NHWC) → ALL hidden states
        [num_layers + 1, B, 1 + tokens, hidden]: index 0 is the
        pre-LayerNorm embedding output, index i the output of block i."""
        x = layer_norm_f32(self.embeddings(images), self.pre_layrnorm)
        states = [x]
        for layer in self.encoder.layers:
            x = layer(x)
            states.append(x)
        return torch.stack(states)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> None:
        """Random weights with the JAX `init_clip_vit` scales."""
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif "layer_norm" in name or "layrnorm" in name:
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=generator)


def select_and_stack(hidden_states: torch.Tensor, cfg: VisionConfig) -> torch.Tensor:
    """Slice the trailing `num_selected_layers` hidden states and drop the
    CLS token per layer (select_feature='patch')."""
    selected = hidden_states[-cfg.num_selected_layers:]
    if cfg.select_feature == "patch":
        return selected[:, :, 1:, :]
    if cfg.select_feature == "cls_patch":
        return selected
    raise ValueError(f"Unknown select_feature: {cfg.select_feature}")
