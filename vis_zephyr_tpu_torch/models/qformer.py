"""Text-conditioned Q-Former multimodal projector, PyTorch.

Port of `vis_zephyr_tpu/models/qformer.py`: learned queries, one LayerNorm
on the visual features, then pre-LN blocks of self-attention, cross-attention
(Q width `hidden_size`, KV width `visual_hidden_size`) and an exact-GELU FFN,
and a final LayerNorm. Block 0 sees `[queries ; text_embeddings]` and its
output is cut back to the query slots.

Parameter names follow the released `mm_projector.bin` (torch
`nn.MultiheadAttention` layout: `in_proj_weight` when the key width equals
the query width, `q_proj_weight`/`k_proj_weight`/`v_proj_weight` otherwise,
always a packed `in_proj_bias`), so `hf_convert.convert_qformer` reads
`state_dict()` as it is. LayerNorms run in f32; attention is plain matmul
with an f32 softmax, masked scores set to the score dtype's minimum.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vis_zephyr_tpu.config import ProjectorConfig

from .clip_vit import layer_norm_f32


class MultiheadAttention(nn.Module):
    """`torch.nn.MultiheadAttention`'s parameters, with the JAX `_mha` math."""

    def __init__(self, dim: int, num_heads: int, kv_dim: int, device=None, dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.packed = kv_dim == dim
        if self.packed:
            self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim, device=device, dtype=dtype))
        else:
            self.q_proj_weight = nn.Parameter(torch.empty(dim, dim, device=device, dtype=dtype))
            self.k_proj_weight = nn.Parameter(torch.empty(dim, kv_dim, device=device, dtype=dtype))
            self.v_proj_weight = nn.Parameter(torch.empty(dim, kv_dim, device=device, dtype=dtype))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim, device=device, dtype=dtype))
        self.out_proj = nn.Linear(dim, dim, device=device, dtype=dtype)

    def projections(self):
        if self.packed:
            return self.in_proj_weight.chunk(3, dim=0)
        return self.q_proj_weight, self.k_proj_weight, self.v_proj_weight

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, Tq, D = q_in.shape
        hd = D // self.num_heads
        wq, wk, wv = self.projections()
        bq, bk, bv = self.in_proj_bias.chunk(3)
        q = F.linear(q_in, wq, bq).reshape(B, Tq, self.num_heads, hd)
        k = F.linear(kv_in, wk, bk).reshape(B, -1, self.num_heads, hd)
        v = F.linear(kv_in, wv, bv).reshape(B, -1, self.num_heads, hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * (hd ** -0.5)
        if kv_mask is not None:
            scores = scores.masked_fill(~kv_mask[:, None, None, :], torch.finfo(scores.dtype).min)
        probs = torch.softmax(scores.float(), dim=-1).to(q_in.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, Tq, D)
        return self.out_proj(out)


class QFormerBlock(nn.Module):
    def __init__(self, cfg: ProjectorConfig, device=None, dtype=None):
        super().__init__()
        D, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.norm1 = nn.LayerNorm(D, eps=eps, device=device, dtype=dtype)
        self.self_attn = MultiheadAttention(D, cfg.num_heads, D, device, dtype)
        self.norm2 = nn.LayerNorm(D, eps=eps, device=device, dtype=dtype)
        self.cross_attn = MultiheadAttention(D, cfg.num_heads, cfg.visual_hidden_size, device, dtype)
        self.norm3 = nn.LayerNorm(D, eps=eps, device=device, dtype=dtype)
        self.ffn = nn.Sequential(
            nn.Linear(D, cfg.ffn_dim, device=device, dtype=dtype),
            nn.GELU(approximate="none"),
            nn.Linear(cfg.ffn_dim, D, device=device, dtype=dtype),
        )

    def forward(self, queries, visual, self_mask=None):
        h = layer_norm_f32(queries, self.norm1)
        queries = queries + self.self_attn(h, h, kv_mask=self_mask)
        h = layer_norm_f32(queries, self.norm2)
        queries = queries + self.cross_attn(h, visual)
        h = layer_norm_f32(queries, self.norm3)
        return queries + self.ffn(h)


class QFormer(nn.Module):
    def __init__(self, cfg: ProjectorConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.learned_queries = nn.Parameter(
            torch.empty(cfg.num_queries, cfg.hidden_size, device=device, dtype=dtype))
        self.pre_norm = nn.LayerNorm(cfg.visual_hidden_size, eps=cfg.layer_norm_eps,
                                     device=device, dtype=dtype)
        self.blocks = nn.ModuleList(QFormerBlock(cfg, device, dtype) for _ in range(cfg.num_blocks))
        self.norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, device=device, dtype=dtype)

    def forward(self, visual_features: torch.Tensor,
                text_embeddings: Optional[torch.Tensor] = None,
                text_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """visual_features [B, T_vis, visual_hidden_size]; optional
        text_embeddings [B, L, hidden_size] condition block 0, with
        text_mask [B, L] bool masking padded text out of its self-attention.
        Returns [B, num_queries, hidden_size]."""
        cfg = self.cfg
        B = visual_features.shape[0]
        visual = layer_norm_f32(visual_features, self.pre_norm)
        queries = self.learned_queries[None].expand(B, -1, -1).to(visual_features.dtype)
        if text_embeddings is not None:
            init = torch.cat([queries, text_embeddings.to(queries.dtype)], dim=1)
            self_mask = None
            if text_mask is not None:
                q_mask = torch.ones((B, cfg.num_queries), dtype=torch.bool, device=init.device)
                self_mask = torch.cat([q_mask, text_mask.bool()], dim=1)
            queries = self.blocks[0](init, visual, self_mask=self_mask)[:, : cfg.num_queries]
        else:
            queries = self.blocks[0](queries, visual)
        for block in self.blocks[1:]:
            queries = block(queries, visual)
        return layer_norm_f32(queries, self.norm)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> None:
        """Random weights with the JAX `init_qformer` scales: N(0, 1)
        queries, N(0, fan_in^-1/2) projections, zero biases, unit norms."""
        self.learned_queries.normal_(0.0, 1.0, generator=generator)
        for name, p in self.named_parameters():
            if name == "learned_queries":
                continue
            if name.endswith("bias"):
                p.zero_()
            elif "norm" in name:
                p.fill_(1.0)
            else:
                p.normal_(0.0, p.shape[-1] ** -0.5, generator=generator)
