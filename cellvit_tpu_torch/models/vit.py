"""Histopathology ViT encoder (port of `cellvit_tpu/models/vit.py`: Attention,
Block, HistoViT).

DINO/HIPT ViT-256: learned 1-D positional embedding with a CLS token,
bicubic pos-emb interpolation (with the reference's +0.1 scale fudge) for
other input sizes, and per-block skip extraction. Attention over 1024 or more
tokens takes the flash route (`ops/attention.py`: the hand kernels B1 and,
for its backward, B8 on CUDA), as in the JAX package; on the card a 256²
image's 257 tokens take it too, in bf16 at the head widths the kernels are
built for. Shorter sequences, and training with attention dropout (the
flash kernels never form the probabilities to drop from), take the einsum
route. `train()` turns on the token, attention and MLP dropout and the
drop-path, each drawing from its module's generator
(`layers.use_generator`).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from cellvit_tpu_torch.models.layers import (DropPath, Dropout, LayerNorm, Mlp, PatchEmbed,
                                             resize_matrix_1d)
from cellvit_tpu_torch.ops.attention import FLASH_V_DIMS, flash_attention

FLASH_MIN_TOKENS = 1024
#: on the card: a 256² image's CLS + 16² tokens
FLASH_MIN_TOKENS_CUDA = 257


class Attention(nn.Module):
    """Multi-head self-attention with a fused qkv projection; dropout on the
    attention probabilities (`attn_dropout`) and after the projection."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True, dropout: float = 0.0,
                 attn_dropout: float = 0.0) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.attn_drop = Dropout(attn_dropout)
        self.proj_drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        hd = c // h
        qkv = self.qkv(x).reshape(b, n, 3, h, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (B, N, H, hd)
        if self._flash_route(q):
            out = flash_attention(q, k, v)
        else:  # fp32 logits and softmax, as the JAX package's einsum route, autocast or not
            with torch.autocast(x.device.type, enabled=False):
                attn = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd**-0.5
                attn = torch.softmax(attn, dim=-1)
            out = torch.einsum("bhqk,bkhd->bqhd", self.attn_drop(attn).to(x.dtype), v)
        return self.proj_drop(self.proj(out.reshape(b, n, c)))

    def _flash_route(self, q: torch.Tensor) -> bool:
        """Whether attention on (B, N, H, hd) `q` takes the flash kernels."""
        if self.training and self.attn_drop.p > 0.0:
            return False
        n = q.shape[1]
        if n >= FLASH_MIN_TOKENS:
            return True
        return (q.is_cuda and n >= FLASH_MIN_TOKENS_CUDA and q.dtype == torch.bfloat16
                and q.shape[-1] in FLASH_V_DIMS)


class Block(nn.Module):
    """Pre-LN transformer block: LN → MHA → (+), LN → MLP → (+), each branch
    through drop-path."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, dropout: float = 0.0, attn_dropout: float = 0.0,
                 drop_path_rate: float = 0.0) -> None:
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, qkv_bias, dropout, attn_dropout)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dropout)
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.drop_path(self.attn(self.norm1(x)))
        return x + self.drop_path(self.mlp(self.norm2(x)))


class HistoViT(nn.Module):
    """ViT with CLS token and 1-D pos-emb. `forward` takes NCHW images and
    returns (cls_logits, cls_token, skips): skips are the full token
    sequences after each block index in `extract_layers` (1-based).
    `dropout` acts after the pos-emb, the attention projection and the MLP
    layers; the drop-path rate rises linearly from 0 at the first block to
    `drop_path_rate` at the last."""

    def __init__(self, embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, num_classes: int = 0,
                 patch_size: int = 16, pretrain_img_size: int = 224,
                 extract_layers: Sequence[int] = (), dropout: float = 0.0,
                 attn_dropout: float = 0.0, drop_path_rate: float = 0.0) -> None:
        super().__init__()
        n_pre = (pretrain_img_size // patch_size) ** 2
        self.embed_dim = embed_dim
        self.extract_layers = tuple(extract_layers)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_pre + 1, embed_dim))
        nn.init.trunc_normal_(self.cls_token, std=0.02)
        nn.init.trunc_normal_(self.pos_embed, std=0.02)
        self.patch_embed = PatchEmbed(embed_dim, patch_size)
        self.pos_drop = Dropout(dropout)
        rates = np.linspace(0.0, drop_path_rate, depth).tolist()
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, dropout, attn_dropout, rate)
            for rate in rates
        )
        self.norm = LayerNorm(embed_dim, eps=1e-6)
        self.head = nn.Linear(embed_dim, num_classes) if num_classes > 0 else nn.Identity()

    def _interpolated_pos_embed(self, ht: int, wt: int) -> torch.Tensor:
        """Bicubic-resize the pos-emb grid to (ht, wt) as two dense resize
        matmuls; the scale factors carry the reference's +0.1 fudge."""
        pe = self.pos_embed.float()
        n_pre = pe.shape[1] - 1
        g = int(math.sqrt(n_pre))
        if ht * wt == n_pre and ht == wt:
            return pe
        patch_pe = pe[:, 1:].reshape(1, g, g, self.embed_dim)
        mh = resize_matrix_1d(g, ht, (ht + 0.1) / g).to(pe.device)
        mw = resize_matrix_1d(g, wt, (wt + 0.1) / g).to(pe.device)
        out = torch.einsum("Hg,bghc,Wh->bHWc", mh, patch_pe, mw)
        return torch.cat([pe[:, :1], out.reshape(1, ht * wt, self.embed_dim)], dim=1)

    def prepare_tokens(self, x: torch.Tensor) -> torch.Tensor:
        tokens = self.patch_embed(x)  # (B, Ht, Wt, E)
        b, ht, wt, e = tokens.shape
        tokens = tokens.reshape(b, ht * wt, e)
        cls = self.cls_token.to(tokens.dtype).expand(b, 1, e)
        tokens = torch.cat([cls, tokens], dim=1)
        return self.pos_drop(tokens + self._interpolated_pos_embed(ht, wt).to(tokens.dtype))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
        tokens = self.prepare_tokens(x)
        skips: List[torch.Tensor] = []
        for i, blk in enumerate(self.blocks):
            tokens = blk(tokens)
            if (i + 1) in self.extract_layers:
                skips.append(tokens)
        cls_token = self.norm(tokens)[:, 0]
        return self.head(cls_token), cls_token, skips
