"""SAM ViTDet image encoder (port of `cellvit_tpu/models/sam_vit.py`):
windowed attention with a decomposed relative-position bias, a few global
blocks, and the conv neck.

Tokens stay on a 2-D grid (B, Ht, Wt, C). Skips are the raw outputs of the
blocks listed in `extract_layers` (1-based), in (B, Ht, Wt, C). Module names
follow the reference torch SAM encoder (`attn.qkv`, `attn.rel_pos_h`,
`mlp.lin1`, `neck.0-3`), so reference state dicts load as they are.

`SamAttention` routes by the grid's shape only, as the JAX package does on
its accelerator; each op then runs its CUDA kernel or its plain version by
the tensor's device:

- square grids of 196-256 tokens (the 14×14 windows): the fused window op
  `window_qkv_attention` (B5), which also runs the qkv projection;
- other grids of ≥ 196 tokens: `flash_attention_relpos` (B6 for SAM's 64×64
  global grids, B7 for grids of ≤ 256 tokens);
- smaller grids: the einsum path.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cellvit_tpu_torch.models.layers import (LayerNorm, LayerNorm2d, PatchEmbed, compute_dtype,
                                             resize_matrix_1d)
from cellvit_tpu_torch.ops.attention import flash_attention_relpos, window_qkv_attention


def window_partition(x: torch.Tensor, window: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) → (B·nW, window, window, C), zero-padding H and W up to a
    multiple of `window`. Returns the windows and the padded (Hp, Wp)."""
    b, h, w, c = x.shape
    pad_h, pad_w = (window - h % window) % window, (window - w % window) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // window, window, wp // window, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, window, window, c), (hp, wp)


def window_unpartition(windows: torch.Tensor, window: int, pad_hw: Tuple[int, int],
                       hw: Tuple[int, int]) -> torch.Tensor:
    """Inverse of `window_partition`, cropping the padding."""
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // window // window)
    x = windows.reshape(b, hp // window, wp // window, window, window, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :w]


def gather_rel_pos(rel_pos: torch.Tensor, size: int) -> torch.Tensor:
    """The (size, size, head_dim) fp32 table R[i, j] = rel_pos[i − j + size − 1],
    after resizing the stored table linearly to length 2·size − 1 if needed
    (reference `get_rel_pos`, q_size == k_size)."""
    need = 2 * size - 1
    rel = rel_pos.float()
    if rel.shape[0] != need:
        m = resize_matrix_1d(rel.shape[0], need, need / rel.shape[0], "linear")
        rel = m.to(rel.device) @ rel
    idx = torch.arange(size, device=rel.device)
    return rel[idx[:, None] - idx[None, :] + (size - 1)]


class SamAttention(nn.Module):
    """Multi-head attention over a (B, H, W, C) token grid with the decomposed
    rel-pos bias (every CellViT-SAM model uses it); `rel_pos_dim` is the grid
    side the tables were sized for."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 rel_pos_dim: int = 14) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        hd = dim // num_heads
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * rel_pos_dim - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * rel_pos_dim - 1, hd))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        nh, n = self.num_heads, h * w
        hd = c // nh
        rh, rw = gather_rel_pos(self.rel_pos_h, h), gather_rel_pos(self.rel_pos_w, w)
        if h == w and 196 <= n <= 256:
            # the fused op runs the qkv projection itself: its operands in the
            # compute dtype (bf16 under autocast, whose casts it bypasses)
            dt = compute_dtype(x)
            bias = None if self.qkv.bias is None else self.qkv.bias.to(dt)
            out = window_qkv_attention(x.reshape(b, n, c).to(dt), self.qkv.weight.t().to(dt), bias,
                                       rh, rw, nh)
            return self.proj(out).reshape(b, h, w, c)
        qkv = self.qkv(x.reshape(b, n, c)).reshape(b, n, 3, nh, hd)
        q, k, v = qkv.unbind(2)  # (B, N, nh, hd) views
        if n >= 196:
            out = flash_attention_relpos(q, k, v, rh, rw, (h, w))
            return self.proj(out.reshape(b, n, c)).reshape(b, h, w, c)
        with torch.autocast(x.device.type, enabled=False):  # fp32 logits, autocast or not
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd**-0.5
            rq = q.float().reshape(b, h, w, nh, hd)
            bias_h = torch.einsum("bijnd,ikd->bnijk", rq, rh)
            bias_w = torch.einsum("bijnd,jld->bnijl", rq, rw)
            logits = logits + (bias_h[..., :, None] + bias_w[..., None, :]).reshape(b, nh, n, n)
            p = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", p.to(x.dtype), v)
        return self.proj(out.reshape(b, h, w, c))


class MLPBlock(nn.Module):
    """SAM's MLP: lin1 → exact-erf GELU → lin2."""

    def __init__(self, dim: int, hidden_dim: int) -> None:
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden_dim)
        self.act = nn.GELU()
        self.lin2 = nn.Linear(hidden_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(self.act(self.lin1(x)))


class SamBlock(nn.Module):
    """ViTDet block: LN → (windowed) attention → (+), LN → MLP → (+).
    `window_size` 0 is global attention over the whole grid."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 window_size: int = 0, grid_size: int = 64) -> None:
        super().__init__()
        self.window_size = window_size
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = SamAttention(dim, num_heads, qkv_bias,
                                 rel_pos_dim=window_size if window_size > 0 else grid_size)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm1(x)
        if self.window_size > 0:
            h, w = y.shape[1], y.shape[2]
            y, pad_hw = window_partition(y, self.window_size)
            y = window_unpartition(self.attn(y), self.window_size, pad_hw, (h, w))
        else:
            y = self.attn(y)
        x = x + y
        return x + self.mlp(self.norm2(x))


class SamViT(nn.Module):
    """SAM image encoder. `forward` takes NCHW images and returns (pooled
    neck feature (B, out_chans), neck map (B, out_chans, Ht, Wt), skips):
    the neck is 1×1 conv → LN2d → 3×3 conv → LN2d with no conv biases, and
    the pos-embed (1, grid, grid, E), sized for SAM's 1024² pretraining
    images, is cropped to the token grid."""

    def __init__(self, embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, out_chans: int = 256,
                 patch_size: int = 16, window_size: int = 14,
                 global_attn_indexes: Sequence[int] = (), extract_layers: Sequence[int] = ()) -> None:
        super().__init__()
        grid = 1024 // patch_size
        self.extract_layers = tuple(extract_layers)
        self.patch_embed = PatchEmbed(embed_dim, patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, embed_dim))
        nn.init.trunc_normal_(self.pos_embed, std=0.02)
        self.blocks = nn.ModuleList(
            SamBlock(embed_dim, num_heads, mlp_ratio, qkv_bias,
                     window_size=0 if i in global_attn_indexes else window_size, grid_size=grid)
            for i in range(depth)
        )
        self.neck = nn.Sequential(
            nn.Conv2d(embed_dim, out_chans, 1, bias=False),
            LayerNorm2d(out_chans),
            nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False),
            LayerNorm2d(out_chans),
        )

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
        tokens = self.patch_embed(x)  # (B, Ht, Wt, E)
        ht, wt = tokens.shape[1], tokens.shape[2]
        tokens = tokens + self.pos_embed[:, :ht, :wt].to(tokens.dtype)
        skips: List[torch.Tensor] = []
        for i, blk in enumerate(self.blocks):
            tokens = blk(tokens)
            if (i + 1) in self.extract_layers:
                skips.append(tokens)
        y = self.neck(tokens.permute(0, 3, 1, 2))
        return y.mean(dim=(2, 3)), y, skips
