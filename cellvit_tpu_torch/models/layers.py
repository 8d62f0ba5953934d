"""Shared building blocks (port of `cellvit_tpu/models/layers.py`).

Modules work on NCHW tensors, PyTorch's convention; the models convert at
their public entry points, which keep the JAX package's NHWC layout.
Sub-module names follow the reference torch modules (`Conv2DBlock`,
`Deconv2DBlock`: `block.0`, `block.1`, …), so reference state dicts load
with `load_state_dict`.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm (eps 1e-5, momentum 0.1 ≡ flax's 0.9) whose running variance
    follows flax's `nn.BatchNorm`, which the JAX package trains with: the
    biased batch variance, where `nn.BatchNorm2d` keeps the unbiased one.
    Training normalises with the batch statistics; evaluation with the
    running ones. The keys stay `weight`, `bias`, `running_mean`,
    `running_var` and `num_batches_tracked`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class Dropout(nn.Module):
    """Elementwise dropout whose mask draws from `self.generator` (set by
    `use_generator`; torch's default generator when None)."""

    def __init__(self, p: float = 0.0) -> None:
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=self.generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def drop_path(x: torch.Tensor, rate: float, training: bool,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stochastic depth: drop the residual branch per sample, scaling the
    kept ones by 1 / (1 − rate)."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand((x.shape[0],), generator=generator, device=x.device) < keep
    mask = mask.reshape((-1,) + (1,) * (x.ndim - 1))
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class DropPath(nn.Module):
    """`drop_path` as a module, drawing from `self.generator`."""

    def __init__(self, rate: float = 0.0) -> None:
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return drop_path(x, self.rate, self.training, self.generator)


def use_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Point every `Dropout` and `DropPath` of `model` at `generator`."""
    for m in model.modules():
        if isinstance(m, (Dropout, DropPath)):
            m.generator = generator


class ConvBNRelu(nn.Module):
    """Conv(k, SAME) → BatchNorm (eps 1e-5) → ReLU (→ dropout); reference
    `Conv2DBlock`."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 dropout: float = 0.0) -> None:
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, kernel_size, padding=(kernel_size - 1) // 2),
            BatchNorm2d(out_channels, eps=1e-5),
            nn.ReLU(),
            Dropout(dropout),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class ConvTranspose2x2(nn.Module):
    """2×2-kernel, stride-2 transposed convolution:

        out[b, f, 2h+p, 2w+q] = Σ_c x[b, c, h, w] · W[c, f, p, q] + bias[f]

    with the torch `ConvTranspose2d(k=2, s=2)` weight layout (C_in, C_out, 2, 2)."""

    def __init__(self, in_channels: int, out_channels: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, 2, 2))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        nn.init.trunc_normal_(self.weight, std=0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight, self.bias, stride=2)


class DeconvBlock(nn.Module):
    """ConvTranspose2x2 → Conv(k) → BN → ReLU (→ dropout); reference
    `Deconv2DBlock`."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 dropout: float = 0.0) -> None:
        super().__init__()
        self.block = nn.Sequential(
            ConvTranspose2x2(in_channels, out_channels),
            nn.Conv2d(out_channels, out_channels, kernel_size, padding=(kernel_size - 1) // 2),
            BatchNorm2d(out_channels, eps=1e-5),
            nn.ReLU(),
            Dropout(dropout),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class PatchEmbed(nn.Module):
    """16×16/s16 patch projection: (B, C, H, W) → (B, H/16, W/16, E)."""

    def __init__(self, embed_dim: int, patch_size: int = 16, in_chans: int = 3) -> None:
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).permute(0, 2, 3, 1)


class Mlp(nn.Module):
    """Transformer MLP with exact-erf GELU, dropout after the GELU and after
    fc2."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, dropout: float = 0.0) -> None:
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden_dim, out_dim)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop(self.fc2(self.drop(self.act(self.fc1(x)))))


def compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype a layer computes in: autocast's where autocast is on for
    x's device (mixed precision keeps fp32 parameters), else x's own."""
    dev = x.device.type
    return torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else x.dtype


class LayerNorm(nn.LayerNorm):
    """`nn.LayerNorm` that, in evaluation, returns `compute_dtype(x)`: under
    autocast its output reaches the bf16 kernels in bf16, as flax's
    LayerNorm with dtype bf16 returns it in the JAX package's mixed
    precision (CUDA autocast would return fp32). The statistics are taken
    in fp32 inside the one bf16 pass; the affine parameters are cast to bf16
    at use, as autocast casts every Linear and conv weight (flax keeps these
    two in fp32: a normalisation in fp32 with fp32 affine parameters would
    move five times the bytes, ≈14 ms of a SAM-H batch, since CUDA's layer
    norm takes no bf16 input with fp32 parameters). Training keeps
    `nn.LayerNorm`, whose autocast runs in fp32 as the reference's AMP does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return super().forward(x)
        dtype = compute_dtype(x)
        with torch.autocast(x.device.type, enabled=False):
            return F.layer_norm(x.to(dtype), self.normalized_shape, self.weight.to(dtype),
                                self.bias.to(dtype), self.eps)


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of an NCHW map (the SAM neck's
    LayerNorm2d): biased variance, eps 1e-6, computed in fp32, returned in
    the input's dtype."""

    def __init__(self, channels: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(1, keepdim=True)
        var = (x32 - mean).square().mean(1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight.float()[:, None, None] + self.bias.float()[:, None, None]).to(x.dtype)


@lru_cache(maxsize=32)
def _resize_matrix_np(n_in: int, n_out: int, scale: float, mode: str) -> np.ndarray:
    a = -0.75

    def cubic(t: np.ndarray) -> np.ndarray:
        t = np.abs(t)
        return np.where(
            t <= 1.0,
            (a + 2.0) * t**3 - (a + 3.0) * t**2 + 1.0,
            np.where(t < 2.0, a * t**3 - 5.0 * a * t**2 + 8.0 * a * t - 4.0 * a, 0.0),
        )

    mat = np.zeros((n_out, n_in), dtype=np.float64)
    for i in range(n_out):
        src = (i + 0.5) / scale - 0.5
        base = int(np.floor(src))
        if mode == "bicubic":
            idx = np.arange(base - 1, base + 3)
            w = cubic(src - idx)
        elif mode == "linear":
            idx = np.array([base, base + 1])
            w = np.array([1.0 - (src - base), src - base])
        else:
            raise ValueError(f"unknown resize mode {mode}")
        for j, wj in zip(np.clip(idx, 0, n_in - 1), w):
            mat[i, j] += wj
    return mat.astype(np.float32)


def resize_matrix_1d(n_in: int, n_out: int, scale: float, mode: str = "bicubic") -> torch.Tensor:
    """Dense (n_out, n_in) resize operator with torch `F.interpolate`
    semantics for an explicit `scale_factor`: src = (dst + 0.5) / scale − 0.5
    (align_corners=False), source indices clamped; "bicubic" is cubic
    convolution with a = −0.75 (the DINO pos-emb), "linear" two-tap linear
    weights (SAM's rel-pos tables). Taking `scale` explicitly keeps callers'
    scale fudges exact."""
    return torch.from_numpy(_resize_matrix_np(n_in, n_out, float(scale), mode))
