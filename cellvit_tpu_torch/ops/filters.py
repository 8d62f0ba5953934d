"""cv2-parity separable filters (port of `cellvit_tpu/ops/filters.py`).

Sobel (ksize 21 and 11) and 3×3 Gaussian for the HV postprocessing, as 1-D
correlations under cv2's default BORDER_REFLECT_101 — `F.pad(mode="reflect")`
is that border — over (…, H, W) fp32 maps. The convolutions run in full fp32:
cuDNN's TF32 default would round away the Sobel kernels' large integer
coefficients.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

GAUSS_3 = np.array([0.25, 0.5, 0.25])  # cv2.getGaussianKernel(3, 0)


def binomial_row(order: int) -> np.ndarray:
    """Pascal-triangle row: coefficients of (1+x)**order."""
    row = np.array([1.0])
    for _ in range(order):
        row = np.convolve(row, [1.0, 1.0])
    return row


def sobel_kernels_1d(ksize: int) -> Tuple[np.ndarray, np.ndarray]:
    """(derivative, smoothing) kernels of cv2.getDerivKernels(1, 0, ksize),
    in correlation layout."""
    smooth = binomial_row(ksize - 1)
    deriv = np.convolve(binomial_row(ksize - 3), [1.0, 0.0, -1.0])[::-1]
    return deriv, smooth


_TAPS: Dict[Tuple[bytes, torch.device], torch.Tensor] = {}


def _taps(kernel: np.ndarray, device: torch.device) -> torch.Tensor:
    """`kernel` as a (1, 1, K) fp32 conv1d weight on `device`, copied there once."""
    key = (kernel.tobytes(), device)
    if key not in _TAPS:
        _TAPS[key] = torch.from_numpy(kernel.copy()).to(device).view(1, 1, -1)
    return _TAPS[key]


def _correlate_1d(x: torch.Tensor, kernel: np.ndarray, axis: int) -> torch.Tensor:
    """Correlate (…, H, W) with `kernel` along axis -1 or -2, reflect-101 border."""
    r = len(kernel) // 2
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    xf = x.float().reshape(-1, h, w)
    if axis == -2:
        xf = xf.transpose(1, 2)
    n = xf.shape[-1]
    lines = F.pad(xf.reshape(-1, 1, n), (r, r), mode="reflect")
    k = _taps(np.asarray(kernel, np.float32), x.device)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        out = F.conv1d(lines, k).reshape(xf.shape)
    if axis == -2:
        out = out.transpose(1, 2)
    return out.reshape(*lead, h, w)


def filter_rows(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Correlate along the last axis (W) of (…, H, W)."""
    return _correlate_1d(x, kernel, -1)


def filter_cols(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Correlate along the second-to-last axis (H) of (…, H, W)."""
    return _correlate_1d(x, kernel, -2)


def sobel(x: torch.Tensor, dx: int, dy: int, ksize: int) -> torch.Tensor:
    """cv2.Sobel(x, CV_32F, dx, dy, ksize) for (…, H, W) inputs, dx + dy == 1."""
    deriv, smooth = sobel_kernels_1d(ksize)
    if dx == 1:
        return filter_cols(filter_rows(x, deriv), smooth)
    return filter_rows(filter_cols(x, deriv), smooth)


def gaussian_blur_3x3(x: torch.Tensor) -> torch.Tensor:
    """cv2.GaussianBlur(x, (3, 3), 0) for (…, H, W) inputs."""
    return filter_cols(filter_rows(x, GAUSS_3), GAUSS_3)


def minmax_normalize(x: torch.Tensor) -> torch.Tensor:
    """cv2.normalize(NORM_MINMAX, 0, 1) over the trailing two axes."""
    lo = x.amin(dim=(-2, -1), keepdim=True)
    hi = x.amax(dim=(-2, -1), keepdim=True)
    rng = hi - lo
    return torch.where(rng > 0, (x - lo) / torch.where(rng > 0, rng, 1.0), 0.0)
