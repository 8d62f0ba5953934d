"""Augmentation pipeline in numpy (port of `cellvit_tpu/data/transforms.py`,
whose cv2 calls this module replaces; reference
`experiment_cellvit_pannuke.py:648-780`).

Each transform is a callable `(img uint8 HWC, mask int HW C, rng) -> (img,
mask)`; `Compose` gives every loader thread its own generator spawned from
the seed's `SeedSequence`, so the draws, and their order, are the JAX
package's. Geometric ops move image and mask together (the mask by nearest
neighbour), photometric ops touch only the image.

The cv2 routines are rebuilt from their arithmetic (OpenCV 5):
- `resize` nearest: source index floor(x · (1 / (dst / src))); exact;
- `resize` linear on uint8: half-pixel centres, 11-bit weights, the
  horizontal pass in integers and the vertical one as OpenCV's SIMD rows
  compute it (each row sum shifted right by 4, multiplied by its weight
  keeping the high 16 bits, the two added, then (+2) >> 2); cv2 takes
  other arithmetic at some edge rows, where the two differ by 1 grey level;
- `blur`: the box sum over a BORDER_REFLECT_101 frame, divided and
  rounded half to even; exact;
- RGB→GRAY on uint8: 15-bit weights (9798, 19235, 3735); exact;
- RGB→HSV on uint8: OpenCV's 12-bit division tables; exact;
  HSV→RGB on uint8: the float formulas in float32, truncated as cv2 5
  stores them;
- `getAffineTransform`: the 6 × 6 system solved in float64;
- `GaussianBlur` on float32: the normalised float32 kernel applied as two
  1-D passes in float32 over a BORDER_REFLECT_101 frame;
- `warpAffine` and `remap`, BORDER_REFLECT_101: linear on float32 source
  coordinates, each tap's index reflected, lerped in float32 and rounded;
  nearest on the coordinates rounded as cv2 rounds them (warpAffine: 10-bit
  fixed point, remap: float rounded half to even).
The tests hold every transform against the JAX package's cv2 pipeline on
one thread with the same seed.

`build_transforms(transform_settings, input_shape)` reads the reference's
config keys and defaults and returns (train_pipeline, val_pipeline).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

Sample = Tuple[np.ndarray, np.ndarray]


# --------------------------------------------------------- cv2 arithmetic


def _reflect101(idx: np.ndarray, n: int) -> np.ndarray:
    """BORDER_REFLECT_101 indices (…, 2, 1 | 0, 1, …, n-1 | n-2, …)."""
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.abs(idx) % period
    return np.where(idx >= n, period - idx, idx)


def resize_nearest(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """cv2.resize(..., INTER_NEAREST)."""
    h, w = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(width) * (1.0 / (width / w))).astype(np.int64), w - 1)
    ys = np.minimum(np.floor(np.arange(height) * (1.0 / (height / h))).astype(np.int64), h - 1)
    return img[ys][:, xs]


def _linear_taps(src: int, dst: int):
    """Source indices and 11-bit weights of cv2's linear resize on one axis."""
    fx = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx
    low = sx < 0
    fx, sx = np.where(low, 0.0, fx), np.where(low, 0, sx)
    high = sx >= src - 1
    fx, sx = np.where(high, 0.0, fx), np.where(high, src - 1, sx)
    fx = fx.astype(np.float32)
    a1 = np.rint(fx * np.float32(2048)).astype(np.int64)
    a0 = np.rint((np.float32(1) - fx) * np.float32(2048)).astype(np.int64)
    return sx, np.minimum(sx + 1, src - 1), a0, a1


def resize_linear_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """cv2.resize(..., INTER_LINEAR) of an HWC uint8 image."""
    h, w = img.shape[:2]
    x0, x1, a0, a1 = _linear_taps(w, width)
    y0, y1, b0, b1 = _linear_taps(h, height)
    s = img.astype(np.int64)
    rows = s[:, x0] * a0[None, :, None] + s[:, x1] * a1[None, :, None]
    r0 = np.clip(rows[y0] >> 4, -32768, 32767)
    r1 = np.clip(rows[y1] >> 4, -32768, 32767)
    out = (((r0 * b0[:, None, None]) >> 16) + ((r1 * b1[:, None, None]) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def box_blur_u8(img: np.ndarray, k: int) -> np.ndarray:
    """cv2.blur(img, (k, k)) of an HWC uint8 image."""
    h, w = img.shape[:2]
    r = k // 2
    p = img.astype(np.int64)[_reflect101(np.arange(-r, h + r), h)][:, _reflect101(np.arange(-r, w + r), w)]
    c = np.cumsum(np.cumsum(np.pad(p, ((1, 0), (1, 0), (0, 0))), 0), 1)
    s = c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]
    return np.rint(s / (k * k)).astype(np.uint8)


def rgb_to_gray_u8(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_RGB2GRAY) on uint8."""
    x = img.astype(np.int64)
    return ((x[..., 0] * 9798 + x[..., 1] * 19235 + x[..., 2] * 3735 + (1 << 14)) >> 15).astype(np.uint8)


_I = np.arange(256)
_SDIV = np.where(_I == 0, 0, np.rint((255 << 12) / np.maximum(_I, 1))).astype(np.int64)
_HDIV = np.where(_I == 0, 0, np.rint((180 << 12) / (6.0 * np.maximum(_I, 1)))).astype(np.int64)
#: (b, g, r) rows of the tab [v, p, q, t] per hue sector (OpenCV's sector_data)
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def rgb_to_hsv_u8(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_RGB2HSV) on uint8 (hue in [0, 180))."""
    x = img.astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = (diff * _SDIV[v] + (1 << 11)) >> 12
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + (1 << 11)) >> 12
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def hsv_to_rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(hsv, COLOR_HSV2RGB) on uint8 (hue in [0, 180))."""
    one = np.float32(1)
    h = hsv[..., 0].astype(np.float32) * np.float32(6.0 / 180)
    s = hsv[..., 1].astype(np.float32) * np.float32(1 / 255.0)
    v = hsv[..., 2].astype(np.float32) * np.float32(1 / 255.0)
    h = np.where(h >= 6, h - np.float32(6), h)
    sector = np.floor(h).astype(np.int64)
    h = (h - sector).astype(np.float32)
    tab = np.stack([v, v * (one - s), v * (one - s * h), v * (one - s * (one - h))], -1)
    bgr = np.take_along_axis(tab, _SECTORS[sector], -1)
    return np.clip(np.floor(bgr[..., ::-1] * np.float32(255)), 0, 255).astype(np.uint8)


def get_affine_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """cv2.getAffineTransform: the 2 × 3 float64 map of 3 point pairs."""
    a = np.zeros((6, 6))
    for i in range(3):
        a[2 * i, :3] = a[2 * i + 1, 3:] = (src[i, 0], src[i, 1], 1.0)
    return np.linalg.solve(a, dst.astype(np.float64).reshape(6)).reshape(2, 3)


def gaussian_blur_f32(x: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(x, (ksize, ksize), sigma) of an HW float32 map."""
    t = np.exp(-0.5 / (sigma * sigma) * (np.arange(ksize) - (ksize - 1) * 0.5) ** 2)
    k = (t * (1.0 / t.sum())).astype(np.float32)
    r = ksize // 2
    h, w = x.shape
    p = x[_reflect101(np.arange(-r, h + r), h)][:, _reflect101(np.arange(-r, w + r), w)]
    rows = np.zeros((h + 2 * r, w), np.float32)
    for i in range(ksize):
        rows += p[:, i:i + w] * k[i]
    out = np.zeros((h, w), np.float32)
    for i in range(ksize):
        out += rows[i:i + h] * k[i]
    return out


def _bilinear(src: np.ndarray, fx: np.ndarray, fy: np.ndarray) -> np.ndarray:
    """Lerp at float32 source coordinates, taps reflected, rounded."""
    h, w = src.shape[:2]
    sx, sy = np.floor(fx).astype(np.int64), np.floor(fy).astype(np.int64)
    ax = (fx - sx).astype(np.float32)[..., None]
    ay = (fy - sy).astype(np.float32)[..., None]
    x0, x1 = _reflect101(sx, w), _reflect101(sx + 1, w)
    y0, y1 = _reflect101(sy, h), _reflect101(sy + 1, h)
    s = src.astype(np.float32)
    top = s[y0, x0] + (s[y0, x1] - s[y0, x0]) * ax
    bot = s[y1, x0] + (s[y1, x1] - s[y1, x0]) * ax
    return np.clip(np.rint(top + (bot - top) * ay), 0, 255).astype(src.dtype)


def warp_affine(src: np.ndarray, m: np.ndarray, nearest: bool = False) -> np.ndarray:
    """cv2.warpAffine(src, m, (w, h), flags, borderMode=BORDER_REFLECT_101):
    dst(x, y) = src(m⁻¹ · (x, y, 1)), linear or (`nearest`) nearest."""
    a = [float(v) for v in np.asarray(m, np.float64).reshape(-1)]
    d = a[0] * a[4] - a[1] * a[3]
    d = 1.0 / d if d != 0 else 0.0
    a[0], a[4] = a[4] * d, a[0] * d
    a[1] *= -d
    a[3] *= -d
    a[2], a[5] = -a[0] * a[2] - a[1] * a[5], -a[3] * a[2] - a[4] * a[5]
    h, w = src.shape[:2]
    if nearest:  # 10-bit fixed point, rounded to the nearest pixel
        scale = 1024
        xs, ys = np.arange(w), np.arange(h)
        adx = np.rint(a[0] * xs * scale).astype(np.int64)
        bdx = np.rint(a[3] * xs * scale).astype(np.int64)
        x0 = np.rint((a[1] * ys + a[2]) * scale).astype(np.int64) + scale // 2
        y0 = np.rint((a[4] * ys + a[5]) * scale).astype(np.int64) + scale // 2
        sx = (x0[:, None] + adx[None]) >> 10
        sy = (y0[:, None] + bdx[None]) >> 10
        return src[_reflect101(sy, h), _reflect101(sx, w)]
    mf = np.asarray(a, np.float32)
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij")
    return _bilinear(src, mf[0] * xx + mf[1] * yy + mf[2], mf[3] * xx + mf[4] * yy + mf[5])


def remap(src: np.ndarray, map_x: np.ndarray, map_y: np.ndarray, nearest: bool = False) -> np.ndarray:
    """cv2.remap(src, map_x, map_y, interpolation, BORDER_REFLECT_101) with
    float32 maps."""
    h, w = src.shape[:2]
    if nearest:
        return src[_reflect101(np.rint(map_y).astype(np.int64), h),
                   _reflect101(np.rint(map_x).astype(np.int64), w)]
    return _bilinear(src, map_x, map_y)


# ------------------------------------------------------------- pipeline


class Compose:
    """Transform pipeline with per-thread generators.

    The loader calls `__call__` from several worker threads; numpy
    Generators are not thread-safe, so each thread gets its own Generator
    spawned deterministically from the seed's SeedSequence. Reproducible
    draws across runs need a single-threaded loader (which thread takes
    which sample depends on scheduling)."""

    def __init__(self, transforms: List, seed: Optional[int] = None) -> None:
        self.transforms = transforms
        self.reseed(seed)

    def reseed(self, seed: Optional[int]) -> None:
        self._seed_seq = np.random.SeedSequence(seed)
        self._local = threading.local()
        self._lock = threading.Lock()

    @property
    def rng(self) -> np.random.Generator:
        rng = getattr(self._local, "rng", None)
        if rng is None:
            with self._lock:
                rng = np.random.default_rng(self._seed_seq.spawn(1)[0])
            self._local.rng = rng
        return rng

    def __call__(self, img: np.ndarray, mask: np.ndarray) -> Sample:
        rng = self.rng
        for t in self.transforms:
            img, mask = t(img, mask, rng)
        return img, mask


class _P:
    """Apply the wrapped op with probability p."""

    def __init__(self, p: float) -> None:
        self.p = p

    def __call__(self, img, mask, rng):
        if rng.random() < self.p:
            return self.apply(img, mask, rng)
        return img, mask

    def apply(self, img, mask, rng) -> Sample:  # pragma: no cover - abstract
        raise NotImplementedError


class RandomRotate90(_P):
    def apply(self, img, mask, rng):
        k = int(rng.integers(0, 4))
        return np.rot90(img, k).copy(), np.rot90(mask, k).copy()


class HorizontalFlip(_P):
    def apply(self, img, mask, rng):
        return img[:, ::-1].copy(), mask[:, ::-1].copy()


class VerticalFlip(_P):
    def apply(self, img, mask, rng):
        return img[::-1].copy(), mask[::-1].copy()


class Downscale(_P):
    def __init__(self, p: float, scale: float) -> None:
        super().__init__(p)
        self.scale = scale

    def apply(self, img, mask, rng):
        h, w = img.shape[:2]
        small = resize_nearest(img, int(w * self.scale), int(h * self.scale))
        return resize_nearest(small, w, h), mask


class Blur(_P):
    def __init__(self, p: float, blur_limit: int = 7) -> None:
        super().__init__(p)
        self.blur_limit = blur_limit

    def apply(self, img, mask, rng):
        k = int(rng.integers(1, self.blur_limit // 2 + 1)) * 2 + 1
        return box_blur_u8(img, k), mask


class GaussNoise(_P):
    def __init__(self, p: float, var_limit=(10.0, 50.0)) -> None:
        super().__init__(p)
        if np.isscalar(var_limit):
            var_limit = (0.0, float(var_limit))
        self.var_limit = var_limit

    def apply(self, img, mask, rng):
        var = rng.uniform(*self.var_limit)
        noise = rng.normal(0.0, var**0.5, img.shape)
        out = np.clip(img.astype(np.float32) + noise, 0, 255).astype(img.dtype)
        return out, mask


class ColorJitter(_P):
    """torchvision-style jitter: random brightness/contrast/saturation/hue
    factors applied in random order."""

    def __init__(self, p: float, brightness=0.5, contrast=0.5, saturation=0.1, hue=0.05) -> None:
        super().__init__(p)
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def apply(self, img, mask, rng):
        x = img.astype(np.float32)
        ops = list(range(4))
        rng.shuffle(ops)
        for op in ops:
            if op == 0 and self.brightness:
                f = rng.uniform(max(0, 1 - self.brightness), 1 + self.brightness)
                x = x * f
            elif op == 1 and self.contrast:
                f = rng.uniform(max(0, 1 - self.contrast), 1 + self.contrast)
                mean = rgb_to_gray_u8(np.clip(x, 0, 255).astype(np.uint8)).mean()
                x = (x - mean) * f + mean
            elif op == 2 and self.saturation:
                f = rng.uniform(max(0, 1 - self.saturation), 1 + self.saturation)
                gray = rgb_to_gray_u8(np.clip(x, 0, 255).astype(np.uint8)).astype(np.float32)[..., None]
                x = (x - gray) * f + gray
            elif op == 3 and self.hue:
                f = rng.uniform(-self.hue, self.hue)
                hsv = rgb_to_hsv_u8(np.clip(x, 0, 255).astype(np.uint8)).astype(np.float32)
                hsv[..., 0] = (hsv[..., 0] + f * 180.0) % 180.0
                x = hsv_to_rgb_u8(hsv.astype(np.uint8)).astype(np.float32)
        return np.clip(x, 0, 255).astype(img.dtype), mask


class Superpixels(_P):
    """Replace a random subset of grid segments by their mean colour
    (albumentations Superpixels with p_replace)."""

    def __init__(self, p: float, p_replace: float = 0.1, n_segments: int = 200,
                 max_size: Optional[int] = None) -> None:
        super().__init__(p)
        self.p_replace = p_replace
        self.n_segments = n_segments
        self.max_size = max_size

    def _grid_segments(self, h: int, w: int) -> np.ndarray:
        side = max(1, int(np.sqrt(self.n_segments)))
        gy = np.minimum((np.arange(h) * side) // h, side - 1)
        gx = np.minimum((np.arange(w) * side) // w, side - 1)
        return gy[:, None] * side + gx[None, :]

    def apply(self, img, mask, rng):
        h, w = img.shape[:2]
        seg = self._grid_segments(h, w)
        n = seg.max() + 1
        replace = rng.random(n) < self.p_replace
        if not replace.any():
            return img, mask
        out = img.copy()
        flat = seg.reshape(-1)
        for c in range(img.shape[2]):
            sums = np.bincount(flat, img[..., c].reshape(-1).astype(np.float64), n)
            counts = np.bincount(flat, minlength=n)
            means = (sums / np.maximum(counts, 1)).astype(img.dtype)
            ch = out[..., c]
            sel = replace[seg]
            ch[sel] = means[seg][sel]
        return out, mask


class ZoomBlur(_P):
    def __init__(self, p: float, max_factor: float = 1.05) -> None:
        super().__init__(p)
        self.max_factor = max_factor

    def apply(self, img, mask, rng):
        h, w = img.shape[:2]
        factors = np.linspace(1.0, rng.uniform(1.0, self.max_factor), 6)
        acc = np.zeros(img.shape, np.float32)
        for f in factors:
            nh, nw = int(h * f), int(w * f)
            zoomed = resize_linear_u8(img, nw, nh)
            y0, x0 = (nh - h) // 2, (nw - w) // 2
            acc += zoomed[y0:y0 + h, x0:x0 + w].astype(np.float32)
        out = np.clip(acc / len(factors), 0, 255).astype(img.dtype)
        return out, mask


class RandomSizedCrop(_P):
    def __init__(self, p: float, min_max_height: Tuple[int, int], height: int, width: int):
        super().__init__(p)
        self.min_max_height = (int(min_max_height[0]), int(min_max_height[1]))
        self.height = height
        self.width = width

    def apply(self, img, mask, rng):
        h, w = img.shape[:2]
        ch = int(rng.integers(self.min_max_height[0], self.min_max_height[1] + 1))
        ch = min(ch, h, w)
        y0 = int(rng.integers(0, h - ch + 1))
        x0 = int(rng.integers(0, w - ch + 1))
        img_c = img[y0:y0 + ch, x0:x0 + ch]
        mask_c = mask[y0:y0 + ch, x0:x0 + ch]
        img_r = resize_linear_u8(img_c, self.width, self.height)
        mask_r = resize_nearest(mask_c.astype(np.int32), self.width, self.height)
        return img_r, mask_r


class ElasticTransform(_P):
    """Gaussian-smoothed random displacement + random affine
    (albumentations ElasticTransform semantics with sigma/alpha/alpha_affine)."""

    def __init__(self, p: float, alpha: float = 0.5, sigma: float = 25.0,
                 alpha_affine: float = 15.0) -> None:
        super().__init__(p)
        self.alpha = alpha
        self.sigma = sigma
        self.alpha_affine = alpha_affine

    def apply(self, img, mask, rng):
        h, w = img.shape[:2]
        center = np.float32([w, h]) / 2
        sq = min(h, w) // 3
        pts1 = np.float32([center + sq, [center[0] + sq, center[1] - sq], center - sq])
        pts2 = pts1 + rng.uniform(-self.alpha_affine, self.alpha_affine, pts1.shape).astype(np.float32)
        m = get_affine_transform(pts1, pts2)

        dx = gaussian_blur_f32(rng.uniform(-1, 1, (h, w)).astype(np.float32), 17, self.sigma) * self.alpha
        dy = gaussian_blur_f32(rng.uniform(-1, 1, (h, w)).astype(np.float32), 17, self.sigma) * self.alpha
        xx, yy = np.meshgrid(np.arange(w), np.arange(h))
        map_x = (xx + dx).astype(np.float32)
        map_y = (yy + dy).astype(np.float32)

        img_o = remap(warp_affine(img, m), map_x, map_y)
        mask_o = remap(warp_affine(mask.astype(np.int32), m, nearest=True), map_x, map_y, nearest=True)
        return img_o, mask_o


class Normalize:
    """(img/255 - mean)/std — albumentations A.Normalize semantics."""

    def __init__(self, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)) -> None:
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, img, mask, rng=None):
        img = img.astype(np.float32) / 255.0
        return (img - self.mean) / self.std, mask


def build_transforms(transform_settings: Dict, input_shape: int = 256,
                     seed: Optional[int] = None) -> Tuple[Compose, Compose]:
    """Config → (train, val) pipelines, with the reference's keys and
    parameter plumbing (experiment_cellvit_pannuke.py:648-780)."""
    ts = {k.lower(): v for k, v in (transform_settings or {}).items()}
    tl: List = []

    def p_of(key: str) -> float:
        p = ts[key].get("p", 0) if isinstance(ts.get(key), dict) else 0
        return p if (p and 0 < p <= 1) else 0

    if p_of("randomrotate90"):
        tl.append(RandomRotate90(p_of("randomrotate90")))
    if p_of("horizontalflip"):
        tl.append(HorizontalFlip(p_of("horizontalflip")))
    if p_of("verticalflip"):
        tl.append(VerticalFlip(p_of("verticalflip")))
    if p_of("downscale"):
        tl.append(Downscale(p_of("downscale"), ts["downscale"]["scale"]))
    if p_of("blur"):
        tl.append(Blur(p_of("blur"), ts["blur"]["blur_limit"]))
    if p_of("gaussnoise"):
        tl.append(GaussNoise(p_of("gaussnoise"), ts["gaussnoise"]["var_limit"]))
    if p_of("colorjitter"):
        s = ts["colorjitter"]
        tl.append(ColorJitter(p_of("colorjitter"), brightness=s["scale_setting"],
                              contrast=s["scale_setting"], saturation=s["scale_color"],
                              hue=s["scale_color"] / 2))
    if p_of("superpixels"):
        tl.append(Superpixels(p_of("superpixels"), p_replace=0.1, n_segments=200,
                              max_size=input_shape // 2))
    if p_of("zoomblur"):
        tl.append(ZoomBlur(p_of("zoomblur"), max_factor=1.05))
    if p_of("randomsizedcrop"):
        tl.append(RandomSizedCrop(p_of("randomsizedcrop"),
                                  min_max_height=(input_shape // 2, input_shape),
                                  height=input_shape, width=input_shape))
    if p_of("elastictransform"):
        tl.append(ElasticTransform(p_of("elastictransform"), alpha=0.5, sigma=25, alpha_affine=15))

    if "normalize" in ts:
        mean = ts["normalize"].get("mean", (0.5, 0.5, 0.5))
        std = ts["normalize"].get("std", (0.5, 0.5, 0.5))
    else:
        mean, std = (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)
    tl.append(Normalize(mean, std))
    return Compose(tl, seed=seed), Compose([Normalize(mean, std)], seed=seed)
