"""Converging connected components, hole filling, small-object removal and
morphology on (B, H, W) batches (port of `cellvit_tpu/ops/cc.py`).

These are the JAX package's CPU path (`use_pallas=False`): each image runs
its own loop of passes until a pass changes nothing or `max_iters` is
reached, as a `while_loop` under `vmap` does — every image keeps its own
iteration count and freezes when it stops. Convergence is tested on the host
every `check_every` passes; further passes on a finished image change
nothing and are discarded.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from cellvit_tpu_torch.ops.cc_cuda import INT_MAX, border_seed, raster_ids, segmented_scan


def iterate_per_image(
    step: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    max_iters: int,
    check_every: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run `x ← step(x, it)` per image (dim 0) while the image changed on its
    last pass and its count `it` < `max_iters`. Returns (x, it)."""
    b = x.shape[0]
    active = torch.ones(b, dtype=torch.bool, device=x.device)
    it = torch.zeros(b, dtype=torch.int32, device=x.device)
    bshape = (b,) + (1,) * (x.dim() - 1)
    while True:
        for _ in range(check_every):
            new = step(x, it)
            changed = (new != x).reshape(b, -1).any(dim=1)
            x = torch.where(active.view(bshape), new, x)
            it = it + active.to(torch.int32)
            active = active & changed & (it < max_iters)
        if not bool(active.any()):
            return x, it


def shift(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[…, i, j] = x[…, i + dy, j + dx], `fill` outside the image."""
    h, w = x.shape[-2:]
    out = torch.full_like(x, fill)
    ys, ye = max(0, -dy), h - max(0, dy)
    xs, xe = max(0, -dx), w - max(0, dx)
    if ye > ys and xe > xs:
        out[..., ys:ye, xs:xe] = x[..., ys + dy:ye + dy, xs + dx:xe + dx]
    return out


_NEIGHBORS = ((-1, 0), (1, 0), (0, -1), (0, 1))


def _neighbor_min(lab: torch.Tensor, fg: torch.Tensor) -> torch.Tensor:
    """Min label over the 4-neighbourhood, restricted to foreground."""
    out = lab
    for dy, dx in _NEIGHBORS:
        nb = shift(lab, dy, dx, INT_MAX)
        nb_fg = shift(fg, dy, dx, False)
        out = torch.minimum(out, torch.where(nb_fg, nb, INT_MAX))
    return torch.where(fg, out, INT_MAX)


def _propagate_pass(lab: torch.Tensor, fg: torch.Tensor) -> torch.Tensor:
    bg = ~fg
    v = torch.where(fg, lab, INT_MAX)
    for dim in (1, 2):
        for reverse in (False, True):
            v = segmented_scan(v, bg, dim, reverse, torch.minimum, INT_MAX)
            v = torch.where(fg, v, INT_MAX)
    return _neighbor_min(v, fg)


def connected_components(fg: torch.Tensor, max_iters: int = 64,
                         compact: bool = True) -> torch.Tensor:
    """4-connected labelling of (B, H, W) bool masks → int32, background 0.
    compact=True numbers components 1..N in scipy raster order; compact=False
    gives root labels (component-min linear index + 1)."""
    b, h, w = fg.shape
    lab = torch.where(fg, raster_ids(h, w, fg.device), INT_MAX)
    lab, _ = iterate_per_image(lambda l, it: _propagate_pass(l, fg), lab, max_iters)
    roots = torch.where(fg, lab + 1, 0).to(torch.int32)
    return compact_root_labels(roots) if compact else roots


def compact_root_labels(lab: torch.Tensor) -> torch.Tensor:
    """Root labels → consecutive 1..N in raster order of roots, by a cumsum
    gather."""
    b, h, w = lab.shape
    n = h * w
    flat = lab.reshape(b, n)
    fg = flat > 0
    is_root = fg & (flat - 1 == torch.arange(n, dtype=lab.dtype, device=lab.device))
    new_id = torch.cumsum(is_root, dim=1, dtype=torch.int32)
    idx = (flat.long() - 1).clamp(0, n - 1)
    return torch.where(fg, torch.gather(new_id, 1, idx), 0).reshape(b, h, w)


def _wrap_ids(labels: torch.Tensor, n: int) -> torch.Tensor:
    """(B, H, W) ids → (B, H·W) int64, a negative id counted from the end
    (JAX's index normalisation)."""
    ids = labels.reshape(labels.shape[0], -1).long()
    return torch.where(ids < 0, ids + n, ids)


def component_sizes(labels: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(B, H, W) labels → (B, num_segments) int32 pixel count per id (index
    0 = background). As JAX's scatter-add, an id outside [0, num_segments)
    after the wrap of negative ids is dropped."""
    ids = _wrap_ids(labels, num_segments)
    ok = (ids >= 0) & (ids < num_segments)
    sizes = torch.zeros((labels.shape[0], num_segments), dtype=torch.int32, device=labels.device)
    return sizes.scatter_add_(1, torch.where(ok, ids, 0), ok.to(torch.int32))


def remove_small_objects(labels: torch.Tensor, min_size: int, num_segments: int) -> torch.Tensor:
    """Zero components smaller than `min_size` (skimage semantics), by a
    size scatter and a gather; the gather clamps ids, as JAX's does."""
    keep = component_sizes(labels, num_segments) >= min_size
    idx = _wrap_ids(labels, num_segments).clamp(0, num_segments - 1)
    return torch.where(torch.gather(keep, 1, idx).reshape(labels.shape), labels, 0)


def radix_bins(labels: torch.Tensor, hi_bins: int, lo_bins: int) -> torch.Tensor:
    """Each id's flat radix bin hi·lo_bins + lo, with hi = clip(id ÷ lo_bins,
    0, hi_bins − 1) and lo = clip(id − hi·lo_bins, 0, lo_bins − 1): ids past
    the table fall into its top bins, label 0 into bin 0."""
    hi = torch.div(labels, lo_bins, rounding_mode="floor").clamp(0, hi_bins - 1)
    lo = (labels - hi * lo_bins).clamp(0, lo_bins - 1)
    return hi * lo_bins + lo


def radix_histogram(labels: torch.Tensor, hi_bins: int = 64, lo_bins: int = 128) -> torch.Tensor:
    """(B, H, W) ids → (B, hi_bins, lo_bins) fp32 pixel counts per radix bin
    (the output of the JAX package's `_hist_kernel`)."""
    b = labels.shape[0]
    bins = radix_bins(labels, hi_bins, lo_bins).reshape(b, -1).long()
    hist = torch.zeros((b, hi_bins * lo_bins), dtype=torch.int32, device=labels.device)
    hist.scatter_add_(1, bins, torch.ones_like(bins, dtype=torch.int32))
    return hist.float().reshape(b, hi_bins, lo_bins)


def radix_keep(labels: torch.Tensor, hist: torch.Tensor, min_size: int,
               max_labels: Optional[int] = None) -> torch.Tensor:
    """Keep a pixel's id iff it is > 0 and its bin of the (B, hi_bins,
    lo_bins) `hist` holds ≥ `min_size` pixels, or the id is ≥ `max_labels`
    (default hi_bins·lo_bins, the JAX package's `_rm_mapback_kernel`)."""
    b, hi_bins, lo_bins = hist.shape
    max_labels = hi_bins * lo_bins if max_labels is None else max_labels
    bins = radix_bins(labels, hi_bins, lo_bins).reshape(b, -1).long()
    small = torch.gather((hist < min_size).reshape(b, -1), 1, bins).reshape(labels.shape)
    keep = (labels > 0) & (~small | (labels >= max_labels))
    return torch.where(keep, labels, 0).to(torch.int32)


def remove_small_objects_bincount(labels: torch.Tensor, min_size: int, max_labels: int = 8192,
                                  hi_bins: int = 64) -> torch.Tensor:
    """`remove_small_objects` for compacted labels by a radix histogram of
    `hi_bins` × max_labels ÷ hi_bins bins. Exact for ids below the table;
    past it the top bin's count is inflated (a small component may be kept,
    never one removed in error), and ids ≥ `max_labels` are always kept."""
    if min_size <= 1:
        return labels
    hist = radix_histogram(labels, hi_bins, max_labels // hi_bins)
    return radix_keep(labels, hist, min_size, max_labels)


def remove_small_objects_window(labels: torch.Tensor, min_size: int) -> torch.Tensor:
    """Zero components of fewer than `min_size` pixels, scatter-free: a pixel
    is kept iff its (2·min_size − 1)² window holds ≥ min_size pixels of its
    own label (exact for any shape; see the JAX twin for the proof)."""
    if min_size <= 1:
        return labels
    r = min_size - 1
    h, w = labels.shape[-2:]
    padded = torch.nn.functional.pad(labels, (r, r, r, r), value=0)
    cnt = torch.zeros(labels.shape, dtype=torch.int32, device=labels.device)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            cnt += padded[..., dy:dy + h, dx:dx + w] == labels
    keep = (labels > 0) & (cnt >= min_size)
    return torch.where(keep, labels, 0)


def _segmented_or_pass(reach: torch.Tensor, mask: torch.Tensor, bg: torch.Tensor) -> torch.Tensor:
    v = reach.to(torch.int32)
    for dim in (1, 2):
        for reverse in (False, True):
            v = segmented_scan(v, mask, dim, reverse, torch.bitwise_or, 0)
            v = v & bg.to(torch.int32)
    v = v != 0
    out = v
    for dy, dx in _NEIGHBORS:
        out = out | shift(v, dy, dx, False)
    return out & bg


def fill_holes(mask: torch.Tensor, max_iters: int = 64) -> torch.Tensor:
    """scipy binary_fill_holes on (B, H, W): background not reachable from
    the border (4-connected) is a hole."""
    bg = ~mask
    reach = border_seed(mask).expand_as(mask).clone()
    reach, _ = iterate_per_image(lambda r, it: _segmented_or_pass(r, mask, bg), reach, max_iters)
    return mask | (bg & ~reach)


# cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (5, 5))
ELLIPSE_5 = np.array(
    [
        [0, 0, 1, 0, 0],
        [1, 1, 1, 1, 1],
        [1, 1, 1, 1, 1],
        [1, 1, 1, 1, 1],
        [0, 0, 1, 0, 0],
    ],
    dtype=bool,
)


def _stencil(mask: torch.Tensor, se: np.ndarray, op: str) -> torch.Tensor:
    """Erode/dilate (…, H, W) bool masks; outside counts as foreground for
    erosion and background for dilation (cv2's defaults)."""
    r0, r1 = se.shape[0] // 2, se.shape[1] // 2
    h, w = mask.shape[-2:]
    padded = torch.nn.functional.pad(
        mask.to(torch.uint8), (r1, r1, r0, r0), value=int(op == "erode")
    ).to(torch.bool)
    acc = None
    for dy in range(se.shape[0]):
        for dx in range(se.shape[1]):
            if not se[dy, dx]:
                continue
            nb = padded[..., dy:dy + h, dx:dx + w]
            if acc is None:
                acc = nb
            elif op == "erode":
                acc = acc & nb
            else:
                acc = acc | nb
    return acc


def morph_open(mask: torch.Tensor, se: np.ndarray = ELLIPSE_5) -> torch.Tensor:
    """cv2.morphologyEx(MORPH_OPEN): erosion then dilation."""
    return _stencil(_stencil(mask, se, "erode"), se, "dilate")
