"""Fixed-pass connected components, label compaction and border flood, the
size filters and the level-sweep watershed (port of
`cellvit_tpu/ops/cc_pallas.py`: `connected_components_pallas`,
`propagate_min_pallas` / `compact_root_labels_pallas`, `flood_pallas` /
`fill_holes_pallas`; `remove_small_objects_pallas`,
`remove_small_objects_bincount_pallas` and `watershed_pallas` at the end).

Each op runs `n_outer` passes of four directional segmented scans — axis 0
forward, axis 0 reverse, axis 1 forward, axis 1 reverse, each followed by a
re-mask — exactly the Pallas kernels' schedule, so on shapes that need more
turns than `n_outer` the result equals the Pallas kernel's, not a converged
labeler's. On a CPU tensor the plain versions below run, which scan by the
same doubling steps as the Pallas kernels (`_segmin_direction`,
`_segor_direction`). On a CUDA tensor each op is one launch that applies a
pass as two run broadcasts (columns, then rows): a forward scan, the re-mask
and a reverse scan give each open pixel the minimum (or OR) of its whole
run. Connected components and min-propagation run `csrc/seg_min.cu`, with
each image's int32 state resident in the shared memory of a group of
blocks; the flood and hole filling run `csrc/flood_bits.cu`, with each
image's state and mask packed one bit a pixel in the registers of a
thread-block cluster. Every exact schedule gives the same bits, so kernels
and plain versions agree exactly. The sweep watershed runs every pass of a
call in one launch of `csrc/watershed.cu` (bit-packed frontier, tiles with
halos, a counter barrier among an image's tiles).
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch

from cellvit_tpu_torch import _build

INT_MAX = torch.iinfo(torch.int32).max
#: `csrc/seg_min.cu` (B2, B4) keeps a 128 × 256 tile in each block and folds
#: runs across at most 12 tiles down a column and 8 along a row
RESIDENT_TILE = (128, 256)
RESIDENT_MAX_HW = (12 * 128, 8 * 256)
#: the barrier words of `seg_min.cu` and `watershed.cu`, two per group of
#: one image's tiles (512 groups)
_SYNC_WORDS = 2 * 512
#: `csrc/flood_bits.cu` (B3) holds an image in the registers of a cluster
#: of at most 8 blocks of 32 warps, a warp's thread at most 16 words of 32
#: pixels of each of the state and the mask: ≤ 64 words a row, and rows
#: ≤ 8 blocks · 32 warps · 8 rows at 33-64 words a row
FLOOD_MAX_HW = (2048, 2048)
#: its blocks an image (a cluster): 8, the portable maximum, took less time
#: than 2 or 4 (`scripts/flood_bits_variants.py`)
FLOOD_CLUSTER = 8

#: `csrc/watershed.cu` (B9) keeps quantized heights in a byte up to 256
#: levels and in 16 bits up to this many
WATERSHED_MAX_LEVELS = 65535

Op = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


# ----------------------------------------------------------- plain versions


def segmented_scan(v: torch.Tensor, barrier: torch.Tensor, dim: int, reverse: bool,
                   op: Op, ident: int) -> torch.Tensor:
    """Inclusive segmented scan of `v` along `dim`; barrier pixels reset the
    running value and keep their own. Doubling steps as in the Pallas kernel:
    v ← b ? v : op(v, shift(v, k)); b ← b | shift(b, k)."""
    if reverse:
        v, barrier = v.flip(dim), barrier.flip(dim)
    n = v.shape[dim]
    b = barrier
    shift = 1
    while shift < n:
        fill_shape = list(v.shape)
        fill_shape[dim] = shift
        t = torch.cat([v.new_full(fill_shape, ident), v.narrow(dim, 0, n - shift)], dim)
        tb = torch.cat([b.new_ones(fill_shape), b.narrow(dim, 0, n - shift)], dim)
        v = torch.where(b, v, op(v, t))
        b = b | tb
        shift *= 2
    return v.flip(dim) if reverse else v


def _passes(v: torch.Tensor, open_: torch.Tensor, n_outer: int, op: Op, ident: int) -> torch.Tensor:
    closed = ~open_
    for _ in range(n_outer):
        for dim in (1, 2):
            for reverse in (False, True):
                v = segmented_scan(v, closed, dim, reverse, op, ident)
                v = torch.where(open_, v, ident)
    return v


def raster_ids(h: int, w: int, device) -> torch.Tensor:
    """(1, H, W) int32 linear pixel indices."""
    return torch.arange(h * w, dtype=torch.int32, device=device).reshape(1, h, w)


def connected_components_plain(fg: torch.Tensor, n_outer: int = 3) -> torch.Tensor:
    """(B, H, W) bool → (B, H, W) int32 root labels (component-min linear
    index + 1, background 0) after `n_outer` passes."""
    lab = torch.where(fg, raster_ids(*fg.shape[1:], fg.device), INT_MAX)
    lab = _passes(lab, fg, n_outer, torch.minimum, INT_MAX)
    return torch.where(fg, lab + 1, 0).to(torch.int32)


def propagate_min_plain(seed: torch.Tensor, fg: torch.Tensor, n_outer: int = 3) -> torch.Tensor:
    """Min-propagate int32 `seed` over the 4-connected components of `fg`
    (INT_MAX on background and where no finite seed reaches)."""
    v = torch.where(fg, seed.to(torch.int32), INT_MAX)
    return _passes(v, fg, n_outer, torch.minimum, INT_MAX)


def flood_plain(seed: torch.Tensor, open_: torch.Tensor, n_outer: int = 2) -> torch.Tensor:
    """Grow bool `seed` through bool `open_` pixels (4-connectivity)."""
    v = (seed & open_).to(torch.int32)
    return _passes(v, open_, n_outer, torch.bitwise_or, 0) != 0


# ----------------------------------------------------------- kernel wrappers


def _check_mask(name: str, t: torch.Tensor, max_hw) -> torch.Tensor:
    if t.dim() != 3:
        raise ValueError(f"{name} must be (B, H, W); got {tuple(t.shape)}")
    for size, limit, what in zip(t.shape[1:], max_hw, ("height", "width")):
        if limit is not None and size > limit:
            raise ValueError(f"{name}: {what} {size} exceeds the kernel's {limit}")
    return t.to(torch.bool).contiguous()


_sync: dict = {}


def _sync_words(t: torch.Tensor):
    """The barrier words of the kernels with a counter barrier among blocks
    (`csrc/seg_min.cu`, `csrc/watershed.cu`), which each call leaves at 0:
    one zeroed buffer per device and stream, made at first use and shared,
    since calls on one stream run one after another. Returns (sync words,
    stream)."""
    stream = _build.stream_of(t)
    sync = _sync.get((t.device, stream))
    if sync is None:
        sync = _sync[(t.device, stream)] = torch.zeros(_SYNC_WORDS, dtype=torch.int32, device=t.device)
    return sync, stream


def _resident_scratch(fg: torch.Tensor):
    """`csrc/seg_min.cu`'s workspace (per image, one int4 summary per line
    and tile, both axes; uninitialised) and its barrier words. Returns
    (workspace, sync words, stream)."""
    b, h, w = fg.shape
    ty, tx = -(-h // RESIDENT_TILE[0]), -(-w // RESIDENT_TILE[1])
    ws = torch.empty(b * (w * ty + h * tx) * 4, dtype=torch.int32, device=fg.device)
    return (ws, *_sync_words(fg))


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def connected_components_cuda(fg: torch.Tensor, n_outer: int = 3) -> torch.Tensor:
    """Root labels by `n_outer` scan passes (kernel B2 on CUDA)."""
    if _device_kind(fg) == "cpu":
        return connected_components_plain(fg, n_outer)
    fg = _check_mask("fg", fg, RESIDENT_MAX_HW)
    b, h, w = fg.shape
    lab = torch.empty((b, h, w), dtype=torch.int32, device=fg.device)
    ws, sync, stream = _resident_scratch(fg)
    fn = _build.bind("seg_min.cu", "cc_labels", "ppppiiii")
    _build.LAUNCHES["connected_components"] += 1
    _build.check(fn(fg.data_ptr(), lab.data_ptr(), sync.data_ptr(), ws.data_ptr(), b, h, w, n_outer,
                    stream), "cc_labels")
    return lab


def propagate_min_cuda(seed: torch.Tensor, fg: torch.Tensor, n_outer: int = 3) -> torch.Tensor:
    """Per-component min of `seed` by `n_outer` scan passes (kernel B4 on CUDA)."""
    if _device_kind(seed) == "cpu":
        return propagate_min_plain(seed, fg, n_outer)
    fg = _check_mask("fg", fg, RESIDENT_MAX_HW)
    seed = seed.to(torch.int32).contiguous()
    if seed.shape != fg.shape:
        raise ValueError(f"seed {tuple(seed.shape)} and fg {tuple(fg.shape)} differ")
    b, h, w = fg.shape
    out = torch.empty((b, h, w), dtype=torch.int32, device=fg.device)
    ws, sync, stream = _resident_scratch(fg)
    fn = _build.bind("seg_min.cu", "propagate_min", "pppppiiii")
    _build.LAUNCHES["propagate_min"] += 1
    _build.check(
        fn(seed.data_ptr(), fg.data_ptr(), out.data_ptr(), sync.data_ptr(), ws.data_ptr(), b, h, w,
           n_outer, stream),
        "propagate_min",
    )
    return out


def flood_cluster(h: int, w: int) -> int:
    """Blocks an image of B3's cluster launch: `FLOOD_CLUSTER`, fewer where
    the image has rows for fewer blocks of 32 rows."""
    k = FLOOD_CLUSTER
    while k > 1 and 32 * (k // 2) >= h:
        k //= 2
    return k


def _flood_bits(inputs, n_outer: int) -> torch.Tensor:
    """One launch of `csrc/flood_bits.cu` on clusters of `flood_cluster`
    blocks an image: the flood of (seed, open), or the hole filling of
    (mask,). Returns the bool result."""
    b, h, w = inputs[0].shape
    out = torch.empty((b, h, w), dtype=torch.bool, device=inputs[0].device)
    if len(inputs) == 2:
        name, fn = "flood_bits", _build.bind("flood_bits.cu", "flood_bits", "pppiiiii")
    else:
        name, fn = "fill_holes_bits", _build.bind("flood_bits.cu", "fill_holes_bits", "ppiiiii")
    _build.LAUNCHES["flood"] += 1
    _build.check(fn(*(t.data_ptr() for t in inputs), out.data_ptr(), b, h, w, n_outer,
                    flood_cluster(h, w), _build.stream_of(out)), name)
    return out


def flood_cuda(seed: torch.Tensor, open_: torch.Tensor, n_outer: int = 2) -> torch.Tensor:
    """Reachability of `seed` through `open_` by `n_outer` scan passes
    (kernel B3 on CUDA)."""
    if _device_kind(seed) == "cpu":
        return flood_plain(seed, open_, n_outer)
    seed, open_ = _check_mask("seed", seed, FLOOD_MAX_HW), _check_mask("open_", open_, FLOOD_MAX_HW)
    if seed.shape != open_.shape:
        raise ValueError(f"seed {tuple(seed.shape)} and open {tuple(open_.shape)} differ")
    return _flood_bits((seed, open_), n_outer)


def root_rank_seed(lab: torch.Tensor) -> torch.Tensor:
    """Each root pixel's 1-based rank in raster order of its image's roots,
    INT_MAX elsewhere: the seed that `compact_root_labels_cuda` propagates.
    One cumsum over the whole batch, less the roots of the images before:
    on CUDA, PyTorch scans a (B, H·W) tensor along its rows with a per-row
    kernel, many times slower at 1024² than its device-wide scan of the flat
    batch."""
    b, h, w = lab.shape
    is_root = (lab > 0) & (lab - 1 == raster_ids(h, w, lab.device))
    cum = torch.cumsum(is_root.reshape(-1), 0).reshape(b, h * w)
    before = torch.cat([cum.new_zeros(1), cum[:-1, -1]])
    rank = (cum - before[:, None]).to(torch.int32).reshape(b, h, w)
    return torch.where(is_root, rank, INT_MAX)


def compact_root_labels_cuda(lab: torch.Tensor, n_outer: int = 3) -> torch.Tensor:
    """Root labels → consecutive 1..N in raster order of roots (scipy
    numbering): each root's rank is min-propagated over its component
    (`compact_root_labels_pallas`)."""
    fg = lab > 0
    return torch.where(fg, propagate_min_cuda(root_rank_seed(lab), fg, n_outer), 0)


def border_seed(mask: torch.Tensor) -> torch.Tensor:
    """Background pixels on the image border (the flood's seed)."""
    h, w = mask.shape[-2:]
    border = torch.zeros((h, w), dtype=torch.bool, device=mask.device)
    border[0, :] = border[-1, :] = True
    border[:, 0] = border[:, -1] = True
    return border & ~mask


def fill_holes_cuda(mask: torch.Tensor, n_outer: int = 2) -> torch.Tensor:
    """(B, H, W) binary_fill_holes via a border flood of the background
    (`fill_holes_pallas`): on CUDA one launch of B3 that reads the mask
    alone and writes mask | (~mask & ~reach)."""
    if _device_kind(mask) == "cpu":
        bg = ~mask
        return mask | (bg & ~flood_plain(border_seed(mask), bg, n_outer))
    return _flood_bits((_check_mask("mask", mask, FLOOD_MAX_HW),), n_outer)


# ------------------------------------------- size filters and the watershed
# (`remove_small_objects_pallas`, `remove_small_objects_bincount_pallas` and
# `watershed_pallas`; their plain versions live in `ops/cc.py` and
# `ops/watershed.py`, which import this module)

#: B10 stages a tile with its halo of min_size − 1 rows (and as many
#: columns, rounded up to 4) as one TMA box in a block's 227 KB: at 105 a
#: 16 × 32 tile's 224 × 240 int32
RM_SMALL_MAX_MIN_SIZE = 105
#: B11 keeps an int32 count per radix bin in the shared memory of each block
#: of an image's cluster (227 KB, less its slice of bit words); the fp32
#: counts are exact below 2²⁴ pixels an image
MAX_RADIX_BINS = 56 * 1024
MAX_HIST_PIXELS = 2**24


def _check_labels(name: str, t: torch.Tensor) -> torch.Tensor:
    if t.dim() != 3:
        raise ValueError(f"{name} must be (B, H, W); got {tuple(t.shape)}")
    return t.to(torch.int32).contiguous()


def remove_small_objects_cuda(labels: torch.Tensor, min_size: int) -> torch.Tensor:
    """Zero the components of fewer than `min_size` pixels by the windowed
    same-label count (kernel B10 on CUDA: a persistent grid over tiles whose
    boxes arrive by TMA, `csrc/rm_small.cu`; `cc.remove_small_objects_window`
    on the CPU). `min_size` ≤ 1 returns `labels` as they are."""
    from cellvit_tpu_torch.ops import cc

    if min_size <= 1:
        return labels
    if _device_kind(labels) == "cpu":
        return cc.remove_small_objects_window(labels, min_size)
    if min_size > RM_SMALL_MAX_MIN_SIZE:
        raise ValueError(f"min_size {min_size} exceeds the window kernel's {RM_SMALL_MAX_MIN_SIZE}; "
                         "remove_small_objects_bincount_cuda takes any min_size")
    labels = _check_labels("labels", labels)
    b, h, w = labels.shape
    out = torch.empty_like(labels)
    fn = _build.bind("rm_small.cu", "remove_small_objects", "ppiiii")
    _build.LAUNCHES["remove_small_objects"] += 1
    _build.check(fn(labels.data_ptr(), out.data_ptr(), b, h, w, min_size, _build.stream_of(labels)),
                 "remove_small_objects")
    return out


def _check_bins(hi_bins: int, lo_bins: int) -> None:
    if hi_bins < 1 or lo_bins < 1 or hi_bins * lo_bins > MAX_RADIX_BINS:
        raise ValueError(f"{hi_bins} × {lo_bins} radix bins: the kernels take 1 … {MAX_RADIX_BINS}")


def _check_radix(labels: torch.Tensor, hi_bins: int, lo_bins: int) -> torch.Tensor:
    _check_bins(hi_bins, lo_bins)
    labels = _check_labels("labels", labels)
    h, w = labels.shape[1:]
    if h * w > MAX_HIST_PIXELS:
        raise ValueError(f"{h}×{w} pixels: fp32 counts are exact below {MAX_HIST_PIXELS}")
    return labels


def radix_histogram_cuda(labels: torch.Tensor, hi_bins: int = 64, lo_bins: int = 128) -> torch.Tensor:
    """(B, H, W) ids → (B, hi_bins, lo_bins) fp32 pixel counts per radix bin
    (kernel B11's histogram entry on CUDA; `cc.radix_histogram` on the CPU)."""
    from cellvit_tpu_torch.ops import cc

    if _device_kind(labels) == "cpu":
        return cc.radix_histogram(labels, hi_bins, lo_bins)
    labels = _check_radix(labels, hi_bins, lo_bins)
    b, h, w = labels.shape
    hist = torch.empty((b, hi_bins, lo_bins), dtype=torch.float32, device=labels.device)
    fn = _build.bind("rm_small.cu", "radix_hist", "ppiiii")
    _build.LAUNCHES["radix_hist"] += 1
    _build.check(fn(labels.data_ptr(), hist.data_ptr(), b, h * w, hi_bins, lo_bins,
                    _build.stream_of(labels)), "radix_hist")
    return hist


def radix_keep_cuda(labels: torch.Tensor, hist: torch.Tensor, min_size: int) -> torch.Tensor:
    """Keep ids > 0 whose radix bin of the (B, hi_bins, lo_bins) `hist`
    holds ≥ `min_size` pixels, and ids ≥ hi_bins·lo_bins; zero the rest
    (kernel B11's lookup entry on CUDA; `cc.radix_keep` on the CPU)."""
    from cellvit_tpu_torch.ops import cc

    if _device_kind(labels) == "cpu":
        return cc.radix_keep(labels, hist, min_size)
    labels = _check_labels("labels", labels)
    b, h, w = labels.shape
    if hist.dim() != 3 or hist.shape[0] != b:
        raise ValueError(f"hist {tuple(hist.shape)} does not match labels {tuple(labels.shape)}")
    hi_bins, lo_bins = hist.shape[1:]
    _check_bins(hi_bins, lo_bins)
    hist = hist.to(torch.float32).contiguous()
    out = torch.empty_like(labels)
    fn = _build.bind("rm_small.cu", "rm_mapback", "pppiiiii")
    _build.LAUNCHES["rm_mapback"] += 1
    _build.check(fn(labels.data_ptr(), hist.data_ptr(), out.data_ptr(), b, h * w, hi_bins, lo_bins,
                    min_size, _build.stream_of(labels)), "rm_mapback")
    return out


def remove_small_objects_bincount_cuda(labels: torch.Tensor, min_size: int, hi_bins: int = 64,
                                       lo_bins: int = 128) -> torch.Tensor:
    """`remove_small_objects` for compacted labels through a radix histogram
    of hi_bins × lo_bins bins (kernel B11 on CUDA: one cluster launch of
    `csrc/rm_small.cu` an image counts, reduces the counts across the
    cluster and maps the pixels; `cc.remove_small_objects_bincount` on the
    CPU). Exact for ids below hi_bins·lo_bins; past that the top bin's count
    is inflated and such ids are always kept."""
    from cellvit_tpu_torch.ops import cc

    if min_size <= 1:
        return labels
    if _device_kind(labels) == "cpu":
        return cc.remove_small_objects_bincount(labels, min_size, hi_bins * lo_bins, hi_bins)
    labels = _check_radix(labels, hi_bins, lo_bins)
    b, h, w = labels.shape
    out = torch.empty_like(labels)
    fn = _build.bind("rm_small.cu", "radix_filter", "ppiiiii")
    _build.LAUNCHES["radix_filter"] += 1
    _build.check(fn(labels.data_ptr(), out.data_ptr(), b, h * w, hi_bins, lo_bins, min_size,
                    _build.stream_of(labels)), "radix_filter")
    return out


def watershed_cuda(image: torch.Tensor, markers: torch.Tensor, mask: torch.Tensor,
                   levels: int = 64, inner_iters: int = 4, max_final_iters: int = 512,
                   return_passes: bool = False):
    """Quantized level-sweep watershed of `watershed_pallas` (kernel B9 on
    CUDA; `watershed(schedule="sweep")` on the CPU): `levels` × `inner_iters`
    adoption passes, then stabilization until a pass changes nothing or
    `max_final_iters` passes, per image. The cap of 512 is the JAX package's
    default; the main path's frontier flood caps at 4096. Returns int32
    labels, and with `return_passes` the (B,) stabilization pass counts.

    On CUDA the relief is quantized by `watershed.quantize` (torch ops) and
    every pass runs in one launch of `csrc/watershed.cu`, which keeps the
    heights in a byte up to 256 levels and in 16 bits up to
    `WATERSHED_MAX_LEVELS`."""
    from cellvit_tpu_torch.ops import watershed as ws

    if max_final_iters < 1:
        raise ValueError(f"max_final_iters must be ≥ 1; got {max_final_iters}")
    if _device_kind(image) == "cpu":
        return ws.watershed(image, markers, mask, levels, inner_iters, max_final_iters,
                            schedule="sweep", return_passes=return_passes)
    if image.dim() != 3 or markers.shape != image.shape or mask.shape != image.shape:
        raise ValueError(f"image {tuple(image.shape)}, markers {tuple(markers.shape)} and mask "
                         f"{tuple(mask.shape)} must be one (B, H, W) shape")
    if not 1 <= levels <= WATERSHED_MAX_LEVELS:
        raise ValueError(f"levels {levels}: the watershed kernel keeps heights in 16 bits and takes "
                         f"1 … {WATERSHED_MAX_LEVELS} levels")
    if inner_iters < 0:
        raise ValueError(f"inner_iters must be ≥ 0; got {inner_iters}")
    mask = mask.to(torch.bool).contiguous()
    q = ws.quantize(image, mask, levels).contiguous()
    markers = markers.to(torch.int32).contiguous()
    b, h, w = image.shape
    lib = _build.load("watershed.cu")
    size = lib.watershed_workspace_words
    size.argtypes, size.restype = [ctypes.c_int] * 5, ctypes.c_longlong
    work = torch.empty(size(b, h, w, levels, max_final_iters), dtype=torch.int32, device=image.device)
    lab = torch.empty((b, h, w), dtype=torch.int32, device=image.device)
    passes = torch.empty(b, dtype=torch.int32, device=image.device)
    sync, stream = _sync_words(image)
    fn = _build.bind("watershed.cu", "watershed_sweep", "pppppppiiiiii")
    _build.LAUNCHES["watershed"] += 1
    _build.check(
        fn(q.data_ptr(), mask.data_ptr(), markers.data_ptr(), lab.data_ptr(), work.data_ptr(),
           sync.data_ptr(), passes.data_ptr(), b, h, w, levels, inner_iters, max_final_iters, stream),
        "watershed_sweep",
    )
    return (lab, passes) if return_passes else lab
