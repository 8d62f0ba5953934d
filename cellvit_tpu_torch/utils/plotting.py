"""Validation example panels (port of `cellvit_tpu/utils/plotting.py`;
reference `trainer_cellvit.py:842-1029`) drawn in numpy and written with
`data/png.py`, without matplotlib or cv2.

A panel has one row per sample: the input with the predicted and the
ground-truth instance contours (green, traced by `ops/contours.py`), the
predicted and ground-truth binary maps and, when given, the horizontal HV
maps; single-channel panels are coloured by a viridis table, each scaled to
its own range as `imshow` scales it. Tiles are separated by a 2-pixel white
gutter; there are no titles.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np

from cellvit_tpu_torch.data.png import encode_png
from cellvit_tpu_torch.ops.contours import draw_closed_polyline, trace_outer_border

#: matplotlib's viridis at 17 evenly spaced points, interpolated linearly
VIRIDIS_ANCHORS = np.array([
    [68, 1, 84], [72, 24, 106], [71, 45, 123], [66, 64, 134], [59, 82, 139], [51, 99, 141],
    [44, 114, 142], [38, 130, 142], [33, 145, 140], [31, 160, 136], [40, 174, 128],
    [63, 188, 115], [94, 201, 98], [132, 212, 75], [173, 220, 48], [216, 226, 25],
    [253, 231, 37]], np.float64)
VIRIDIS = np.stack([np.interp(np.linspace(0, 16, 256), np.arange(17), VIRIDIS_ANCHORS[:, c])
                    for c in range(3)], -1).round().astype(np.uint8)
GUTTER = 2


def colorize(panel: np.ndarray) -> np.ndarray:
    """(H, W) values → (H, W, 3) uint8 through viridis, min to max."""
    x = np.asarray(panel, np.float64)
    lo, hi = float(x.min()), float(x.max())
    idx = np.zeros(x.shape, np.int64) if hi <= lo else np.rint((x - lo) / (hi - lo) * 255).astype(np.int64)
    return VIRIDIS[idx]


def instance_contours_overlay(img: np.ndarray, inst: np.ndarray) -> np.ndarray:
    """`img` (H, W, 3) in [0, 1] with each instance's outer contour in green."""
    overlay = (img * 255).clip(0, 255).astype(np.uint8).copy()
    canvas = np.zeros(inst.shape, np.uint8)
    for inst_id in np.unique(inst):
        if inst_id != 0:
            draw_closed_polyline(canvas, trace_outer_border(inst == inst_id))
    overlay[canvas > 0] = (0, 255, 0)
    return overlay


def generate_example_image(
    imgs: np.ndarray,
    pred_inst: np.ndarray,
    gt_inst: np.ndarray,
    pred_binary: np.ndarray,
    gt_binary: np.ndarray,
    hv_pred: Optional[np.ndarray] = None,
    hv_gt: Optional[np.ndarray] = None,
    num_images: int = 4,
    outfile: Optional[Union[str, Path]] = None,
) -> np.ndarray:
    """Panel for up to `num_images` samples; returns it as (H', W', 3) uint8
    and writes it as a PNG to `outfile` when given.

    Args:
        imgs: (B, H, W, 3) in normalized space ((x·0.5)+0.5 display mapping).
        pred_inst/gt_inst: (B, H, W) instance maps.
        pred_binary/gt_binary: (B, H, W) {0,1} maps.
        hv_pred/hv_gt: optional (B, H, W, 2).
    """
    n = min(num_images, imgs.shape[0])
    h, w = imgs.shape[1:3]
    cols = 4 + (2 if hv_pred is not None else 0)
    out = np.full((n * (h + GUTTER) - GUTTER, cols * (w + GUTTER) - GUTTER, 3), 255, np.uint8)
    for i in range(n):
        display = np.clip(imgs[i] * 0.5 + 0.5, 0, 1)
        panels = [
            instance_contours_overlay(display, np.asarray(pred_inst[i])),
            instance_contours_overlay(display, np.asarray(gt_inst[i])),
            colorize(pred_binary[i]),
            colorize(gt_binary[i]),
        ]
        if hv_pred is not None:
            panels += [colorize(hv_pred[i][..., 0]), colorize(hv_gt[i][..., 0])]
        for j, panel in enumerate(panels):
            y, x = i * (h + GUTTER), j * (w + GUTTER)
            out[y:y + h, x:x + w] = panel
    if outfile is not None:
        Path(outfile).parent.mkdir(parents=True, exist_ok=True)
        Path(outfile).write_bytes(encode_png(out))
    return out
