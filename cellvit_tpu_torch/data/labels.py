"""HoVer-Net HV targets (copy of `gen_instance_hv_map` and its helper from
`cellvit_tpu/data/labels.py`; reference `pannuke.py:334-415`). Channel-last
output, as the trainer's targets."""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage


def get_bounding_box(mask: np.ndarray) -> Tuple[int, int, int, int]:
    """(rmin, rmax, cmin, cmax), max-exclusive (reference tools.py:24-35)."""
    rows = np.any(mask, axis=1)
    cols = np.any(mask, axis=0)
    rmin, rmax = np.where(rows)[0][[0, -1]]
    cmin, cmax = np.where(cols)[0][[0, -1]]
    return int(rmin), int(rmax) + 1, int(cmin), int(cmax) + 1


def gen_instance_hv_map(inst_map: np.ndarray) -> np.ndarray:
    """Per-instance center-of-mass normalized ±1 gradient maps.

    Returns (H, W, 2): channel 0 horizontal (x), channel 1 vertical (y).
    Semantics of pannuke.py:334-415 including the 2-px box expansion and the
    rounded center of mass.
    """
    h, w = inst_map.shape[:2]
    x_map = np.zeros((h, w), np.float32)
    y_map = np.zeros((h, w), np.float32)

    for inst_id in np.unique(inst_map):
        if inst_id == 0:
            continue
        mask = inst_map == inst_id
        r0, r1, c0, c1 = get_bounding_box(mask)
        if r0 >= 2:
            r0 -= 2
        if c0 >= 2:
            c0 -= 2
        if r1 <= h - 2:
            r1 += 2
        if c1 <= h - 2:  # reference uses shape[0] for both; kept for parity
            c1 += 2
        crop = mask[r0:r1, c0:c1]
        if crop.shape[0] < 2 or crop.shape[1] < 2:
            continue
        com = ndimage.center_of_mass(crop)
        com_y = int(com[0] + 0.5)
        com_x = int(com[1] + 0.5)
        xs = np.arange(1, crop.shape[1] + 1) - com_x
        ys = np.arange(1, crop.shape[0] + 1) - com_y
        gx, gy = np.meshgrid(xs, ys)
        gx = np.where(crop, gx, 0).astype(np.float32)
        gy = np.where(crop, gy, 0).astype(np.float32)
        neg = gx < 0
        if neg.any():
            gx[neg] /= -gx[neg].min()
        pos = gx > 0
        if pos.any():
            gx[pos] /= gx[pos].max()
        neg = gy < 0
        if neg.any():
            gy[neg] /= -gy[neg].min()
        pos = gy > 0
        if pos.any():
            gy[pos] /= gy[pos].max()
        x_map[r0:r1, c0:c1][crop] = gx[crop]
        y_map[r0:r1, c0:c1][crop] = gy[crop]

    return np.stack([x_map, y_map], axis=-1)
