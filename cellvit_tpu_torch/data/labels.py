"""HoVer-Net HV and regression targets (copy of `gen_instance_hv_map`,
`fix_duplicates`, `gen_regression_map` and their helper from
`cellvit_tpu/data/labels.py`; reference `pannuke.py:334-415`, `:511-537`).
Channel-last output, as the trainer's targets. The StarDist maps
(`gen_distance_prob_maps`, `gen_stardist_maps`) wait for that model's port."""

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


def fix_duplicates(inst_map: np.ndarray) -> np.ndarray:
    """Split instances whose id labels several disconnected components
    (reference tools.py fix_duplicates)."""
    out = inst_map.copy()
    current_max = int(out.max())
    for inst_id in np.unique(out):
        if inst_id == 0:
            continue
        comp, n = ndimage.label(out == inst_id)
        if n <= 1:
            continue
        for extra in range(2, n + 1):
            current_max += 1
            out[comp == extra] = current_max
    return out


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


def gen_regression_map(inst_map: np.ndarray) -> np.ndarray:
    """Unnormalized per-instance center offsets, (H, W, 2): channel 0 x,
    channel 1 y (pannuke.py:511-537 — unrounded center of mass, transposed
    coordinate convention kept)."""
    h, w = inst_map.shape
    out = np.zeros((h, w, 2), np.float32)
    inst_map = fix_duplicates(inst_map)
    for inst_id in np.unique(inst_map):
        if inst_id == 0:
            continue
        mask = inst_map == inst_id
        r0, r1, c0, c1 = get_bounding_box(mask)
        r0 = r0 - 2 if r0 - 2 >= 0 else r0
        c0 = c0 - 2 if c0 - 2 >= 0 else c0
        c1 = c1 + 2 if c1 + 2 <= w - 1 else c1
        r1 = r1 + 2 if r1 + 2 <= h - 1 else r1
        crop = mask[r0:r1, c0:c1].astype(np.uint8)
        y_mass, x_mass = ndimage.center_of_mass(crop)
        x_grid = np.repeat(np.arange(1, c1 - c0 + 1)[None, :], r1 - r0, axis=0)
        y_grid = np.repeat(np.arange(1, r1 - r0 + 1)[:, None], c1 - c0, axis=1)
        out[r0:r1, c0:c1, 0] = (x_grid - x_mass) * crop
        out[r0:r1, c0:c1, 1] = (y_grid - y_mass) * crop
    return out
