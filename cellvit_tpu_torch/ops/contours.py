"""Border following for instance contours: the first contour that
`cv2.findContours(mask, RETR_TREE, CHAIN_APPROX_SIMPLE)` returns, without cv2.

Suzuki and Abe's border following, as OpenCV implements it: foreground is
8-connected, background 4-connected, an outer border starts at the first
pixel of its component in raster order and runs counter-clockwise (down the
left side first), and CHAIN_APPROX_SIMPLE keeps the points where the chain
code changes. OpenCV lists the borders of RETR_TREE depth first, the
children of a node in reverse order of discovery, so its first contour is
the outer border of the top-level component (one that no hole encloses)
found last in raster order.

Components and the outside background are labelled with `scipy.ndimage`;
only the chosen border is followed in Python, so the work grows with the
border's length, not with the crop's area.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

#: (dx, dy) of OpenCV's chain codes 0-7: right, up-right, up, ..., down-right
CODE_DELTAS = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1))
_EIGHT = np.ones((3, 3), bool)


def _start_pixel(mask: np.ndarray) -> tuple:
    """(row, col) of the first raster pixel of the last top-level 8-connected
    component of `mask` (bool, 2-D)."""
    labels, n = ndimage.label(mask, structure=_EIGHT)
    flat = labels.ravel()
    nz = np.flatnonzero(flat)
    # first raster index of each component: first_idx[k - 1] for label k
    first_idx = nz[np.unique(flat[nz], return_index=True)[1]]
    if n == 1:
        return divmod(int(first_idx[0]), mask.shape[1])
    # the outside background: the 4-connected zeros joined to a zero frame;
    # a component is top-level when a pixel of it is 4-adjacent to them
    bg, _ = ndimage.label(np.pad(~mask, 1, constant_values=True))
    near = ndimage.binary_dilation(bg == bg[0, 0])[1:-1, 1:-1] & mask
    top = np.unique(labels[near])
    return divmod(int(first_idx[top - 1].max()), mask.shape[1])


def trace_outer_border(mask: np.ndarray) -> np.ndarray:
    """OpenCV's first RETR_TREE contour of a 2-D mask, CHAIN_APPROX_SIMPLE,
    as an (N, 2) int32 array of (x, y). An empty mask gives (0, 2)."""
    mask = np.asarray(mask) != 0
    if not mask.any():
        return np.zeros((0, 2), np.int32)
    h, w = mask.shape
    step = w + 2
    buf = np.pad(mask, 1).ravel().tolist()  # a zero frame: no bounds checks
    deltas = [1, -step + 1, -step, -step - 1, -1, step - 1, step, step + 1] * 2
    y, x = _start_pixel(mask)
    i0 = (y + 1) * step + x + 1
    # the first neighbour clockwise from the left (icvFetchContour)
    s = s_end = 4
    while True:
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if buf[i1] or s == s_end:
            break
    if s == s_end:  # a single pixel
        return np.array([[x, y]], np.int32)
    points = []
    i3, prev_s = i0, s ^ 4
    while True:
        s_end = s
        while s < 15:
            s += 1
            i4 = i3 + deltas[s]
            if buf[i4]:
                break
        s &= 7
        if s != prev_s:
            points.append((x, y))
            prev_s = s
        dx, dy = CODE_DELTAS[s]
        x += dx
        y += dy
        if i4 == i0 and i3 == i1:
            break
        i3 = i4
        s = (s + 4) & 7
    return np.array(points, np.int32)


def _line8(canvas: np.ndarray, x0: int, y0: int, x1: int, y1: int) -> None:
    """OpenCV's 8-connected line (`LineIterator`, left to right) set to 1."""
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sy = 1 if dy >= 0 else -1
    dy = abs(dy)
    if dy > dx:  # steep: one row a step
        err = dy - 2 * dx
        for _ in range(dy + 1):
            canvas[y0, x0] = 1
            if err < 0:
                x0 += 1
                err += 2 * dy
            err -= 2 * dx
            y0 += sy
    else:
        err = dx - 2 * dy
        for _ in range(dx + 1):
            canvas[y0, x0] = 1
            if err < 0:
                y0 += sy
                err += 2 * dx
            err -= 2 * dy
            x0 += 1


def draw_closed_polyline(canvas: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Set the 8-connected lines joining consecutive (x, y) points, the
    last back to the first, to 1 (`cv2.drawContours` at thickness 1)."""
    pts = np.asarray(pts, np.int64).reshape(-1, 2)
    for (x0, y0), (x1, y1) in zip(np.roll(pts, 1, axis=0).tolist(), pts.tolist()):
        _line8(canvas, x0, y0, x1, y1)
    return canvas


def fill_poly(canvas: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """`cv2.fillPoly(canvas, [pts], 1)` for integer points and 8-connected
    lines: every edge drawn as a line, then a scanline fill as OpenCV's
    `FillEdgeCollection` runs it: an edge's x in 16.16 fixed point from its
    upper end, its slope truncated toward zero, the edge active on rows
    [upper, lower), and the sorted crossings of a row filled pairwise (even
    and odd) from the ceiling of the left one to the floor of the right one.
    (Where a fill end and the edge's line differ by a pixel the line covers
    it, so only these rounding directions are pinned down by comparison with
    cv2.) `canvas` (H, W) is written in place and returned."""
    pts = np.asarray(pts, np.int64).reshape(-1, 2)
    if len(pts) == 0:
        return canvas
    h, w = canvas.shape
    prev = np.roll(pts, 1, axis=0)
    for (x0, y0), (x1, y1) in zip(prev.tolist(), pts.tolist()):
        _line8(canvas, x0, y0, x1, y1)
    slanted = prev[:, 1] != pts[:, 1]
    if slanted.sum() < 2:
        return canvas
    a, b = prev[slanted], pts[slanted]
    num, den = (b[:, 0] - a[:, 0]) << 16, b[:, 1] - a[:, 1]
    slope = np.abs(num) // np.abs(den) * np.sign(num) * np.sign(den)
    upper = np.where((a[:, 1] < b[:, 1])[:, None], a, b)
    y_top, y_bot = upper[:, 1], np.maximum(a[:, 1], b[:, 1])
    x_top = upper[:, 0] << 16
    rows = np.arange(max(int(y_top.min()), 0), min(int(y_bot.max()), h))
    if rows.size == 0:
        return canvas
    active = (rows[:, None] >= y_top) & (rows[:, None] < y_bot)
    big = np.iinfo(np.int64).max
    xs = np.where(active, x_top + (rows[:, None] - y_top) * slope, big)
    if xs.shape[1] % 2:
        xs = np.pad(xs, ((0, 0), (0, 1)), constant_values=big)
    xs = np.sort(xs, axis=1)
    left, right = xs[:, 0::2], xs[:, 1::2]
    ok = right != big
    r_idx = np.broadcast_to(np.arange(rows.size)[:, None], ok.shape)[ok]
    x1, x2 = (left[ok] + 0xFFFF) >> 16, right[ok] >> 16
    on = (x1 < w) & (x2 >= 0)
    r_idx, x1, x2 = r_idx[on], np.clip(x1[on], 0, None), np.clip(x2[on], None, w - 1)
    runs = np.zeros((rows.size, w + 1), np.int32)
    np.add.at(runs, (r_idx, x1), 1)
    np.add.at(runs, (r_idx, x2 + 1), -1)
    canvas[rows] |= (np.cumsum(runs[:, :w], axis=1) > 0).astype(canvas.dtype)
    return canvas
