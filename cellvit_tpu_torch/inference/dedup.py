"""Cross-tile cell deduplication (copy of `cellvit_tpu/inference/dedup.py`,
with the port's own polygon fill in place of cv2.fillPoly).

Port of the reference `CellPostProcessor` semantics
(`inference/cell_detection.py:600-767`) without pandas/shapely:

* cells are split by `cell_status` margin code (0 = mid, 1-8 = margin) and
  `edge_position` (touching the tile border);
* border cells survive only when their first neighboring patch was never
  processed (`_clean_edge_cells`, :645-674);
* overlap removal (`_remove_overlap`, :676-767): candidate pairs from a
  bounding-box grid hash (the STRtree role), mutual intersection-over-area
  > 1% → keep the largest involved polygon, ≤ 20 iterations. Intersection
  areas are computed by rasterizing both contours on a local canvas
  (`ops/contours.fill_poly`, pixel-equal to cv2.fillPoly) — robust for
  the arbitrary (possibly self-touching) watershed contours shapely needed
  `buffer(0)` fixes for.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from cellvit_tpu_torch.ops.contours import fill_poly


def _bbox_of_contour(contour: np.ndarray) -> Tuple[int, int, int, int]:
    xs, ys = contour[:, 0], contour[:, 1]
    return int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())


def _poly_mask(contour: np.ndarray, origin: Tuple[int, int], shape) -> np.ndarray:
    canvas = np.zeros(shape, np.uint8)
    pts = (contour - np.asarray(origin)[None, :]).astype(np.int32)
    return fill_poly(canvas, pts)


def polygon_area(contour: np.ndarray) -> float:
    x0, y0, x1, y1 = _bbox_of_contour(contour)
    shape = (y1 - y0 + 1, x1 - x0 + 1)
    return float(_poly_mask(contour, (x0, y0), shape).sum())


def intersection_area(a: np.ndarray, b: np.ndarray) -> float:
    ax0, ay0, ax1, ay1 = _bbox_of_contour(a)
    bx0, by0, bx1, by1 = _bbox_of_contour(b)
    x0, y0 = min(ax0, bx0), min(ay0, by0)
    x1, y1 = max(ax1, bx1), max(ay1, by1)
    if ax1 < bx0 or bx1 < ax0 or ay1 < by0 or by1 < ay0:
        return 0.0
    shape = (y1 - y0 + 1, x1 - x0 + 1)
    ma = _poly_mask(a, (x0, y0), shape)
    mb = _poly_mask(b, (x0, y0), shape)
    return float((ma & mb).sum())


class _GridIndex:
    """Uniform-grid bbox index (replaces shapely STRtree bbox queries)."""

    def __init__(self, bboxes: Sequence[Tuple[int, int, int, int]], cell: int = 128):
        self.cell = cell
        self.bboxes = list(bboxes)
        self.grid: Dict[Tuple[int, int], List[int]] = defaultdict(list)
        for i, (x0, y0, x1, y1) in enumerate(self.bboxes):
            for gx in range(x0 // cell, x1 // cell + 1):
                for gy in range(y0 // cell, y1 // cell + 1):
                    self.grid[(gx, gy)].append(i)

    def query(self, idx: int) -> List[int]:
        x0, y0, x1, y1 = self.bboxes[idx]
        seen: Set[int] = set()
        out = []
        for gx in range(x0 // self.cell, x1 // self.cell + 1):
            for gy in range(y0 // self.cell, y1 // self.cell + 1):
                for j in self.grid.get((gx, gy), ()):
                    if j in seen:
                        continue
                    seen.add(j)
                    bx0, by0, bx1, by1 = self.bboxes[j]
                    if bx0 <= x1 and x0 <= bx1 and by0 <= y1 and y0 <= by1:
                        out.append(j)
        return out


class CellPostProcessor:
    """Deduplicate a WSI's cell list; `post_process_cells()` returns the
    indices (into the original list) of surviving cells, sorted."""

    def __init__(self, cell_list: List[dict], logger=None) -> None:
        self.cells = cell_list
        self.logger = logger
        self.mid_idx = [
            i for i, c in enumerate(cell_list) if c["cell_status"] == 0
        ]
        self.margin_idx = [
            i for i, c in enumerate(cell_list) if c["cell_status"] != 0
        ]

    def _log(self, msg: str) -> None:
        if self.logger:
            self.logger.info(msg)

    def _clean_edge_cells(self) -> List[int]:
        margin = [
            i for i in self.margin_idx if not self.cells[i]["edge_position"]
        ]
        edge = [i for i in self.margin_idx if self.cells[i]["edge_position"]]
        existing_patches = {
            tuple(self.cells[i]["patch_coordinates"]) for i in self.margin_idx
        }
        edge_unique = []
        for i in edge:
            first_neighbor = tuple(
                self.cells[i]["edge_information"]["edge_patches"][0]
            )
            if first_neighbor not in existing_patches:
                edge_unique.append(i)
        return sorted(margin + edge_unique)

    def _remove_overlap(self, idx_list: List[int]) -> List[int]:
        current = list(idx_list)
        contours = {
            i: np.asarray(self.cells[i]["contour"], np.int64) for i in idx_list
        }
        areas = {i: polygon_area(contours[i]) for i in idx_list}

        for iteration in range(20):
            bboxes = [_bbox_of_contour(contours[i]) for i in current]
            index = _GridIndex(bboxes)
            merged: List[int] = []
            iterated: Set[int] = set()
            overlaps = 0
            for qi, i in enumerate(current):
                if i in iterated:
                    continue
                candidates = index.query(qi)
                if len(candidates) > 1:
                    submergers = []
                    for cj in candidates:
                        j = current[cj]
                        if j == i or j in iterated:
                            continue
                        inter = intersection_area(contours[i], contours[j])
                        if (
                            inter / max(areas[i], 1e-6) > 0.01
                            or inter / max(areas[j], 1e-6) > 0.01
                        ):
                            overlaps += 1
                            submergers.append(j)
                            iterated.add(j)
                    if not submergers:
                        merged.append(i)
                    else:
                        best = submergers[
                            int(np.argmax([areas[j] for j in submergers]))
                        ]
                        merged.append(best)
                else:
                    merged.append(i)
                iterated.add(i)
            self._log(f"iteration {iteration}: found {overlaps} overlaps")
            current = sorted(set(merged))
            if overlaps == 0:
                break
        return current

    def post_process_cells(self) -> List[int]:
        cleaned = self._clean_edge_cells()
        cleaned = self._remove_overlap(cleaned)
        return sorted(self.mid_idx + cleaned)


# -- per-cell position helpers (reference cell_detection.py:787-902) --------


def get_cell_position(bbox: np.ndarray, patch_size: int = 1024) -> List[int]:
    """[top, right, down, left] border-touch flags."""
    top = int(bbox[0, 0] == 0)
    left = int(bbox[0, 1] == 0)
    down = int(bbox[1, 0] == patch_size)
    right = int(bbox[1, 1] == patch_size)
    return [top, right, down, left]


def get_cell_position_margin(
    bbox: np.ndarray, patch_size: int = 1024, margin=64
) -> int:
    """Margin status 0-8 (clockwise from top-left; 0 = mid).

    `margin` is a scalar (reference cell_detection.py:820-874 semantics,
    uniform band) or a per-side (top, right, bottom, left) tuple — used by
    grids with non-uniform overlaps (e.g. the end-aligned MoNuSeg patches,
    whose final tile overlaps its neighbor by more than the nominal
    margin): a cell inside any enlarged band must be classified margin in
    *both* covering tiles so the overlap dedup sees it.
    """
    if np.isscalar(margin):
        mt = mr = mb = ml = margin
    else:
        mt, mr, mb, ml = margin
    top = bbox[0, 0] < mt
    left = bbox[0, 1] < ml
    bottom = bbox[1, 0] > patch_size - mb
    right = bbox[1, 1] > patch_size - mr
    if top:
        if left:
            return 1
        if right:
            return 3
        return 2
    if right:
        if bottom:
            return 5
        return 4
    if bottom:
        if left:
            return 7
        return 6
    if left:
        return 8
    return 0


def get_edge_patch(position: List[int], row: int, col: int) -> List[List[int]]:
    """Neighboring patch coordinates for a border-touching cell."""
    table = {
        (1, 0, 0, 0): [[row - 1, col]],
        (1, 1, 0, 0): [[row - 1, col], [row - 1, col + 1], [row, col + 1]],
        (0, 1, 0, 0): [[row, col + 1]],
        (0, 1, 1, 0): [[row, col + 1], [row + 1, col + 1], [row + 1, col]],
        (0, 0, 1, 0): [[row + 1, col]],
        (0, 0, 1, 1): [[row + 1, col], [row + 1, col - 1], [row, col - 1]],
        (0, 0, 0, 1): [[row, col - 1]],
        (1, 0, 0, 1): [[row, col - 1], [row - 1, col - 1], [row - 1, col]],
    }
    return table.get(tuple(position), [[row, col]])
