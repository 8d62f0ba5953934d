"""Panoptic-quality metric suite (PanNuke protocol; copy of
`cellvit_tpu/eval/metrics.py`).

Matches the reference metric definitions
(`cell_segmentation/utils/metrics.py`: get_fast_pq:41-147, remap_label,
binarize, cell_detection_scores, cell_type_detection_scores and
`utils/tools.py:pair_coordinates`) but with a vectorized implementation:
the pairwise-IoU matrix comes from one O(H·W) contingency-table bincount
over combined (true, pred) indices instead of per-instance mask loops —
identical results, orders of magnitude faster on large label maps.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment
from scipy.spatial.distance import cdist


def remap_label(pred: np.ndarray, by_size: bool = False) -> np.ndarray:
    """Renumber instance ids to contiguous 1..N (order preserved, or by
    descending size when by_size)."""
    ids = np.unique(pred)
    ids = ids[ids != 0]
    if ids.size == 0:
        return pred
    if by_size:
        sizes = np.array([(pred == i).sum() for i in ids])
        ids = ids[np.argsort(-sizes, kind="stable")]
    lut = np.zeros(int(pred.max()) + 1, dtype=np.int32)
    lut[ids] = np.arange(1, ids.size + 1, dtype=np.int32)
    return lut[pred]


def binarize(x: np.ndarray) -> np.ndarray:
    """(H, W, C) per-class instance maps → single (H, W) instance map with
    globally renumbered ids (reference metrics.py:189-211 semantics: later
    channels overwrite earlier ones on overlap)."""
    out = np.zeros(x.shape[:2], np.int32)
    count = 1
    for c in range(x.shape[2]):
        ch = x[..., c]
        for j in np.unique(ch):
            if j == 0:
                continue
            sel = ch == j
            out[sel] = count
            count += 1
    return out


def _contingency(true: np.ndarray, pred: np.ndarray, nt: int, npred: int):
    """Pixel-count table C[t, p] for t in 0..nt, p in 0..npred."""
    combined = true.astype(np.int64) * (npred + 1) + pred.astype(np.int64)
    counts = np.bincount(combined.ravel(), minlength=(nt + 1) * (npred + 1))
    return counts.reshape(nt + 1, npred + 1)


def get_fast_pq(
    true: np.ndarray, pred: np.ndarray, match_iou: float = 0.5
) -> Tuple[List[float], List]:
    """[dq, sq, pq] and [paired_true, paired_pred, unpaired_true,
    unpaired_pred]. Instance ids must be contiguous (use remap_label)."""
    assert match_iou >= 0.0
    nt = int(true.max())
    npred = int(pred.max())
    if nt == 0 and npred == 0:
        return [1.0, 1.0, 1.0], [[], [], [], []]

    table = _contingency(true, pred, nt, npred)
    inter = table[1:, 1:].astype(np.float64)  # (nt, npred)
    area_t = table[1:, :].sum(axis=1, keepdims=True)
    area_p = table[:, 1:].sum(axis=0, keepdims=True)
    union = area_t + area_p - inter
    iou = np.where(union > 0, inter / np.maximum(union, 1), 0.0)

    if match_iou >= 0.5:
        matched = iou > match_iou
        paired_true, paired_pred = np.nonzero(matched)
        paired_iou = iou[paired_true, paired_pred]
        paired_true = paired_true + 1
        paired_pred = paired_pred + 1
    else:
        rows, cols = linear_sum_assignment(-iou)
        sel = iou[rows, cols] > match_iou
        paired_iou = iou[rows, cols][sel]
        paired_true = rows[sel] + 1
        paired_pred = cols[sel] + 1

    tp = len(paired_true)
    unpaired_true = [i for i in range(1, nt + 1) if i not in set(paired_true.tolist())]
    unpaired_pred = [i for i in range(1, npred + 1) if i not in set(paired_pred.tolist())]
    fp, fn = len(unpaired_pred), len(unpaired_true)

    dq = tp / (tp + 0.5 * fp + 0.5 * fn + 1.0e-6)
    sq = paired_iou.sum() / (tp + 1.0e-6)
    return [dq, sq, dq * sq], [
        list(paired_true),
        list(paired_pred),
        unpaired_true,
        unpaired_pred,
    ]


def cell_detection_scores(
    paired_true: np.ndarray,
    paired_pred: np.ndarray,
    unpaired_true: np.ndarray,
    unpaired_pred: np.ndarray,
    w: Sequence[float] = (1, 1),
) -> Tuple[float, float, float]:
    """Detection F1/precision/recall over globally paired centroids."""
    tp_d = paired_pred.shape[0]
    fp_d = unpaired_pred.shape[0]
    fn_d = unpaired_true.shape[0]
    prec_d = tp_d / (tp_d + fp_d)
    rec_d = tp_d / (tp_d + fn_d)
    f1_d = 2 * tp_d / (2 * tp_d + w[0] * fp_d + w[1] * fn_d)
    return f1_d, prec_d, rec_d


def cell_type_detection_scores(
    paired_true: np.ndarray,
    paired_pred: np.ndarray,
    unpaired_true: np.ndarray,
    unpaired_pred: np.ndarray,
    type_id: int,
    w: Sequence[float] = (2, 2, 1, 1),
    exhaustive: bool = True,
) -> Tuple[float, float, float]:
    """Per-type classification F1/precision/recall (PanNuke protocol)."""
    type_samples = (paired_true == type_id) | (paired_pred == type_id)
    pt, pp = paired_true[type_samples], paired_pred[type_samples]

    tp_dt = ((pt == type_id) & (pp == type_id)).sum()
    tn_dt = ((pt != type_id) & (pp != type_id)).sum()
    fp_dt = ((pt != type_id) & (pp == type_id)).sum()
    fn_dt = ((pt == type_id) & (pp != type_id)).sum()
    if not exhaustive:
        fp_dt -= (pt == -1).sum()
    fp_d = (unpaired_pred == type_id).sum()
    fn_d = (unpaired_true == type_id).sum()

    def safe_div(num: float, den: float) -> float:
        # no samples of this type at all → undefined, reported as nan
        # (matches the reference's 0/0 result without the RuntimeWarning)
        return float(num) / float(den) if den != 0 else float("nan")

    prec = safe_div(tp_dt + tn_dt, tp_dt + tn_dt + w[0] * fp_dt + w[2] * fp_d)
    rec = safe_div(tp_dt + tn_dt, tp_dt + tn_dt + w[1] * fn_dt + w[3] * fn_d)
    f1 = safe_div(
        2 * (tp_dt + tn_dt),
        2 * (tp_dt + tn_dt) + w[0] * fp_dt + w[1] * fn_dt + w[2] * fp_d + w[3] * fn_d,
    )
    return f1, prec, rec


def pair_coordinates(
    set_a: np.ndarray, set_b: np.ndarray, radius: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Munkres pairing of two centroid sets within a radius
    (reference tools.py pair_coordinates)."""
    if len(set_a) == 0 or len(set_b) == 0:
        return (
            np.zeros((0, 2), np.int64),
            np.arange(set_a.shape[0]),
            np.arange(set_b.shape[0]),
        )
    dist = cdist(set_a, set_b, metric="euclidean")
    idx_a, idx_b = linear_sum_assignment(dist)
    cost = dist[idx_a, idx_b]
    keep = cost <= radius
    paired = np.stack([idx_a[keep], idx_b[keep]], axis=-1)
    unpaired_a = np.delete(np.arange(set_a.shape[0]), idx_a[keep])
    unpaired_b = np.delete(np.arange(set_b.shape[0]), idx_b[keep])
    return paired, unpaired_a, unpaired_b
