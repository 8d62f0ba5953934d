"""Per-instance statistics by scatter reductions (port of
`cellvit_tpu/ops/instance_stats.py`: `relabel_consecutive`,
`instance_stats_batch`, `contours_from_instance_map`).

Area, centroid, bounding box, majority-vote type and mean nucleus
probability of every instance of a (B, H, W) label batch, as fixed-capacity
(B, K, …) tensors. Scatter indices are int64; integer sums are exact.
Contour extraction runs on the host (`ops/contours.py`, cv2's contract
without cv2).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from cellvit_tpu_torch.ops.contours import trace_outer_border


def relabel_consecutive(inst: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Renumber (B, H, W) labels to consecutive 1..N per image, keeping their
    order (`remap_label(pred, by_size=False)`). As in the JAX version, labels
    ≥ num_segments are not counted and take the last id (a scatter drops,
    a gather clamps out-of-range indices)."""
    b = inst.shape[0]
    flat = inst.reshape(b, -1).long()
    in_range = flat < num_segments
    present = torch.zeros((b, num_segments), dtype=torch.int32, device=inst.device)
    present.scatter_reduce_(1, torch.where(in_range, flat, 0),
                            ((flat > 0) & in_range).to(torch.int32), reduce="amax")
    new_id = torch.cumsum(present, dim=1, dtype=torch.int32)
    out = torch.where(flat > 0, torch.gather(new_id, 1, flat.clamp(max=num_segments - 1)), 0)
    return out.reshape(inst.shape)


def instance_stats_batch(
    inst_map: torch.Tensor,
    type_map: torch.Tensor,
    np_prob: Optional[torch.Tensor] = None,
    max_instances: int = 1024,
    num_classes: int = 6,
) -> Dict[str, torch.Tensor]:
    """Fixed-capacity per-instance stats.

    Args:
        inst_map: (B, H, W) labels with consecutive ids from 1.
        type_map: (B, H, W) argmax nuclei-type map.
        np_prob: optional (B, H, W) nucleus probability.
        max_instances: capacity K; ids above K fall into slot K.
    Returns:
        dict of (B, K, …): valid, area, centroid (x, y), bbox (rmin, rmax,
        cmin, cmax; max-exclusive), type, type_prob, mean_prob.
    """
    b, h, w = inst_map.shape
    dev = inst_map.device
    k = max_instances + 1  # slot 0 = background
    if np_prob is None:
        np_prob = torch.zeros((b, h, w), dtype=torch.float32, device=dev)
    flat = inst_map.reshape(b, -1).long().clamp(0, max_instances)
    idx = (flat + torch.arange(b, device=dev).view(b, 1) * k).reshape(-1)
    rows = torch.arange(h, device=dev).view(1, h, 1).expand(b, h, w).reshape(-1)
    cols = torch.arange(w, device=dev).view(1, 1, w).expand(b, h, w).reshape(-1)

    def seg_sum(values: torch.Tensor) -> torch.Tensor:
        return torch.zeros(b * k, dtype=values.dtype, device=dev).index_add_(0, idx, values)

    def seg_ext(values: torch.Tensor, init: int, reduce: str) -> torch.Tensor:
        out = torch.full((b * k,), init, dtype=values.dtype, device=dev)
        return out.scatter_reduce_(0, idx, values, reduce=reduce, include_self=True)

    area = seg_sum(torch.ones_like(idx))
    sum_r, sum_c = seg_sum(rows), seg_sum(cols)
    rmin, rmax = seg_ext(rows, h, "amin"), seg_ext(rows, -1, "amax")
    cmin, cmax = seg_ext(cols, w, "amin"), seg_ext(cols, -1, "amax")

    af = torch.clamp(area.float(), min=1.0)
    centroid = torch.stack([sum_c.float() / af, sum_r.float() / af], dim=-1)
    bbox = torch.stack([rmin, rmax + 1, cmin, cmax + 1], dim=-1)

    # majority-vote type, skipping background unless it is the only type
    tflat = type_map.reshape(-1).long().clamp(0, num_classes - 1)
    tcounts = torch.zeros(b * k * num_classes, dtype=torch.int64, device=dev)
    tcounts.index_add_(0, idx * num_classes + tflat, torch.ones_like(idx))
    tcounts = tcounts.view(b * k, num_classes)
    top = tcounts.argmax(dim=-1)
    counts_no_bg = tcounts.clone()
    counts_no_bg[:, 0] = -1
    second = counts_no_bg.argmax(dim=-1)
    has_nonbg = tcounts[:, 1:].amax(dim=-1) > 0
    inst_type = torch.where((top == 0) & has_nonbg, second, top)
    type_count = torch.gather(tcounts, 1, inst_type[:, None])[:, 0]
    type_prob = type_count.float() / (area.float() + 1e-6)

    mean_prob = seg_sum(np_prob.reshape(-1).float()) / af

    def per_image(a: torch.Tensor) -> torch.Tensor:
        return a.view(b, k, *a.shape[1:])[:, 1:]

    return {
        "valid": per_image(area > 0),
        "area": per_image(area.to(torch.int32)),
        "centroid": per_image(centroid),
        "bbox": per_image(bbox.to(torch.int32)),
        "type": per_image(inst_type.to(torch.int32)),
        "type_prob": per_image(type_prob),
        "mean_prob": per_image(mean_prob),
    }


def contours_from_instance_map(
    inst_map: np.ndarray,
    valid_ids: Optional[np.ndarray] = None,
    bboxes: Optional[np.ndarray] = None,
) -> Dict[int, np.ndarray]:
    """Host contour of each instance: `cv2.findContours(crop, RETR_TREE,
    CHAIN_APPROX_SIMPLE)[0]` of its bounding-box crop (reference
    post_proc_cellvit.py:106-123). Returns {instance_id: (N, 2) int32
    contour in (x, y)}; instances whose contour has < 3 points are skipped
    like the reference.

    `bboxes`: the device statistics' (K, 4) boxes (rmin, rmax, cmin, cmax;
    max-exclusive) of ids 1..K. With them each instance is compared only
    inside its box, and the ids are those with a non-empty box (and in
    `valid_ids`, if given); without them, the ids are `valid_ids` or every
    label of the map, and each box is found from the whole map.
    """
    out: Dict[int, np.ndarray] = {}
    if bboxes is not None:
        bboxes = np.asarray(bboxes)
        ids = np.flatnonzero(bboxes[:, 1] > bboxes[:, 0]) + 1
        if valid_ids is not None:
            ids = ids[np.isin(ids, valid_ids)]
    else:
        ids = valid_ids if valid_ids is not None else np.unique(inst_map)
    for inst_id in ids:
        if inst_id == 0:
            continue
        if bboxes is not None:
            rmin, rmax, cmin, cmax = (int(v) for v in bboxes[inst_id - 1])
            crop = inst_map[rmin:rmax, cmin:cmax] == inst_id
        else:
            mask = inst_map == inst_id
            ys, xs = np.nonzero(mask)
            if ys.size == 0:
                continue
            rmin, rmax = ys.min(), ys.max() + 1
            cmin, cmax = xs.min(), xs.max() + 1
            crop = mask[rmin:rmax, cmin:cmax]
        contour = trace_outer_border(crop)
        if contour.shape[0] < 3:
            continue
        out[int(inst_id)] = contour + np.array([[cmin, rmin]], np.int32)
    return out
