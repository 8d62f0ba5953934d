"""Marker-controlled watershed as a quantized level flood on (B, H, W)
batches (port of `cellvit_tpu/ops/watershed.py`).

The relief is quantized into `levels` levels per image; unlabelled in-mask
pixels adopt the label of their labelled 4-neighbour of lowest quantized
height (ties N, S, W, E) once the flood level reaches them.

* ``"frontier"`` (default): each pass gates adoption at the minimum
  quantized height of the frontier (unlabelled in-mask pixels touching a
  label) within a 31×31 window, built by shift-min doubling; after
  `faithful_iters` passes the gate rises by one level every `ramp_every`
  passes. Each image stops when a pass changes nothing or at
  `max_final_iters` passes, with its own pass count (the JAX package vmaps a
  `while_loop`).
* ``"sweep"``: the fixed ascending level sweep, `inner_iters` passes per
  level, then an unrestricted flood until stable.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from cellvit_tpu_torch.ops.cc import iterate_per_image, shift

BIG = 2**30
_SHIFTS = ((-1, 0), (1, 0), (0, -1), (0, 1))


def _adopt(lab: torch.Tensor, q: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """One step: unlabelled active pixels adopt the label of the labelled
    neighbour with minimal quantized height (tie: N, S, W, E)."""
    best_lab = torch.zeros_like(lab)
    best_q = torch.full_like(q, BIG)
    for dy, dx in _SHIFTS:
        nb_lab = shift(lab, dy, dx, 0)
        nb_q = shift(q, dy, dx, BIG)
        better = (nb_lab > 0) & (nb_q < best_q)
        best_lab = torch.where(better, nb_lab, best_lab)
        best_q = torch.where(better, nb_q, best_q)
    take = active & (lab == 0) & (best_lab > 0)
    return torch.where(take, best_lab, lab)


def _local_min(x: torch.Tensor) -> torch.Tensor:
    """Separable 31×31 min-pool by shift-min doubling (radius 1 → 3 → 7 → 15)."""
    for axis in (0, 1):
        for s in (1, 2, 4, 8):
            d = (s, 0) if axis == 0 else (0, s)
            x = torch.minimum(
                x, torch.minimum(shift(x, -d[0], -d[1], BIG), shift(x, d[0], d[1], BIG))
            )
    return x


def _flood_frontier(q, lab, mask, max_iters: int, faithful_iters: int = 256,
                    ramp_every: int = 4, check_every: int = 16):
    def step(lab: torch.Tensor, it: torch.Tensor) -> torch.Tensor:
        nbr = torch.zeros_like(mask)
        for dy, dx in _SHIFTS:
            nbr = nbr | (shift(lab, dy, dx, 0) > 0)
        frontier = mask & (lab == 0) & nbr
        lvl = _local_min(torch.where(frontier, q, BIG))
        ramp = torch.clamp(it - faithful_iters, min=0) // ramp_every
        lvl = lvl + ramp.view(-1, 1, 1)
        return _adopt(lab, q, mask & (q <= lvl))

    return iterate_per_image(step, lab, max_iters, check_every)


def quantize(image: torch.Tensor, mask: torch.Tensor, levels: int) -> torch.Tensor:
    """Per-image relief quantization to int32 levels 0..levels-1 over the mask."""
    inf = torch.tensor(float("inf"), device=image.device)
    lo = torch.where(mask, image, inf).amin(dim=(-2, -1), keepdim=True)
    hi = torch.where(mask, image, -inf).amax(dim=(-2, -1), keepdim=True)
    rng = torch.where(hi > lo, hi - lo, 1.0)
    return torch.clamp((image - lo) / rng * (levels - 1), 0, levels - 1).to(torch.int32)


def watershed(
    image: torch.Tensor,
    markers: torch.Tensor,
    mask: torch.Tensor,
    levels: int = 64,
    inner_iters: int = 4,
    max_final_iters: int = 4096,
    schedule: str = "frontier",
    return_passes: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Flood (B, H, W) int `markers` over relief `image` within bool `mask`.
    Returns int32 labels, and with `return_passes` the (B,) pass counts of
    the final flood loop."""
    q = quantize(image, mask, levels)
    lab = torch.where(mask, markers, 0).to(torch.int32)
    if schedule == "frontier":
        lab, passes = _flood_frontier(q, lab, mask, max_final_iters)
    elif schedule == "sweep":
        for lvl in range(levels):
            active = mask & (q <= lvl)
            for _ in range(inner_iters):
                lab = _adopt(lab, q, active)
        lab, passes = iterate_per_image(lambda l, it: _adopt(l, q, mask), lab, max_final_iters)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    return (lab, passes) if return_passes else lab
