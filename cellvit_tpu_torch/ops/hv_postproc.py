"""Batched HV → instance postprocessing (port of `cellvit_tpu/ops/hv_postproc.py`).

Reference semantics `post_proc_cellvit.py:155-249` (`__proc_np_hv`) for a
whole batch on the device: threshold, connected components, small-object
removal, cv2-parity Sobel/Gaussian filtering, markers (hole filling and a
5×5-ellipse opening), then the frontier watershed.

`use_kernels` mirrors the JAX package's `use_pallas`: by default True on a
CUDA tensor — the fixed-pass scan ops of `ops/cc_cuda.py` (hand kernels on
CUDA) with `n_outer` 3 / 2 / 3 — and False on the CPU, the converging ops of
`ops/cc.py`.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from cellvit_tpu_torch.ops import cc, cc_cuda, filters
from cellvit_tpu_torch.ops.watershed import watershed

Result = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def _instance_map_impl(np_prob, hv0, hv1, object_size: int, ksize: int, cc_iters: int,
                       use_kernels: bool, levels: int, return_passes: bool) -> Result:
    if use_kernels:
        # nuclei blobs converge in 2 passes, U-shapes in 3; marker holes
        # are a few pixels wide — 2 flood passes suffice
        label_roots = lambda m: cc_cuda.connected_components_cuda(m, n_outer=3)
        fill = lambda m: cc_cuda.fill_holes_cuda(m, n_outer=2)
        compact = lambda l: cc_cuda.compact_root_labels_cuda(l, n_outer=3)
    else:
        label_roots = lambda m: cc.connected_components(m, max_iters=cc_iters, compact=False)
        fill = lambda m: cc.fill_holes(m, max_iters=cc_iters)
        compact = cc.compact_root_labels

    fg = np_prob >= 0.5
    lab = cc.remove_small_objects_window(label_roots(fg), 10)
    blb = lab > 0
    blbf = blb.float()

    h_dir = filters.minmax_normalize(hv0.float())
    v_dir = filters.minmax_normalize(hv1.float())
    sobelh = 1.0 - filters.minmax_normalize(filters.sobel(h_dir, 1, 0, ksize))
    sobelv = 1.0 - filters.minmax_normalize(filters.sobel(v_dir, 0, 1, ksize))

    overall = torch.clamp(torch.maximum(sobelh, sobelv) - (1.0 - blbf), min=0.0)
    dist = -filters.gaussian_blur_3x3((1.0 - overall) * blbf)

    marker = blb & ~(overall >= 0.4)
    marker = cc.morph_open(fill(marker))
    marker_lab = compact(label_roots(marker))
    marker_lab = cc.remove_small_objects_window(marker_lab, object_size)
    return watershed(dist, marker_lab, blb, levels=levels, return_passes=return_passes)


def instance_map_batch_maps(
    np_prob: torch.Tensor,
    hv0: torch.Tensor,
    hv1: torch.Tensor,
    object_size: int = 10,
    ksize: int = 21,
    cc_iters: int = 64,
    use_kernels: Optional[bool] = None,
    levels: int = 64,
    return_passes: bool = False,
) -> Result:
    """Batched HV postprocessing on (B, H, W) maps.

    Args:
        np_prob: nucleus probability; hv0 / hv1: the H and V maps.
        object_size / ksize: 10/21 at 40×, 3/11 at 20×.
        use_kernels: the fixed-pass scan ops (default on CUDA) or the
            converging ops (default on the CPU).
        levels: watershed quantization levels.
        return_passes: also return the (B,) watershed pass counts.
    Returns:
        (B, H, W) int32 instance maps (0 = background), numbered by the
        watershed markers.
    """
    if use_kernels is None:
        use_kernels = np_prob.device.type == "cuda"
    with torch.no_grad():
        return _instance_map_impl(np_prob, hv0, hv1, object_size, ksize, cc_iters,
                                  use_kernels, levels, return_passes)


def instance_map_batch(
    np_prob: torch.Tensor,
    hv_map: torch.Tensor,
    object_size: int = 10,
    ksize: int = 21,
    cc_iters: int = 64,
    use_kernels: Optional[bool] = None,
    levels: int = 64,
    return_passes: bool = False,
) -> Result:
    """`instance_map_batch_maps` with the HV maps as one (B, H, W, 2) tensor."""
    return instance_map_batch_maps(np_prob, hv_map[..., 0], hv_map[..., 1], object_size,
                                   ksize, cc_iters, use_kernels, levels, return_passes)
