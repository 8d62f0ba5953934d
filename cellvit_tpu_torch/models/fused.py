"""Inference forward emitting postprocessing-ready maps (port of the output
contract of `cellvit_tpu/models/fused.py:fused_forward_maps`).

The decoder towers run with inference BatchNorm folded into the conv
weights. The JAX version's lane packing, block-diagonal tower merging and
W-minor layouts work around TPU memory lane padding and are not ported.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cellvit_tpu_torch.models.cellvit import CellViT
from cellvit_tpu_torch.models.layers import ConvBNRelu, compute_dtype


def fold_bn(block: ConvBNRelu, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weight', bias') of a ConvBNRelu with eval-mode BN folded in (fp32
    arithmetic on the fp32 parameters and statistics, then cast to the
    compute dtype `dtype`, as the JAX package folds before its casts)."""
    conv, bn = block.block[0], block.block[1]
    s = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    w = conv.weight.float() * s[:, None, None, None]
    b = (conv.bias.float() - bn.running_mean.float()) * s + bn.bias.float()
    return w.to(dtype), b.to(dtype)


def _folded(block: ConvBNRelu, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """`fold_bn`, kept on the block and redone only when its weights change
    or another compute dtype is asked for: the key holds the dtype and each
    tensor's address and in-place version counter. The cache pins the folded
    tensors' storage, so a new tensor cannot reuse an address the key holds."""
    conv, bn = block.block[0], block.block[1]
    srcs = (conv.weight, conv.bias, bn.weight, bn.bias, bn.running_mean, bn.running_var)
    key = (dtype,) + tuple((t.data_ptr(), t._version) for t in srcs)
    cached = getattr(block, "_folded_bn", None)
    if cached is None or cached[0] != key:
        cached = (key, *fold_bn(block, dtype), tuple(t.detach() for t in srcs))
        block._folded_bn = cached
    return cached[1], cached[2]


def _run_stage(stage: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """Folded ConvBNRelu layers, then the stage's last module as is."""
    dtype = compute_dtype(x)
    for layer in stage:
        if isinstance(layer, ConvBNRelu):
            w, b = _folded(layer, dtype)
            x = F.relu(F.conv2d(x.to(dtype), w, b, padding=w.shape[-1] // 2))
        else:
            x = layer(x)
    return x


def _tower(branch: nn.Module, p0, p1, p2, p3, z4) -> torch.Tensor:
    x = branch.bottleneck_upsampler(z4)
    x = _run_stage(branch.decoder3_upsampler, torch.cat([p3, x], dim=1))
    x = _run_stage(branch.decoder2_upsampler, torch.cat([p2, x], dim=1))
    x = _run_stage(branch.decoder1_upsampler, torch.cat([p1, x], dim=1))
    return _run_stage(branch.decoder0_header, torch.cat([p0, x], dim=1))


@torch.no_grad()
def forward_maps(model: CellViT, x: torch.Tensor, retrieve_tokens: bool = False) -> Dict:
    """Inference forward of a CellViT on NHWC `x`. Returns:

      tissue_types     (B, T) logits
      np_prob          (B, H, W) fp32  = sigmoid(nb1 − nb0) = softmax(nb)[..., 1]
      hv0 / hv1        (B, H, W) fp32  hv_map channels
      type_map_cmajor  (B, C, H, W)    nuclei_type_map, channel-major
      [reg0 / reg1     (B, H, W) fp32] regression_map channels
      [tokens          (B, Ht, Wt, E)] if retrieve_tokens
    """
    out, (p0, p1, p2, p3), z4 = model.encode_features(x)
    if retrieve_tokens:
        out["tokens"] = z4.permute(0, 2, 3, 1)
    nb = _tower(model.nuclei_binary_map_decoder, p0, p1, p2, p3, z4).float()
    hv = _tower(model.hv_map_decoder, p0, p1, p2, p3, z4).float()
    out["np_prob"] = torch.sigmoid(nb[:, 1] - nb[:, 0])
    if model.regression_loss:
        out["reg0"], out["reg1"] = nb[:, 2], nb[:, 3]
    out["hv0"], out["hv1"] = hv[:, 0], hv[:, 1]
    out["type_map_cmajor"] = _tower(model.nuclei_type_maps_decoder, p0, p1, p2, p3, z4)
    return out
