"""Loss library, channel-last (port of `cellvit_tpu/train/losses.py`).

The HoVer-Net branch losses (reference `base_loss.py:20-204`), Focal-Tversky
(:206-366) and the torch-named plain losses of the reference registry, with
the JAX package's semantics: map inputs are NHWC (B, H, W, C), targets
(B, H, W) int or (B, H, W, C) one-hot/float; each loss is a plain function
`loss(input, target, **aux) -> scalar` closed over its config by
`retrieve_loss_fn`. The StarDist-weighted losses and `CTCLoss` belong to the
StarDist/CPP-Net slice (ROADMAP A8) and raise `NotImplementedError`.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

Loss = Callable[..., torch.Tensor]


def _one_hot(target: torch.Tensor, n: int) -> torch.Tensor:
    return F.one_hot(target.long(), n).float()


# ---------------------------------------------------------------------------
# HoVer-Net losses (reference base_loss.py:20-204)
# ---------------------------------------------------------------------------


def xentropy_loss(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Cross entropy over softmax *probabilities* (B, H, W, C); re-normalizes
    and clips like the reference (eps 1e-7)."""
    eps = 1e-7
    pred = input / input.sum(-1, keepdim=True)
    pred = pred.clamp(eps, 1.0 - eps)
    return (-(target * torch.log(pred)).sum(-1)).mean()


def dice_loss(input: torch.Tensor, target: torch.Tensor, smooth: float = 1e-3) -> torch.Tensor:
    """Summed per-class soft dice on probabilities (B, H, W, C)."""
    inse = (input * target).sum((0, 1, 2))
    l = input.sum((0, 1, 2))
    r = target.sum((0, 1, 2))
    return (1.0 - (2.0 * inse + smooth) / (l + r + smooth)).sum()


def mse_loss_maps(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((input - target) ** 2).mean()


def _hv_sobel_kernels(size: int = 5):
    rng = np.arange(-(size // 2), size // 2 + 1, dtype=np.float32)
    h, v = np.meshgrid(rng, rng, indexing="ij")
    kernel_h = h / (h * h + v * v + 1e-15)
    kernel_v = v / (h * h + v * v + 1e-15)
    return kernel_h, kernel_v


def _conv2d_same(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Cross-correlate (B, H, W) with an odd 2-D kernel, zero padding."""
    k = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)[None, None]
    return F.conv2d(x[:, None], k, padding=kernel.shape[0] // 2)[:, 0]


def get_gradient_hv(hv: torch.Tensor) -> torch.Tensor:
    """HoVer gradient maps of an (B, H, W, 2) HV tensor (size-5 kernels), in
    fp32 whatever the input dtype."""
    hv = hv.float()
    kh, kv = _hv_sobel_kernels(5)
    dh = _conv2d_same(hv[..., 0], kh)
    dv = _conv2d_same(hv[..., 1], kv)
    return torch.stack([dh, dv], dim=-1)


def msge_loss_maps(input: torch.Tensor, target: torch.Tensor, focus: torch.Tensor) -> torch.Tensor:
    """Gradient-MSE with a nucleus focus mask: input/target (B, H, W, 2) HV
    maps; focus the (B, H, W, 2) one-hot binary map (channel 1 = nucleus)."""
    f = focus[..., 1:2].float()
    f = torch.cat([f, f], dim=-1)
    diff = get_gradient_hv(input) - get_gradient_hv(target)
    return (f * diff * diff).sum() / (f.sum() + 1e-8)


# ---------------------------------------------------------------------------
# Focal Tversky (reference base_loss.py:206-366)
# ---------------------------------------------------------------------------


def focal_tversky_loss(input: torch.Tensor, target: torch.Tensor, alpha_t: float = 0.7,
                       beta_t: float = 0.3, gamma_f: float = 4.0 / 3.0, smooth: float = 1e-6,
                       num_classes: int = 2) -> torch.Tensor:
    """Binary focal Tversky on logits (B, H, W, C=2)."""
    if target.ndim != input.ndim:
        target = _one_hot(target, num_classes)
    probs = torch.softmax(input, dim=-1).reshape(-1)
    t = target.reshape(-1).float()
    tp = (probs * t).sum()
    fp = ((1.0 - t) * probs).sum()
    fn = (t * (1.0 - probs)).sum()
    tversky = (tp + smooth) / (tp + alpha_t * fn + beta_t * fp + smooth)
    return (1.0 - tversky) ** gamma_f


def mc_focal_tversky_loss(input: torch.Tensor, target: torch.Tensor, alpha_t: float = 0.7,
                          beta_t: float = 0.3, gamma_f: float = 4.0 / 3.0,
                          smooth: float = 1e-6, num_classes: int = 2,
                          class_weights: Optional[Sequence[float]] = None) -> torch.Tensor:
    """Per-class focal Tversky on logits (B, H, W, C), class-weighted sum."""
    if target.ndim != input.ndim:
        target = _one_hot(target, num_classes)
    probs = torch.softmax(input, dim=-1).reshape(-1, num_classes).T  # (C, N)
    t = target.reshape(-1, num_classes).T.float()
    tp = (probs * t).sum(1)
    fp = ((1.0 - t) * probs).sum(1)
    fn = (t * (1.0 - probs)).sum(1)
    tversky = (tp + smooth) / (tp + alpha_t * fn + beta_t * fp + smooth)
    focal = (1.0 - tversky) ** gamma_f
    w = torch.as_tensor(class_weights if class_weights is not None else [1.0] * num_classes,
                        dtype=torch.float32, device=input.device)
    return (w * focal).sum()


# ---------------------------------------------------------------------------
# torch-named plain losses (logits or values, channel-last)
# ---------------------------------------------------------------------------


def cross_entropy_loss(input: torch.Tensor, target: torch.Tensor,
                       class_weights: Optional[Sequence[float]] = None) -> torch.Tensor:
    """nn.CrossEntropyLoss semantics on channel-last logits (B, …, C) with
    int targets (B, …): weighted mean."""
    logp = torch.log_softmax(input.float(), dim=-1)
    nll = -logp.gather(-1, target.long()[..., None])[..., 0]
    if class_weights is not None:
        w = torch.as_tensor(class_weights, dtype=torch.float32, device=input.device)[target.long()]
        return (nll * w).sum() / w.sum()
    return nll.mean()


def l1_loss(input, target):
    return (input - target).abs().mean()


def mse_loss(input, target):
    return ((input - target) ** 2).mean()


def nll_loss(input, target):
    """input = log-probabilities (B, …, C)."""
    return (-input.gather(-1, target.long()[..., None])).mean()


def poisson_nll_loss(input, target, log_input: bool = True, eps: float = 1e-8):
    if log_input:
        return (torch.exp(input) - target * input).mean()
    return (input - target * torch.log(input + eps)).mean()


def gaussian_nll_loss(input, target, var, eps: float = 1e-6):
    var = var.clamp(min=eps)
    return (0.5 * (torch.log(var) + (input - target) ** 2 / var)).mean()


def kl_div_loss(input, target):
    """input in log-space, 'mean' reduction (torch default)."""
    return (target * (torch.log(target.clamp(min=1e-12)) - input)).mean()


def bce_loss(input, target):
    eps = 1e-12
    p = input.clamp(eps, 1.0 - eps)
    return (-(target * torch.log(p) + (1.0 - target) * torch.log1p(-p))).mean()


def bce_with_logits_loss(input, target):
    return (input.clamp(min=0) - input * target + torch.log1p(torch.exp(-input.abs()))).mean()


def margin_ranking_loss(input1, input2, target, margin: float = 0.0):
    return (-target * (input1 - input2) + margin).clamp(min=0.0).mean()


def hinge_embedding_loss(input, target, margin: float = 1.0):
    return torch.where(target == 1, input, (margin - input).clamp(min=0.0)).mean()


def huber_loss(input, target, delta: float = 1.0):
    d = (input - target).abs()
    return torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta)).mean()


def smooth_l1_loss(input, target, beta: float = 1.0):
    d = (input - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).mean()


def soft_margin_loss(input, target):
    return torch.log1p(torch.exp(-target * input)).mean()


def multilabel_soft_margin_loss(input, target):
    per_class = target * F.logsigmoid(input) + (1 - target) * F.logsigmoid(-input)
    return (-per_class.mean(-1)).mean()


def cosine_embedding_loss(input1, input2, target, margin: float = 0.0):
    cos = (input1 * input2).sum(-1) / (input1.norm(dim=-1) * input2.norm(dim=-1) + 1e-12)
    return torch.where(target == 1, 1.0 - cos, (cos - margin).clamp(min=0.0)).mean()


def triplet_margin_loss(anchor, positive, negative, margin: float = 1.0, p: float = 2.0):
    dp = torch.linalg.vector_norm(anchor - positive, ord=p, dim=-1)
    dn = torch.linalg.vector_norm(anchor - negative, ord=p, dim=-1)
    return (dp - dn + margin).clamp(min=0.0).mean()


def _reduce(per: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return per.mean()
    if reduction == "sum":
        return per.sum()
    return per


def multi_margin_loss(input: torch.Tensor, target: torch.Tensor, p: int = 1, margin: float = 1.0,
                      weight: Optional[torch.Tensor] = None, reduction: str = "mean") -> torch.Tensor:
    """nn.MultiMarginLoss: mean over i ≠ y of max(0, margin − x_y + x_i)^p, /C."""
    b, c = input.shape
    target = target.long()
    x_y = input.gather(1, target[:, None])
    hinge = (margin - x_y + input).clamp(min=0.0) ** p
    if weight is not None:
        hinge = hinge * torch.as_tensor(weight, device=input.device)[target][:, None]
    hinge = hinge * (torch.arange(c, device=input.device)[None, :] != target[:, None])
    return _reduce(hinge.sum(1) / c, reduction)


def multilabel_margin_loss(input: torch.Tensor, target: torch.Tensor,
                           reduction: str = "mean") -> torch.Tensor:
    """nn.MultiLabelMarginLoss: Σ_{j∈targets} Σ_{i∉targets}
    max(0, 1 − (x[y_j] − x_i)) / C, the targets ending at the first -1."""
    b, c = input.shape
    idx = torch.arange(c, device=input.device)
    valid = torch.cumprod((target >= 0).long(), dim=1).bool()
    safe_t = torch.where(valid, target, torch.zeros_like(target)).long()
    is_target = ((safe_t[:, :, None] == idx[None, None, :]) & valid[:, :, None]).any(1)
    x_t = input.gather(1, safe_t)
    hinge = (1.0 - (x_t[:, :, None] - input[:, None, :])).clamp(min=0.0)
    mask = valid[:, :, None] & ~is_target[:, None, :]
    return _reduce((hinge * mask).sum((1, 2)) / c, reduction)


def triplet_margin_with_distance_loss(anchor, positive, negative,
                                      distance_function: Optional[Callable] = None,
                                      margin: float = 1.0, swap: bool = False,
                                      reduction: str = "mean") -> torch.Tensor:
    """nn.TripletMarginWithDistanceLoss (default distance: L2)."""
    dist = distance_function or (lambda a, b: torch.sqrt(((a - b) ** 2).sum(-1) + 1e-12))
    d_ap = dist(anchor, positive)
    d_an = dist(anchor, negative)
    if swap:
        d_an = torch.minimum(d_an, dist(positive, negative))
    return _reduce((d_ap - d_an + margin).clamp(min=0.0), reduction)


def _stardist_slice(name: str) -> Callable[..., Loss]:
    def build(**_kw) -> Loss:
        raise NotImplementedError(
            f"{name} belongs to the StarDist/CPP-Net training slice (ROADMAP A8), "
            "which is not ported yet"
        )

    return build


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

LOSS_DICT: Dict[str, Callable[..., Loss]] = {
    "xentropy_loss": lambda **kw: partial(xentropy_loss, **kw),
    "dice_loss": lambda **kw: partial(dice_loss, **kw),
    "mse_loss_maps": lambda **kw: partial(mse_loss_maps, **kw),
    "msge_loss_maps": lambda **kw: partial(msge_loss_maps, **kw),
    "FocalTverskyLoss": lambda **kw: partial(focal_tversky_loss, **kw),
    "MCFocalTverskyLoss": lambda **kw: partial(mc_focal_tversky_loss, **kw),
    "CrossEntropyLoss": lambda **kw: partial(cross_entropy_loss, **kw),
    "L1Loss": lambda **kw: partial(l1_loss, **kw),
    "MSELoss": lambda **kw: partial(mse_loss, **kw),
    "NLLLoss": lambda **kw: partial(nll_loss, **kw),
    "PoissonNLLLoss": lambda **kw: partial(poisson_nll_loss, **kw),
    "GaussianNLLLoss": lambda **kw: partial(gaussian_nll_loss, **kw),
    "KLDivLoss": lambda **kw: partial(kl_div_loss, **kw),
    "BCELoss": lambda **kw: partial(bce_loss, **kw),
    "BCEWithLogitsLoss": lambda **kw: partial(bce_with_logits_loss, **kw),
    "MarginRankingLoss": lambda **kw: partial(margin_ranking_loss, **kw),
    "HingeEmbeddingLoss": lambda **kw: partial(hinge_embedding_loss, **kw),
    "HuberLoss": lambda **kw: partial(huber_loss, **kw),
    "SmoothL1Loss": lambda **kw: partial(smooth_l1_loss, **kw),
    "SoftMarginLoss": lambda **kw: partial(soft_margin_loss, **kw),
    "MultiLabelSoftMarginLoss": lambda **kw: partial(multilabel_soft_margin_loss, **kw),
    "CosineEmbeddingLoss": lambda **kw: partial(cosine_embedding_loss, **kw),
    "TripletMarginLoss": lambda **kw: partial(triplet_margin_loss, **kw),
    "MAEWeighted": _stardist_slice("MAEWeighted"),
    "MSEWeighted": _stardist_slice("MSEWeighted"),
    "BCEWeighted": _stardist_slice("BCEWeighted"),
    "CEWeighted": _stardist_slice("CEWeighted"),
    "L1LossWeighted": _stardist_slice("L1LossWeighted"),
    "CTCLoss": _stardist_slice("CTCLoss"),
    "MultiMarginLoss": lambda **kw: partial(multi_margin_loss, **kw),
    "MultiLabelMarginLoss": lambda **kw: partial(multilabel_margin_loss, **kw),
    "TripletMarginWithDistanceLoss": lambda **kw: partial(triplet_margin_with_distance_loss, **kw),
}


def retrieve_loss_fn(loss_name: str, **kwargs) -> Loss:
    """Name → configured loss callable (reference base_loss.py:1121-1135)."""
    return LOSS_DICT[loss_name](**kwargs)
