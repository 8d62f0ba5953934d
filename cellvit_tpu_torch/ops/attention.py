"""Flash attention forward (port of `cellvit_tpu/ops/attention.py:flash_attention`).

softmax(q·kᵀ·scale)·v over (B, N, H, D) tensors — the JAX package's layout —
without materialising the logits. On a CUDA tensor the hand-written kernel
`csrc/flash_attn.cu` runs (bf16, D = 64); on a CPU tensor the plain version
below, which computes the same function in fp32.

Both also give the fp32 natural-log log-sum-exp of the scaled logits per
query row, (B, H, N), the residual a flash backward needs.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from cellvit_tpu_torch import _build

SUPPORTED_HEAD_DIMS = (64,)

#: Bounds of the bf16 kernel's result against the fp32 plain version, in the
#: units of `flash_errors`. Over N keys of unit-variance logits |o| is only
#: ~sqrt(e/N) (≈0.02 at N = 4097), so o's bounds are relative to o's own size.
#: Rounding p and o to bf16 gives ≈2e-3 of each; a dropped key, an unmasked
#: padded key or a skipped accumulator rescale gives ≥ 9e-3 in "l2".
FLASH_BOUNDS = {"max": 1e-2, "mean": 1e-2, "l2": 5e-3, "lse": 1e-3}


def flash_errors(o: torch.Tensor, lse: torch.Tensor, ref_o: torch.Tensor,
                 ref_lse: torch.Tensor) -> Dict[str, float]:
    """Errors of (o, lse) against a reference: max|Δo| / max|o|,
    mean|Δo| / mean|o|, ‖Δo‖₂ / ‖o‖₂ and max|Δlse|."""
    ref_o = ref_o.float()
    err = o.float() - ref_o
    return {
        "max": (err.abs().max() / ref_o.abs().max()).item(),
        "mean": (err.abs().mean() / ref_o.abs().mean()).item(),
        "l2": (err.norm() / ref_o.norm()).item(),
        "lse": (lse - ref_lse).abs().max().item(),
    }


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference formula: fp32 logits, softmax and product; output in q's dtype."""
    d = q.shape[-1]
    scale = d**-0.5 if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype), lse


def _flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    b, n, h, d = q.shape
    if d not in SUPPORTED_HEAD_DIMS or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash kernel takes equal (B, N, H, D) q/k/v with D in "
            f"{SUPPORTED_HEAD_DIMS}; got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash kernel takes bf16; {name} is {t.dtype}")
        if t.stride(3) != 1 or t.stride(2) != d or t.stride(1) % 8 or t.stride(0) % 8:
            raise ValueError(f"flash kernel needs {name} with unit D stride and 16-byte rows")
        if t.data_ptr() % 16:
            raise ValueError(f"flash kernel needs {name} 16-byte aligned")
    o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    fn = _build.bind("flash_attn.cu", "flash_attn_fwd", "pppppiiiiiiiiiif")
    _build.LAUNCHES["flash_attention"] += 1
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, n, h, d, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), float(scale), _build.stream_of(q),
    )
    _build.check(err, "flash_attn_fwd")
    return o, lse


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Softmax(q·kᵀ·scale)·v over (B, N, H, D); `scale` defaults to D**-0.5.

    A ragged N (4097 = CLS + 64²) needs no padding: the kernel masks keys at
    or beyond N. Returns o, or (o, lse) with `return_lse`."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cuda":
        o, lse = _flash_attention_cuda(q, k, v, scale)
    elif q.device.type == "cpu":
        o, lse = flash_attention_plain(q, k, v, scale)
    else:
        raise ValueError(f"unsupported device {q.device}")
    return (o, lse) if return_lse else o
