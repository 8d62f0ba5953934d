"""Attention ops of the encoders (port of `cellvit_tpu/ops/attention.py`).

Four ops, each a hand-written CUDA kernel on a CUDA tensor and a plain
PyTorch version of the same function on a CPU tensor, and each a
`torch.autograd.Function` with the JAX package's backward:

- `flash_attention` (B1, `csrc/flash_attn.cu`): softmax(q·kᵀ·scale)·v over
  (B, N, H, ·), the ViT-256 encoder's attention, plus the fp32 natural-log
  log-sum-exp per query row, (B, H, N), the residual of its backward. q/k may
  be wider than v. Its backward is B8 (`csrc/flash_attn_bwd.cu`), one fused
  kernel for the JAX package's B8a (dq) and B8b (dk/dv).
- `window_qkv_attention` (B5, `csrc/win_qkv_attn.cu`): the SAM windowed
  blocks' qkv projection and decomposed rel-pos attention, fused per window.
- `relpos_flash_attention` (B6, `csrc/relpos_attn.cu`): flash attention with
  the decomposed rel-pos bias added to each logits tile, for SAM's global
  blocks.
- `window_attention` (B7, `csrc/win_attn.cu`): whole-window attention over
  N ≤ 256 tokens on the lane-augmented q′/k′ of `relpos_aug`.

`flash_attention_relpos` routes a SAM rel-pos attention to B6, B7 or B1 by
the grid's shape, as the JAX package does. The kernels take bf16 and
accumulate in fp32; the plain versions compute in fp32 and return the input
dtype. On a CPU tensor each op runs its plain forward and plain backward.
B6's backward is the lane-augmented flash backward (B1 then B8 on q′/k′);
B5's and B7's recompute their plain version under autograd on both devices,
as the JAX package's are XLA.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from cellvit_tpu_torch import _build

#: v widths of the flash kernels B1/B8 (ViT-256 and SAM-B/L heads: 64,
#: SAM-H: 80); q/k may be up to FLASH_MAX_QK wide
FLASH_V_DIMS = (64, 80)
FLASH_MAX_QK = 256
#: head dims of the SAM kernels B5-B7: SAM-B/L use 64, SAM-H 80
SAM_HEAD_DIMS = (64, 80)

#: Bounds of the bf16 kernel's result against the fp32 plain version, in the
#: units of `flash_errors`. Over N keys of unit-variance logits |o| is only
#: ~sqrt(e/N) (≈0.02 at N = 4097), so o's bounds are relative to o's own size.
#: Rounding p and o to bf16 gives ≈2e-3 of each; a dropped key, an unmasked
#: padded key or a skipped accumulator rescale gives ≥ 9e-3 in "l2".
FLASH_BOUNDS = {"max": 1e-2, "mean": 1e-2, "l2": 5e-3, "lse": 1e-3}

#: B8 (one fused kernel for B8a/B8b) against the fp32 plain backward on the
#: same q, k, v, o, lse and do (`flash_bwd_errors`): `attn_errors` of each
#: of dq, dk and dv, relative to that gradient's own size. The kernel rounds
#: p (for dv) and ds (for dq and dk) to bf16 before their products, dk and dv
#: at the end, and dq once after its per-128-key-tile fp32 partials are
#: summed in any order: the CPU replay in `tests/test_torch_grad.py` plays
#: these roundings to ≤ 2.4e-3 in "l2" and ≤ 4.0e-3 in "max", at
#: (1, 1025, 2, 64) and with q/k 120 wide against v 80. Δ left out, dk's
#: scale dropped, an unmasked key past N, a query past N counted in dk/dv,
#: or dp taken from o give ≥ 5.8e-2 in "l2"; the ragged last key tile's dq
#: partial dropped gives 2.4e-2 (1 key of 1025) and a workspace holding a
#: previous dq 1.0.
FLASH_BWD_BOUNDS = {"max": 2e-2, "mean": 1e-2, "l2": 1e-2}

#: B5 against its fp32 plain version, relative to |o| (`attn_errors`). The
#: kernel rounds q, k and v to bf16 after the fp32 projection, then p and o:
#: on SAM-H-like inputs `tests/test_torch_sam.py` plays these roundings to
#: 3.1e-3 in "l2", 2.7e-3 in "mean" and 5.7e-3 in "max". A bias from the
#: scaled q, or masked zero-padded window tokens, gives ≥ 0.56 in "l2".
WIN_QKV_BOUNDS = {"max": 3e-2, "mean": 1.2e-2, "l2": 1e-2}
#: B6, relative to |o|. Bh/Bw arrive in bf16 (as in the JAX package) and p
#: and o are rounded to bf16: 2.2e-3 in "l2", 4.6e-3 in "max" on a 32×32
#: grid. Swapping Bh and Bw, or a column index off by one, gives ≥ 1.0.
RELPOS_BOUNDS = {"max": 2e-2, "mean": 1e-2, "l2": 8e-3}
#: B7, relative to |o|: rounding p and o to bf16 gives 2.0e-3 in "l2" on a
#: 14×16 grid; the zero-filled keys of the last tile left unmasked give
#: 4.0e-2 in "l2" and "mean".
WINDOW_BOUNDS = {"max": 2e-2, "mean": 1e-2, "l2": 8e-3}


def attn_errors(o: torch.Tensor, ref_o: torch.Tensor) -> Dict[str, float]:
    """Errors of o against a reference, relative to the reference's size:
    max|Δo| / max|o|, mean|Δo| / mean|o| and ‖Δo‖₂ / ‖o‖₂."""
    ref_o = ref_o.float()
    err = o.float() - ref_o
    return {
        "max": (err.abs().max() / ref_o.abs().max()).item(),
        "mean": (err.abs().mean() / ref_o.abs().mean()).item(),
        "l2": (err.norm() / ref_o.norm()).item(),
    }


def flash_errors(o: torch.Tensor, lse: torch.Tensor, ref_o: torch.Tensor,
                 ref_lse: torch.Tensor) -> Dict[str, float]:
    """`attn_errors` of o, and max|Δlse|."""
    return dict(attn_errors(o, ref_o), lse=(lse - ref_lse).abs().max().item())


def within(errs: Dict[str, float], bounds: Dict[str, float]) -> bool:
    return all(errs[key] <= bound for key, bound in bounds.items())


def flash_bwd_errors(grads, ref_grads) -> Dict[str, Dict[str, float]]:
    """`attn_errors` of each of (dq, dk, dv) against its reference."""
    return {name: attn_errors(g, r) for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads)}


def within_bwd(errs: Dict[str, Dict[str, float]]) -> bool:
    return all(within(e, FLASH_BWD_BOUNDS) for e in errs.values())


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at |x| (8 significant bits): the bound on
    how far two runs of the fused backward's dq may differ, since its fp32
    partials are summed in any order and then rounded once."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 0.0


def _check_rows(name: str, t: torch.Tensor, what: str) -> None:
    """A kernel operand: bf16, unit stride over its last dim, 16-byte rows."""
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} kernel takes bf16; {what} is {t.dtype}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(f"{name} kernel needs {what} with unit last stride and 16-byte rows")


def _on_device(kernel, plain, t: torch.Tensor, *args):
    """`kernel(*args)` for a CUDA tensor `t`, `plain(*args)` for a CPU one."""
    if t.device.type == "cuda":
        return kernel(*args)
    if t.device.type == "cpu":
        return plain(*args)
    raise ValueError(f"unsupported device {t.device}")


def _recompute_grads(plain, inputs, needs_grad, grad_out):
    """Gradients of `plain(*inputs)` by autograd through the plain version in
    fp32 (autocast off), for the inputs that need one; None elsewhere."""
    with torch.enable_grad(), torch.autocast(grad_out.device.type, enabled=False):
        leaves = [None if t is None else t.detach().requires_grad_(bool(need))
                  for t, need in zip(inputs, needs_grad)]
        out = plain(*leaves)
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad_out))
    return tuple(next(grads) if t is not None and t.requires_grad else None for t in leaves)


# ------------------------------------------- B1 flash attention, B8 backward


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference formula: fp32 logits, softmax and product; output in q's
    dtype. q/k may be wider than v."""
    d = q.shape[-1]
    scale = d**-0.5 if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype), lse


def flash_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Δ = rowsum(do ∘ o) in fp32, as a contiguous (B, H, N) tensor."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fp32 formulas of the flash backward (`_flash_core_bwd`): with
    p = exp(q·kᵀ·scale − lse), Δ = rowsum(do ∘ o), dp = do·vᵀ and
    ds = p ∘ (dp − Δ)·scale, returns dq = ds·k, dk = dsᵀ·q and dv = pᵀ·do,
    all fp32, over (B, N, H, ·) with q/k possibly wider than v."""
    qf, kf, dof = q.float(), k.float(), do.float()
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale - lse.float()[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = p * (dp - flash_delta(o, do)[..., None]) * scale
    return (torch.einsum("bhqk,bkhd->bqhd", ds, kf), torch.einsum("bhqk,bqhd->bkhd", ds, qf), dv)


def _flash_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Tuple[int, int]:
    """Check q/k/v for B1 and B8: (B, N, H, DQK) q and k, (B, N, H, DV) v, all
    bf16 with 16-byte rows. Returns (DQK, DV)."""
    dqk, dv = q.shape[-1], v.shape[-1]
    if (dv not in FLASH_V_DIMS or dqk > FLASH_MAX_QK or dqk % 8 or k.shape != q.shape
            or v.shape[:3] != q.shape[:3]):
        raise ValueError(
            f"flash kernels take (B, N, H, DQK) q/k with DQK ≤ {FLASH_MAX_QK} a multiple of 8 "
            f"and (B, N, H, DV) v with DV in {FLASH_V_DIMS}; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_rows("flash", t, name)
    return dqk, dv


def _strides(*ts: torch.Tensor):
    """The (batch, token, head) strides of each (B, N, H, ·) tensor."""
    return [s for t in ts for s in t.stride()[:3]]


def _flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    b, n, h, _ = q.shape
    dqk, dv = _flash_operands(q, k, v)
    o = torch.empty((b, n, h, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    fn = _build.bind("flash_attn.cu", "flash_attn_fwd", "pppppiiiiiiiiiiiiiif")
    _build.LAUNCHES["flash_attention"] += 1
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, n, h, dqk, dv, *_strides(q, k, v), float(scale), _build.stream_of(q),
    )
    _build.check(err, "flash_attn_fwd")
    return o, lse


def _flash_bwd_launch(q, k, v, do, lse, delta, dq_acc, dk, dv, scale: float) -> None:
    """One launch of the fused B8 kernel on checked operands: adds dq into
    the fp32 workspace `dq_acc` and writes dk and dv."""
    b, n, h, dqk = q.shape
    fn = _build.bind("flash_attn_bwd.cu", "flash_attn_bwd", "pppppppppiiiiiiiiiiiiiif")
    _build.LAUNCHES["flash_attention_bwd"] += 1
    err = fn(
        *(t.data_ptr() for t in (q, k, v, do, lse, delta, dq_acc, dk, dv)),
        b, n, h, dqk, v.shape[-1], *_strides(q, k, v), float(scale), _build.stream_of(q),
    )
    _build.check(err, "flash_attn_bwd")


def _flash_bwd_operands(q, k, v, o, lse, do):
    """Checked operands of the fused B8 kernel and its outputs: (q, k, v,
    contiguous bf16 do, contiguous lse, Δ = rowsum(do ∘ o), a zeroed fp32
    (B, N, H, DQK) dq workspace, empty bf16 dk and dv)."""
    b, n, h, _ = q.shape
    dqk, dv_w = _flash_operands(q, k, v)
    do = do.to(torch.bfloat16).contiguous()
    lse = lse.contiguous()
    if do.shape != v.shape or lse.shape != (b, h, n) or lse.dtype != torch.float32:
        raise ValueError("flash backward takes do shaped as v and a (B, H, N) fp32 lse")
    return (q, k, v, do, lse, flash_delta(o, do),
            torch.zeros((b, n, h, dqk), dtype=torch.float32, device=q.device),
            torch.empty((b, n, h, dqk), dtype=torch.bfloat16, device=q.device),
            torch.empty((b, n, h, dv_w), dtype=torch.bfloat16, device=q.device))


def _flash_attention_bwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) by the fused B8 kernel in one launch, bf16, contiguous
    (B, N, H, ·). Δ, the zeroed dq workspace that the kernel's atomics sum
    into, and dq's cast to bf16 are torch ops around it."""
    ops = _flash_bwd_operands(q, k, v, o, lse, do)
    _flash_bwd_launch(*ops, scale)
    return ops[6].to(torch.bfloat16), ops[7], ops[8]


def _pad_width(t: torch.Tensor, multiple: int = 8) -> torch.Tensor:
    """Zero columns up to a multiple of `multiple` (16-byte bf16 rows)."""
    pad = -t.shape[-1] % multiple
    return torch.nn.functional.pad(t, (0, pad)) if pad else t


def _flash_forward(q, k, v, scale):
    return _on_device(lambda: _flash_attention_cuda(_pad_width(q), _pad_width(k), v, scale),
                      lambda: flash_attention_plain(q, k, v, scale), q)


def _flash_backward(q, k, v, o, lse, do, scale):
    """(dq, dk, dv) in q's, k's and v's dtypes: the fused B8 kernel on CUDA, the plain
    backward on the CPU."""
    if q.device.type == "cuda":
        dqk = q.shape[-1]
        dq, dk, dv = _flash_attention_bwd_cuda(_pad_width(q), _pad_width(k), v, o, lse, do, scale)
        dq, dk = dq[..., :dqk], dk[..., :dqk]
    else:
        dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """B1 forward (saves o and lse); B8 backward (`_flash_core_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = _flash_forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        return (*_flash_backward(q, k, v, o, lse, do, ctx.scale), None)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Softmax(q·kᵀ·scale)·v over (B, N, H, ·); `scale` defaults to
    DQK**-0.5. q/k may be wider than v; the output takes v's width.

    A ragged N (4097 = CLS + 64²) needs no padding: the kernels mask keys at
    or beyond N. Differentiable: the backward runs B8 on the card.
    Returns o, or (o, lse) with `return_lse` (lse carries no gradient)."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    o, lse = _FlashAttention.apply(q, k, v, scale)
    return (o, lse) if return_lse else o


# ------------------------------------- B5 fused window qkv + rel-pos attention


def window_qkv_attention_plain(
    x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], rel_pos_h: torch.Tensor,
    rel_pos_w: torch.Tensor, num_heads: int,
) -> torch.Tensor:
    """fp32 formula of the fused window block (`_win_qkv_ref`): per window,
    qkv = x·w + b; softmax(q·scale·kᵀ + Bh + Bw)·v with the bias from the
    unscaled q; heads concatenated. Output in x's dtype."""
    nw, n, c = x.shape
    hd = c // num_heads
    side = rel_pos_h.shape[0]
    qkv = x.float() @ w.float()
    if b is not None:
        qkv = qkv + b.float()
    q, k, v = qkv.reshape(nw, n, 3, num_heads, hd).unbind(2)  # (NW, N, H, hd)
    logits = torch.einsum("wqhd,wkhd->whqk", q * hd**-0.5, k)
    rq = q.reshape(nw, side, side, num_heads, hd)
    bh = torch.einsum("wijnd,ikd->wnijk", rq, rel_pos_h.float())
    bw = torch.einsum("wijnd,jld->wnijl", rq, rel_pos_w.float())
    bias = (bh[..., :, None] + bw[..., None, :]).reshape(nw, num_heads, n, n)
    p = torch.softmax(logits + bias, dim=-1)
    return torch.einsum("whqk,wkhd->wqhd", p, v).reshape(nw, n, c).to(x.dtype)


def _window_qkv_attention_cuda(x, w, b, rel_pos_h, rel_pos_w, num_heads: int) -> torch.Tensor:
    nw, n, c = x.shape
    hd = c // num_heads
    side = rel_pos_h.shape[0]
    if (hd not in SAM_HEAD_DIMS or hd * num_heads != c or side * side != n or n > 256
            or c % 32 or w.shape != (c, 3 * c)):
        raise ValueError(
            f"window qkv kernel takes (NW, side², C) windows with side² ≤ 256, C a "
            f"multiple of 32 and head dim in {SAM_HEAD_DIMS}; got x {tuple(x.shape)}, "
            f"w {tuple(w.shape)}, {num_heads} heads, tables {tuple(rel_pos_h.shape)}"
        )
    wt = w.t().contiguous()  # (3C, C): the qkv Linear's own weight layout
    _check_rows("window qkv", x, "x")
    _check_rows("window qkv", wt, "the qkv weight")
    if not x.is_contiguous():
        raise ValueError("window qkv kernel needs contiguous x")
    bias = b.float().contiguous() if b is not None else None
    rh = rel_pos_h.to(torch.bfloat16).contiguous()
    rw = rel_pos_w.to(torch.bfloat16).contiguous()
    o = torch.empty_like(x)
    fn = _build.bind("win_qkv_attn.cu", "win_qkv_attn_fwd", "ppppppiiiiif")
    _build.LAUNCHES["window_qkv_attention"] += 1
    err = fn(
        x.data_ptr(), wt.data_ptr(), 0 if bias is None else bias.data_ptr(),
        rh.data_ptr(), rw.data_ptr(), o.data_ptr(), nw, n, c, num_heads, side,
        float(hd**-0.5), _build.stream_of(x),
    )
    _build.check(err, "win_qkv_attn_fwd")
    return o


def window_qkv_attention(
    x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], rel_pos_h: torch.Tensor,
    rel_pos_w: torch.Tensor, num_heads: int,
) -> torch.Tensor:
    """Fused qkv projection + decomposed rel-pos window attention.

    x: (NW, N, C) LN'd window tokens, N = side², the zero-padded tokens of
    edge windows included (they are projected to b and attended to, as in
    the reference); w/b: the qkv projection as (C, 3C) and (3C,) (b may be
    None); rel_pos_h/w: gathered (side, side, hd) tables (`gather_rel_pos`).
    Returns (NW, N, C), head outputs concatenated, ready for the output
    projection. Differentiable in x, w, b and the tables."""
    return _WindowQkvAttention.apply(x, w, b, rel_pos_h, rel_pos_w, num_heads)


class _WindowQkvAttention(torch.autograd.Function):
    """B5 forward; backward by recompute through `window_qkv_attention_plain`
    (`_win_qkv_core_bwd`: the VJP of `_win_qkv_ref`)."""

    @staticmethod
    def forward(ctx, x, w, b, rel_pos_h, rel_pos_w, num_heads):
        ctx.save_for_backward(x, w, b, rel_pos_h, rel_pos_w)
        ctx.num_heads = num_heads
        args = (x, w, b, rel_pos_h, rel_pos_w, num_heads)
        return _on_device(_window_qkv_attention_cuda, window_qkv_attention_plain, x, *args)

    @staticmethod
    def backward(ctx, do):
        plain = lambda *t: window_qkv_attention_plain(*t, ctx.num_heads)
        return (*_recompute_grads(plain, ctx.saved_tensors, ctx.needs_input_grad[:5], do), None)


# ------------------------------------------- rel-pos bias terms and routing


def rel_pos_bias(q: torch.Tensor, rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor,
                 grid_hw: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decomposed rel-pos terms of (B, N, H, D) q on a (gh, gw) grid:
    Bh[b, t, h, r] = q_t · RelH[row(t), r] and Bw[b, t, h, c] = q_t ·
    RelW[col(t), c], (B, N, H, gh) and (B, N, H, gw). Inputs stay in q's
    dtype; the products accumulate in fp32 and round to q's dtype, as the JAX
    package's einsums do."""
    b, n, h, d = q.shape
    gh, gw = grid_hw
    rq = q.reshape(b, gh, gw, h, d)
    bh = torch.einsum("bijnd,ikd->bijnk", rq, rel_pos_h.to(q.dtype))
    bw = torch.einsum("bijnd,jld->bijnl", rq, rel_pos_w.to(q.dtype))
    return bh.reshape(b, n, h, gh), bw.reshape(b, n, h, gw)


def relpos_aug(q: torch.Tensor, k: torch.Tensor, bh: torch.Tensor, bw: torch.Tensor,
               grid_hw: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lane-augmented q′ = [q·scale | Bh | Bw] and k′ = [k | 1{row} | 1{col}]
    (`_relpos_aug`): q′·k′ᵀ = q·kᵀ·scale + Bh[q, row(k)] + Bw[q, col(k)]."""
    gh, gw = grid_hw
    b, n, h, d = q.shape
    t = torch.arange(n, device=q.device)
    onehot = torch.cat([torch.nn.functional.one_hot(t // gw, gh),
                        torch.nn.functional.one_hot(t % gw, gw)], dim=-1).to(k.dtype)
    q_aug = torch.cat([q * d**-0.5, bh, bw], dim=-1)
    k_aug = torch.cat([k, onehot[None, :, None, :].expand(b, n, h, gh + gw)], dim=-1)
    return q_aug, k_aug


def direct_bias_fits(grid_hw: Tuple[int, int]) -> bool:
    """The JAX package's test for its direct-bias kernel: key blocks of whole
    grid rows that tile N, and N a multiple of 512 (64×64 and 32×32 grids
    pass; 20×20 does not)."""
    gh, gw = grid_hw
    n = gh * gw
    blk_k = gw * max(1, 512 // gw)
    return n % 512 == 0 and n % blk_k == 0 and gh % (blk_k // gw) == 0


def flash_attention_relpos(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rel_pos_h: torch.Tensor,
    rel_pos_w: torch.Tensor, grid_hw: Tuple[int, int],
) -> torch.Tensor:
    """SAM attention with the decomposed rel-pos bias
    (`add_decomposed_rel_pos`): softmax(q·kᵀ·scale + Bh + Bw)·v over
    token-major (B, N, H, D) q/k/v, N = gh·gw in row-major grid order, with
    gathered tables (side, side, D). Routes as the JAX package does:

    - N ≤ 256: whole-window attention (B7) on the lane-augmented q′/k′;
    - grids that `direct_bias_fits`: the direct-bias flash kernel (B6);
    - other (ragged) grids: flash attention (B1) on q′/k′, which are
      D + gh + gw wide, with scale 1.

    Returns token-major (B, N, H, D). Differentiable on every route."""
    b, n, h, d = q.shape
    if n != grid_hw[0] * grid_hw[1]:
        raise ValueError(f"{n} tokens do not form a {grid_hw} grid")
    bh, bw = rel_pos_bias(q, rel_pos_h, rel_pos_w, grid_hw)
    if n <= 256:
        return window_attention(*relpos_aug(q, k, bh, bw, grid_hw), v)
    if direct_bias_fits(grid_hw):
        return relpos_flash_attention(q, k, v, bh, bw)
    return flash_attention(*relpos_aug(q, k, bh, bw, grid_hw), v, scale=1.0)


# ------------------------------------------ B6 direct-bias flash attention


def relpos_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bh: torch.Tensor, bw: torch.Tensor) -> torch.Tensor:
    """fp32 formula: softmax(q·kᵀ·scale + Bh[q, key // gw] + Bw[q, key % gw])·v
    over (B, N, H, D), one batch element at a time (the logits are N²)."""
    b, n, h, d = q.shape
    out = []
    for i in range(b):
        logits = torch.einsum("qhd,khd->hqk", q[i].float(), k[i].float()) * d**-0.5
        bias = (bh[i].float()[..., :, None] + bw[i].float()[..., None, :]).reshape(n, h, n)
        p = torch.softmax(logits + bias.transpose(0, 1), dim=-1)
        out.append(torch.einsum("hqk,khd->qhd", p, v[i].float()))
    return torch.stack(out).to(q.dtype)


def _relpos_flash_attention_cuda(q, k, v, bh, bw) -> torch.Tensor:
    b, n, h, d = q.shape
    gh, gw = bh.shape[-1], bw.shape[-1]
    if d not in SAM_HEAD_DIMS or k.shape != q.shape or v.shape != q.shape or gh * gw != n:
        raise ValueError(
            f"rel-pos flash kernel takes equal (B, N, H, D) q/k/v with D in {SAM_HEAD_DIMS} "
            f"and N = gh·gw; got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, "
            f"grid ({gh}, {gw})"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_rows("rel-pos flash", t, name)
        if t.stride(2) != d:
            raise ValueError(f"rel-pos flash kernel needs {name} with head stride D")
    bh = bh.to(torch.bfloat16).contiguous()
    bw = bw.to(torch.bfloat16).contiguous()
    o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    fn = _build.bind("relpos_attn.cu", "relpos_attn_fwd", "ppppppiiiiiiiiiiiif")
    _build.LAUNCHES["flash_attention_relpos"] += 1
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bh.data_ptr(), bw.data_ptr(), o.data_ptr(),
        b, n, h, d, gh, gw, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), float(d**-0.5), _build.stream_of(q),
    )
    _build.check(err, "relpos_attn_fwd")
    return o


def relpos_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bh: torch.Tensor, bw: torch.Tensor) -> torch.Tensor:
    """softmax(q·kᵀ·scale + bias)·v over token-major (B, N, H, D) with
    bias[q, r·gw + j] = Bh[q, r] + Bw[q, j] (`rel_pos_bias`), never forming
    the N² bias. q/k/v may be strided views of one qkv tensor.
    Differentiable in q, k, v, Bh and Bw."""
    return _RelposFlashAttention.apply(q, k, v, bh, bw)


class _RelposFlashAttention(torch.autograd.Function):
    """B6 forward; backward through the lane-augmented formulation
    (`_relpos_core_bwd`): q′/k′ from `relpos_aug`, a wide B1 forward for o′
    and lse, B8, then dq′ sliced into dq·scale, dBh and dBw and dk′
    into dk (k′'s indicator lanes are constants)."""

    @staticmethod
    def forward(ctx, q, k, v, bh, bw):
        ctx.save_for_backward(q, k, v, bh, bw)
        return _on_device(_relpos_flash_attention_cuda, relpos_attention_plain, q, q, k, v, bh, bw)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bh, bw = ctx.saved_tensors
        d, gh = q.shape[-1], bh.shape[-1]
        q_aug, k_aug = relpos_aug(q, k, bh, bw, (gh, bw.shape[-1]))
        o_aug, lse = _flash_forward(q_aug, k_aug, v, 1.0)
        dqa, dka, dv = _flash_backward(q_aug, k_aug, v, o_aug, lse, do, 1.0)
        return (dqa[..., :d] * d**-0.5, dka[..., :d], dv, dqa[..., d:d + gh].to(bh.dtype),
                dqa[..., d + gh:].to(bw.dtype))


# ---------------------------------------------- B7 whole-window attention


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """fp32 formula: softmax(q·kᵀ)·v per batch element, no scale, over
    token-major (B, N, H, ·); q/k may be wider than v."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _window_attention_cuda(q, k, v) -> torch.Tensor:
    b, n, h, dqk = q.shape
    d = v.shape[-1]
    if (d not in SAM_HEAD_DIMS or n > 256 or k.shape != q.shape
            or v.shape[:3] != q.shape[:3] or dqk > 288):
        raise ValueError(
            f"window attention kernel takes N ≤ 256, q′/k′ ≤ 288 wide and v's D in "
            f"{SAM_HEAD_DIMS}; got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    for name, t in (("q", q), ("k", k)):
        if t.dtype != torch.bfloat16 or t.stride(-1) != 1:
            raise ValueError(f"window attention kernel needs bf16 {name} with unit last stride")
    _check_rows("window attention", v, "v")
    o = torch.empty((b, n, h, d), dtype=v.dtype, device=v.device)
    fn = _build.bind("win_attn.cu", "win_attn_fwd", "ppppiiiiiiiiiiiiii")
    _build.LAUNCHES["window_attention"] += 1
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, n, h, dqk, d,
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), _build.stream_of(q),
    )
    _build.check(err, "win_attn_fwd")
    return o


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q·kᵀ)·v per batch element over N ≤ 256 tokens, token-major
    (B, N, H, ·), with no scale (the caller folds it into q). q/k may be
    wider than v; the output takes v's width. Differentiable."""
    return _WindowAttention.apply(q, k, v)


class _WindowAttention(torch.autograd.Function):
    """B7 forward; backward by recompute through `window_attention_plain`
    (`_win_core_bwd`, an XLA recompute in the JAX package)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _on_device(_window_attention_cuda, window_attention_plain, q, q, k, v)

    @staticmethod
    def backward(ctx, do):
        return _recompute_grads(window_attention_plain, ctx.saved_tensors,
                                ctx.needs_input_grad, do)
