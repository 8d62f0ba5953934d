"""Channel-major 3×3 convolution with a fused epilogue (port of
`cellvit_tpu/ops/conv_cm.py`).

Channel-major (B, C, H, W) is torch's own NCHW, so the layout helpers are
plain permutes. `conv3x3_cm` takes the JAX package's HWIO (3, 3, C, F)
weights, so one numpy array feeds both packages. On a CUDA tensor it runs
the kernel of `csrc/conv3x3_cm.cu` (bf16 on wgmma with TMA loads, fp32 as a
plain FFMA loop); on a CPU tensor its plain version `conv3x3_cm_reference`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from cellvit_tpu_torch import _build

#: B12 in bf16 against its plain version, as a relative L2: both multiply
#: the same bf16 x and w exactly into fp32 sums and differ only in the order
#: of the 9C additions (≈1e-7 relative) before the one rounding of the output
#: to bf16, which lands a few outputs on a neighbouring bf16 value (3.0e-5 on
#: an H100 at the CellViT-256 decoder's 64→64 conv on 8 × 1024²). cuDNN's
#: bf16 conv with a bf16 bias, the model's own route, rounds once more and
#: lands 2.9e-3 from B12 there. One bf16 step on every output is 2⁻⁸; a
#: wrong tap or channel order gives errors of order 1.
CONV_BF16_L2 = 2**-8

#: output channels per block of the fp32 kernel: its packed weights' F padding
_F_TILE_F32 = 32
_KC = 16  # input channels per chunk of the fp32 kernel
#: the bf16 kernel's weight tiles: 64 output × 64 input channels
_TILE = 64


def nhwc_to_cm(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) → (B, C, H, W)."""
    return x.permute(0, 3, 1, 2)


def cm_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, H, W, C)."""
    return x.permute(0, 2, 3, 1)


def pack_kernel_cm(w: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, C, F) kernel → (F, 9C) matmul weights; tap (dy, dx)
    occupies columns [(3·dy + dx)·C, (3·dy + dx + 1)·C)."""
    kh, kw, c, f = w.shape
    assert kh == 3 and kw == 3, "3x3 only"
    return w.permute(3, 0, 1, 2).reshape(f, 9 * c)


def _check_res(x: torch.Tensor, f: int, res: torch.Tensor, res_block: int) -> None:
    bsz, _, h, wd = x.shape
    assert res.shape[0] == bsz and tuple(res.shape[2:]) == (h, wd), tuple(res.shape)
    assert res.shape[1] % f == 0 and res_block < res.shape[1] // f, (tuple(res.shape), f, res_block)


def conv3x3_cm_reference(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                         relu: bool = False, res: Optional[torch.Tensor] = None,
                         res_block: int = 0) -> torch.Tensor:
    """The plain version: `F.conv2d` in fp32 (TF32 off) on x and w rounded
    to x's type, then + b, + the `res_block` slice of `res`, ReLU, and the
    cast to x.dtype."""
    f = w.shape[-1]
    xf = x.float()
    wf = w.to(x.dtype).float().permute(3, 2, 0, 1)  # HWIO → OIHW
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        out = F.conv2d(xf, wf, padding=1)
    if b is not None:
        out = out + b.float()[None, :, None, None]
    if res is not None:
        _check_res(x, f, res, res_block)
        out = out + res[:, res_block * f:(res_block + 1) * f].float()
    if relu:
        out = torch.clamp(out, min=0.0)
    return out.to(x.dtype)


def pack_kernel_chunks(w: torch.Tensor, dtype: torch.dtype, f_tile: int) -> torch.Tensor:
    """HWIO (3, 3, C, F) → the kernel's (⌈C/16⌉, 9, F_pad, 16) weights in
    `dtype`: per chunk of 16 input channels, per tap, per output channel,
    the chunk's channels contiguous; zeros past C and past F (F_pad is F
    rounded up to `f_tile`)."""
    _, _, c, f = w.shape
    cp, fp = -(-c // _KC) * _KC, -(-f // f_tile) * f_tile
    wk = torch.zeros((cp, 9, fp), dtype=dtype, device=w.device)
    wk[:c, :, :f] = w.to(dtype).reshape(9, c, f).permute(1, 0, 2)
    return wk.reshape(cp // _KC, _KC, 9, fp).permute(0, 2, 3, 1).contiguous()


def pack_kernel_tiles(w: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, C, F) → the bf16 kernel's (⌈F/64⌉, 9, ⌈C/64⌉, 64, 64)
    weights: per tile of 64 output channels, per tap 3·dy + dx, per chunk
    of 64 input channels, a 64 × 64 tile with the output channel as its row
    and the input channels contiguous; zeros past C and past F."""
    _, _, c, f = w.shape
    n_ch, n_f = -(-c // _TILE), -(-f // _TILE)
    wk = torch.zeros((9, n_ch * _TILE, n_f * _TILE), dtype=torch.bfloat16, device=w.device)
    wk[:, :c, :f] = w.to(torch.bfloat16).reshape(9, c, f)
    return wk.reshape(9, n_ch, _TILE, n_f, _TILE).permute(3, 0, 1, 4, 2).contiguous()


def conv3x3_cm(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, rows: int = 8,
               relu: bool = False, res: Optional[torch.Tensor] = None,
               res_block: int = 0) -> torch.Tensor:
    """SAME 3×3 convolution on a channel-major (B, C, H, W) tensor.

    Args:
        x: (B, C, H, W) input, fp32 or bf16 on CUDA.
        w: HWIO (3, 3, C, F) kernel.
        b: optional (F,) bias, added pre-activation.
        rows: the JAX kernel's row-block height; H % rows == 0 is kept as
            its contract, the CUDA tiling does not depend on it.
        relu: fuse max(x, 0) into the epilogue.
        res: optional (B, kF, H, W) residual of x's type, added after the
            bias: channels [res_block·F, (res_block+1)·F), read in place.
        res_block: which F-sized channel block of `res` to add.

    Returns (B, F, H, W) in x.dtype (kernel B12 on CUDA).
    """
    bsz, c, h, wd = x.shape
    f = w.shape[-1]
    assert h % rows == 0, (h, rows)
    assert tuple(w.shape[:3]) == (3, 3, c), (tuple(w.shape), c)
    if res is not None:
        _check_res(x, f, res, res_block)
    if x.device.type == "cpu":
        return conv3x3_cm_reference(x, w, b, relu, res, res_block)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv3x3_cm takes fp32 or bf16 on CUDA; x is {x.dtype}")
    if res is not None and res.dtype != x.dtype:
        raise TypeError(f"res must be {x.dtype}, as x; got {res.dtype}")
    x = x.contiguous()
    bias = None if b is None else b.to(torch.float32).contiguous()
    res = None if res is None else res.contiguous()
    out = torch.empty((bsz, f, h, wd), dtype=x.dtype, device=x.device)
    if x.dtype == torch.bfloat16:
        wk = pack_kernel_tiles(w)
        f_pad = wk.shape[0] * _TILE
        name, fn = "conv3x3_cm_bf16", _build.bind("conv3x3_cm.cu", "conv3x3_cm_bf16", "pppppiiiiiiiii")
    else:
        wk = pack_kernel_chunks(w, x.dtype, _F_TILE_F32)
        f_pad = wk.shape[2]
        name, fn = "conv3x3_cm_f32", _build.bind("conv3x3_cm.cu", "conv3x3_cm_f32", "pppppiiiiiiiii")
    _build.LAUNCHES["conv3x3_cm"] += 1
    _build.check(
        fn(x.data_ptr(), wk.data_ptr(), 0 if bias is None else bias.data_ptr(),
           0 if res is None else res.data_ptr(), out.data_ptr(), bsz, c, h, wd, f, f_pad,
           0 if res is None else res.shape[1], res_block, int(relu), _build.stream_of(x)),
        name,
    )
    return out


def conv_t2x2_cm(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """ConvTranspose 2×2 / stride 2 on NHWC input, channel-major output: the
    JAX package's depth-to-space matmul, whose 6-D permute lands the result
    in (B, F, 2H, 2W)."""
    b, h, w, c = x.shape
    f = kernel.shape[-1]
    wmat = kernel.to(dtype).reshape(c, 4 * f)
    y = torch.matmul(x.to(dtype).reshape(b * h * w, c), wmat).reshape(b, h, w, 2, 2, f)
    y = y.permute(0, 5, 1, 3, 2, 4).reshape(b, f, 2 * h, 2 * w)
    return y + bias.to(dtype)[None, :, None, None]
