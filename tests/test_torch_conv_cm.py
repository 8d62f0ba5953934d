"""The port's channel-major 3×3 conv (`conv3x3_cm` on CPU tensors, i.e. its
plain version) against the JAX package's Pallas kernel in interpret mode,
on the same numpy arrays; the layout helpers and the channel-major
transposed conv against their JAX twins."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellvit_tpu.ops import conv_cm as jconv
from cellvit_tpu_torch.ops import conv_cm

# one intra-op thread each: the suite runs as parallel pytest workers
torch.set_num_threads(1)


def _conv_inputs(rng, b, c, h, w, f):
    x = rng.standard_normal((b, c, h, w)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, f)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(f).astype(np.float32)
    return x, k, bias


@pytest.mark.parametrize("shape,rows", [
    ((2, 64, 32, 256, 64), 8),
    ((1, 8, 16, 128, 16), 4),
    ((1, 16, 8, 128, 8), 8),
])
def test_conv3x3_cm_matches_pallas(rng, shape, rows):
    b, c, h, w, f = shape
    x, k, bias = _conv_inputs(rng, b, c, h, w, f)
    want = jconv.conv3x3_cm(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), rows=rows,
                            relu=True, interpret=True)
    got = conv_cm.conv3x3_cm(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(bias),
                             rows=rows, relu=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, f, h, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_conv3x3_cm_no_bias_no_relu(rng):
    x, k, _ = _conv_inputs(rng, 1, 8, 16, 128, 8)
    want = jconv.conv3x3_cm(jnp.asarray(x), jnp.asarray(k), rows=8, interpret=True)
    got = conv_cm.conv3x3_cm(torch.from_numpy(x), torch.from_numpy(k), rows=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    assert float(got.min()) < 0  # relu really off


def test_conv3x3_cm_bf16(rng):
    x, k, bias = _conv_inputs(rng, 1, 64, 16, 128, 64)
    want = jconv.conv3x3_cm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                            jnp.asarray(bias), rows=8, relu=True, interpret=True)
    got = conv_cm.conv3x3_cm(torch.from_numpy(x).to(torch.bfloat16),
                             torch.from_numpy(k).to(torch.bfloat16), torch.from_numpy(bias),
                             rows=8, relu=True)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    rel = np.linalg.norm(got.float().numpy() - want) / np.linalg.norm(want)
    assert rel <= conv_cm.CONV_BF16_L2, rel  # the JAX kernel rounds as the plain version does


@pytest.mark.parametrize("block", [0, 1, 2])
def test_conv3x3_cm_res_block(rng, block):
    b, c, h, w, f = 1, 16, 16, 128, 8
    x, k, bias = _conv_inputs(rng, b, c, h, w, f)
    res = rng.standard_normal((b, 3 * f, h, w)).astype(np.float32)
    want = jconv.conv3x3_cm(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), rows=8, relu=True,
                            res=jnp.asarray(res), res_block=block, interpret=True)
    got = conv_cm.conv3x3_cm(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(bias),
                             rows=8, relu=True, res=torch.from_numpy(res), res_block=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_conv3x3_cm_keeps_the_row_contract(rng):
    x, k, _ = _conv_inputs(rng, 1, 8, 12, 128, 8)
    with pytest.raises(AssertionError):
        conv_cm.conv3x3_cm(torch.from_numpy(x), torch.from_numpy(k), rows=8)


def test_conv_t2x2_cm_matches_jax(rng):
    x = rng.standard_normal((2, 8, 8, 12)).astype(np.float32)
    k = (rng.standard_normal((2, 2, 12, 6)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    want = jconv.conv_t2x2_cm(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), jnp.float32)
    got = conv_cm.conv_t2x2_cm(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(bias),
                               torch.float32)
    assert tuple(got.shape) == (2, 6, 16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_pack_kernel_layout():
    w = np.zeros((3, 3, 2, 4), np.float32)
    w[2, 0, 1, 3] = 5.0  # dy=+1, dx=-1, c=1, f=3
    got = conv_cm.pack_kernel_cm(torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jconv.pack_kernel_cm(jnp.asarray(w))))
    assert got[3, (2 * 3 + 0) * 2 + 1] == 5.0 and np.count_nonzero(got) == 1


def test_pack_kernel_chunks_layout(rng):
    """The CUDA kernels' (⌈C/16⌉, 9, F_pad, 16) weights: entry [c // 16,
    3·dy + dx, f, c % 16] is w[dy, dx, c, f], zeros past C and F."""
    w = rng.standard_normal((3, 3, 20, 5)).astype(np.float32)
    got = conv_cm.pack_kernel_chunks(torch.from_numpy(w), torch.float32, 32).numpy()
    assert got.shape == (2, 9, 32, 16)
    full = np.zeros((32, 9, 32), np.float32)
    full[:20, :, :5] = w.reshape(9, 20, 5).transpose(1, 0, 2)
    np.testing.assert_array_equal(got, full.reshape(2, 16, 9, 32).transpose(0, 2, 3, 1))
    assert got[1, 5, 4, 3] == w[1, 2, 19, 4]


def test_layout_roundtrip(rng):
    x = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    nhwc = x.transpose(0, 2, 3, 1)
    t = torch.from_numpy(np.ascontiguousarray(nhwc))
    np.testing.assert_array_equal(conv_cm.nhwc_to_cm(t).numpy(), x)
    np.testing.assert_array_equal(conv_cm.cm_to_nhwc(conv_cm.nhwc_to_cm(t)).numpy(), nhwc)
    np.testing.assert_array_equal(conv_cm.nhwc_to_cm(t).numpy(),
                                  np.asarray(jconv.nhwc_to_cm(jnp.asarray(nhwc))))


# ------------------------------------------- CPU replay of B12's bf16 kernel


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _emulated_conv_sm90(x, w, bias, relu, res=None, res_block=0, fault=None):
    """numpy replay of `csrc/conv3x3_cm.cu`'s bf16 kernel on bf16 tensors:
    work items of 4 output rows × 64 pixels × 64 output channels; per chunk
    of 64 input channels and per column tap dx, a box of the 6 input rows
    y0 − 1 … y0 + 4 at columns x0 + dx − 1 … with zeros past the image and
    past C (where W is a multiple of 8: the box at x0 as TMA loads it, the
    others shifted by one pixel from 9 aligned 8-pixel chunks, a chunk zero
    unless it lies whole in the image; else element by element); each row
    tap dy a start row 2·cw + dy of it (consumer warpgroup
    cw, two output rows, N = 128); 16-deep K steps up to ⌈C/16⌉·16; the
    weights from `pack_kernel_tiles`; the epilogue's bias, residual block
    res_block·F + f0 …, ReLU and one rounding to bf16, clipped to the image
    and F. `fault` plants one defect: "dx_sign" (boxes at x0 − dx + 1),
    "edge" (the left edge's column −1 read as column 0), "past_c" (the box's
    channels past C and the weights' rows past C not zeroed) or "res_block"
    (the residual block before res_block)."""
    xf = x.float().numpy()
    bsz, c, h, wd = xf.shape
    f = w.shape[-1]
    wk = conv_cm.pack_kernel_tiles(w).float().numpy()  # (n_f, 9, n_ch, 64 f, 64 c)
    n_f, _, n_ch = wk.shape[:3]
    if fault == "past_c":  # weights' rows past C wrapped from the channels below C
        full = np.zeros((9, n_ch * 64, n_f * 64), np.float32)
        wf = w.float().numpy().reshape(9, c, f)
        full[:, :, :f] = wf[:, np.arange(n_ch * 64) % c]
        wk = full.reshape(9, n_ch, 64, n_f, 64).transpose(3, 0, 1, 4, 2)
    k_total = -(-c // 16)
    out = np.zeros((bsz, f, h, wd), np.float32)
    resf = None if res is None else res.float().numpy()
    for b in range(bsz):
        for y0 in range(0, h, 4):
            for x0 in range(0, wd, 64):
                for fi in range(n_f):
                    f0 = fi * 64
                    acc = np.zeros((2, 64, 128), np.float32)
                    for ch in range(n_ch):
                        kk = 16 * min(4, k_total - 4 * ch)
                        for dx in range(3):
                            sx = 1 - dx if fault == "dx_sign" else dx - 1  # the box's column shift
                            ys = y0 - 1 + np.arange(6)
                            cs = ch * 64 + np.arange(64)
                            ok_y, ok_c = (ys >= 0) & (ys < h), cs < c
                            if fault == "past_c":
                                ok_c[:] = True
                            if wd % 8 == 0 and sx != 0:
                                # the TMA route's shifted box: 9 aligned 8-pixel
                                # chunks around it, each whole inside the image
                                # or zero, shifted by one pixel
                                first = x0 - 8 if sx < 0 else x0
                                xs = first + np.arange(72)
                                ok_x = np.repeat([0 <= first + 8 * i and first + 8 * i + 8 <= wd for i in range(9)], 8)
                                if fault == "edge":  # the chunk left of the image read as the first one
                                    ok_x |= xs < 0
                                    xs = np.where(xs < 0, xs + 8, xs)
                            else:  # the TMA box at x0, or the element-staged boxes
                                xs = x0 + sx + np.arange(64)
                                ok_x = (xs >= 0) & (xs < wd)
                                if fault == "edge":
                                    ok_x |= xs == -1
                                    xs = np.maximum(xs, 0)
                            box = xf[b][np.ix_(cs % c, np.clip(ys, 0, h - 1), np.clip(xs, 0, wd - 1))]
                            box = box * (ok_c[:, None, None] & ok_y[None, :, None] & ok_x[None, None, :])
                            if len(xs) == 72:
                                box = box[..., 7:71] if sx < 0 else box[..., 1:65]
                            box = box.transpose(1, 0, 2)  # (6 rows, 64 channels, 64 px)
                            for dy in range(3):
                                a = wk[fi, 3 * dy + dx, ch][:, :kk]
                                for cw in range(2):
                                    bt = np.concatenate([box[2 * cw + dy], box[2 * cw + dy + 1]], axis=1)
                                    acc[cw] += a @ bt[:kk]
                    for cw in range(2):
                        for rl in range(2):
                            y = y0 + 2 * cw + rl
                            nf, nx = min(64, f - f0), min(64, wd - x0)
                            if y >= h or nf <= 0:
                                continue
                            v = acc[cw][:nf, 64 * rl:64 * rl + nx].copy()
                            if bias is not None:
                                v += bias.float().numpy()[f0:f0 + nf, None]
                            if resf is not None:
                                r0 = (res_block - (fault == "res_block")) * f + f0
                                v += resf[b, r0:r0 + nf, y, x0:x0 + nx]
                            if relu:
                                v = np.maximum(v, 0)
                            out[b, f0:f0 + nf, y, x0:x0 + nx] = v
    return torch.from_numpy(out).to(torch.bfloat16)


def _rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.parametrize("c,f,h,w,res_block", [
    (24, 16, 12, 128, 1),   # K steps past C inside one chunk; the JAX kernel's shapes
    (72, 72, 8, 128, 0),    # a second channel chunk and output tile
    (20, 8, 12, 100, 2),    # a ragged width and C not a multiple of 8
    (3, 65, 6, 70, None),   # a 3-channel input, F one past a tile, H not a multiple of 4
    (16, 8, 10, 200, 1),    # the TMA route with a last pixel tile past W, H not a multiple of 4
    (8, 16, 6, 16, 2),      # the TMA route on a width narrower than one pixel tile
])
def test_emulated_conv_kernel_matches_reference_and_pallas(rng, c, f, h, w, res_block):
    """The replay of the bf16 kernel's boxes, taps, K steps, edges and
    residual offsets within `CONV_BF16_L2` of the plain version, and of the
    JAX kernel in interpret mode where its shapes allow (C a multiple of 8,
    W of 128)."""
    x, k, bias = _conv_inputs(rng, 2, c, h, w, f)
    res = rng.standard_normal((2, 3 * f, h, w)).astype(np.float32) if res_block is not None else None
    xt, kt, rt = _bf16(x), _bf16(k), None if res is None else _bf16(res)
    rb = res_block or 0
    got = _emulated_conv_sm90(xt, kt, torch.from_numpy(bias), True, rt, rb)
    want = conv_cm.conv3x3_cm_reference(xt, kt, torch.from_numpy(bias), relu=True, res=rt, res_block=rb)
    assert got.shape == want.shape and _rel(got, want) <= conv_cm.CONV_BF16_L2
    if c % 8 == 0 and w % 128 == 0:
        jres = None if res is None else jnp.asarray(rt.float().numpy(), jnp.bfloat16)
        jax_out = jconv.conv3x3_cm(jnp.asarray(xt.float().numpy(), jnp.bfloat16),
                                   jnp.asarray(kt.float().numpy(), jnp.bfloat16), jnp.asarray(bias),
                                   rows=4, relu=True, res=jres, res_block=rb, interpret=True)
        assert _rel(got, torch.from_numpy(np.array(jax_out.astype(jnp.float32)))) <= conv_cm.CONV_BF16_L2


@pytest.mark.parametrize("fault", ["dx_sign", "edge", "past_c", "res_block"])
@pytest.mark.parametrize("w", [100, 128, 200])
def test_emulated_conv_kernel_fails_planted_faults(rng, fault, w):
    """Each planted defect of the replay lands beyond `CONV_BF16_L2`, on the
    element-staged route (W = 100) and the TMA route (W = 128, and 200 with
    a last pixel tile past the image): the dx sign
    flipped, a missing edge zero, channels past C not zeroed, the residual
    block at the wrong offset."""
    x, k, bias = _conv_inputs(rng, 1, 20, 8, w, 8)
    res = _bf16(rng.standard_normal((1, 24, 8, w)))
    xt, kt = _bf16(x), _bf16(k)
    want = conv_cm.conv3x3_cm_reference(xt, kt, torch.from_numpy(bias), res=res, res_block=2)
    ok = _emulated_conv_sm90(xt, kt, torch.from_numpy(bias), False, res, 2)
    assert _rel(ok, want) <= conv_cm.CONV_BF16_L2
    got = _emulated_conv_sm90(xt, kt, torch.from_numpy(bias), False, res, 2, fault=fault)
    assert _rel(got, want) > conv_cm.CONV_BF16_L2


def test_pack_kernel_tiles_layout(rng):
    """The bf16 kernel's (⌈F/64⌉, 9, ⌈C/64⌉, 64, 64) weights: entry [f // 64,
    3·dy + dx, c // 64, f % 64, c % 64] is w[dy, dx, c, f], zeros past C and F."""
    w = rng.standard_normal((3, 3, 70, 66)).astype(np.float32)
    got = conv_cm.pack_kernel_tiles(torch.from_numpy(w))
    assert got.shape == (2, 9, 2, 64, 64) and got.dtype == torch.bfloat16
    assert got[1, 5, 1, 1, 5].item() == torch.tensor(w[1, 2, 69, 65]).to(torch.bfloat16).item()
    assert got[0, 0, 0, 3, 2].item() == torch.tensor(w[0, 0, 2, 3]).to(torch.bfloat16).item()
    assert not got[1, :, :, 2:].any() and not got[:, :, 1, :, 6:].any()
