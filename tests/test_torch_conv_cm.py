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
