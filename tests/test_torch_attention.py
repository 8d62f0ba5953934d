"""Port's flash attention (plain version on CPU) against the JAX package's
Pallas flash attention in interpret mode and the einsum path, and the
bounds the CUDA kernel is held to against planted faults of its algorithm.

Tolerances (docs/PARITY.md): fp32 within 2e-4; bf16 within 1.3e-3 on
post-softmax outputs of order one (bf16 output quantization).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellvit_tpu.ops.attention import flash_attention as jax_flash
from cellvit_tpu_torch import _build
from cellvit_tpu_torch.ops.attention import (
    FLASH_BOUNDS,
    flash_attention,
    flash_attention_plain,
    flash_errors,
)

# one intra-op thread each: the suite runs as parallel pytest workers
torch.set_num_threads(1)


def _qkv(rng, b, n, h, d, scale=1.0):
    return [(rng.standard_normal((b, n, h, d)) * scale).astype(np.float32) for _ in range(3)]


def _einsum_attention(q, k, v):
    logits = np.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v), np.log(
        np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) + logits.max(-1)


@pytest.mark.parametrize("n", [64, 130, 257])
def test_flash_fp32_matches_pallas_interpret(rng, n):
    q, k, v = _qkv(rng, 2, n, 2, 64)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               block_q=64, block_k=64, interpret=True))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4)


def test_flash_fp32_matches_einsum_and_lse(rng):
    q, k, v = _qkv(rng, 1, 130, 3, 64)
    o, lse = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             return_lse=True)
    ref_o, ref_lse = _einsum_attention(q.astype(np.float64), k.astype(np.float64),
                                       v.astype(np.float64))
    np.testing.assert_allclose(o.numpy(), ref_o, atol=2e-4)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=2e-4)
    assert lse.shape == (1, 3, 130) and lse.dtype == torch.float32


def test_flash_bf16_matches_pallas_interpret(rng):
    q, k, v = _qkv(rng, 2, 130, 2, 64)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(jax_flash(jq, jk, jv, block_q=64, block_k=64, interpret=True),
                     np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
                  for a in (jq, jk, jv))
    got = flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    exact = flash_attention(tq.float(), tk.float(), tv.float()).numpy()
    assert np.abs(ref).max() < 1.0
    # the port rounds once, at the bf16 output: within one bf16 ulp of the
    # fp32 result (2**-8 below 1.0); the Pallas kernel also rounds its
    # scaled q and its exponentials to bf16, so the two agree to two ulps
    np.testing.assert_allclose(got.float().numpy(), exact, atol=2**-8)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=2 * 2**-8)


def test_flash_custom_scale(rng):
    q, k, v = _qkv(rng, 1, 64, 1, 64)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               scale=0.05, block_q=64, block_k=64, interpret=True))
    got, _ = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), scale=0.05)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4)


def _tiled_flash(q, k, v, fault, tile=64):
    """The CUDA kernel's algorithm in fp32: key tiles with a running max and
    sum, keys past N masked in the ragged last tile, p rounded to bf16 before
    p·v, o rounded to bf16. `fault` plants one of the bugs that FLASH_BOUNDS
    must catch."""
    b, n, h, d = q.shape
    n_pad = -(-n // tile) * tile
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d**-0.5
    s = torch.nn.functional.pad(s, (0, n_pad - n),
                                value=0.0 if fault == "unmasked_pad" else -np.inf)
    if fault == "dropped_key":
        s[..., n - 1] = -np.inf
    vt = torch.nn.functional.pad(v.float().transpose(1, 2), (0, 0, 0, n_pad - n))
    m = torch.full((b, h, n, 1), -np.inf)
    l, acc = torch.zeros((b, h, n, 1)), torch.zeros((b, h, n, d))
    for j in range(0, n_pad, tile):
        m_new = torch.maximum(m, s[..., j:j + tile].amax(-1, keepdim=True))
        alpha, p = torch.exp(m - m_new), torch.exp(s[..., j:j + tile] - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc if fault == "no_rescale" else acc * alpha
        acc = acc + p.to(torch.bfloat16).float() @ vt[..., j:j + tile, :]
        m = m_new
    return (acc / l).transpose(1, 2).to(torch.bfloat16), (m + torch.log(l))[..., 0]


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("fault", ["none", "no_rescale", "unmasked_pad", "dropped_key"])
def test_flash_bounds_separate_rounding_from_kernel_faults(fault, tile):
    """At 1025 tokens (|o| ≈ 0.04; one key in the last tile, as 4097 has at
    the encoder's shape) the bounds that hold the CUDA kernel to its plain
    version accept bf16 rounding and reject each planted fault, at the
    earlier 64-key tiles and at the Hopper kernel's 128-key tiles."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(np.random.default_rng(11), 1, 1025, 2, 64))
    o, lse = _tiled_flash(q, k, v, fault, tile)
    errs = flash_errors(o, lse, *flash_attention_plain(q, k, v))
    assert all(errs[key] <= bound for key, bound in FLASH_BOUNDS.items()) == (fault == "none"), errs


def test_cpu_tensors_take_the_plain_version(rng):
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 32, 1, 64))
    before = _build.LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v)
    want, _ = flash_attention_plain(q, k, v)
    assert torch.equal(got, want)
    assert _build.LAUNCHES["flash_attention"] == before
