"""Hand-written CUDA kernels against their plain PyTorch versions, on the
card. Marked `gpu`: each test skips without a CUDA device. On a machine
without JAX run them as

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from cellvit_tpu_torch import _build
from cellvit_tpu_torch.ops import attention, cc_cuda

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _masks(seed, b=2, h=96, w=160):
    rng = np.random.default_rng(seed)
    m = rng.random((b, h, w)) < 0.55
    m[0, 10:60, 10:13] = m[0, 57:60, 10:60] = m[0, 10:60, 57:60] = True
    return torch.from_numpy(m)


@pytest.mark.parametrize("n", [64, 130, 1025])
def test_flash_kernel_matches_plain(cuda, n):
    g = torch.Generator(device=cuda).manual_seed(n)
    qkv = torch.randn((2, n, 3, 3, 64), generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = _build.LAUNCHES["flash_attention"]
    o, lse = attention.flash_attention(q, k, v, return_lse=True)
    po, plse = attention.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == before + 1
    errs = attention.flash_errors(o, lse, po, plse)
    assert all(v <= attention.FLASH_BOUNDS[k] for k, v in errs.items()), errs


def test_flash_kernel_refuses_other_head_dims(cuda):
    q = torch.zeros((1, 8, 2, 32), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        attention.flash_attention(q, q, q)


@pytest.mark.parametrize("n_outer", [1, 3])
def test_scan_kernels_match_plain(cuda, n_outer):
    fg = _masks(n_outer).to(cuda)
    lab = cc_cuda.connected_components_cuda(fg, n_outer)
    assert torch.equal(lab, cc_cuda.connected_components_plain(fg, n_outer))
    seed, open_ = cc_cuda.border_seed(fg), ~fg
    assert torch.equal(cc_cuda.flood_cuda(seed, open_, n_outer),
                       cc_cuda.flood_plain(seed, open_, n_outer))
    rank = torch.arange(fg[0].numel(), device=cuda, dtype=torch.int32).reshape(fg.shape[1:])
    seed = torch.where(lab > 0, rank.expand_as(lab), cc_cuda.INT_MAX)
    assert torch.equal(cc_cuda.propagate_min_cuda(seed, fg, n_outer),
                       cc_cuda.propagate_min_plain(seed, fg, n_outer))


def _bf16(g, shape, device, std=1.0):
    return (torch.randn(shape, generator=g, device=device) * std).to(torch.bfloat16)


def _windows(g, cuda, b, side_grid, window, c):
    """LN'd-like tokens (B, side_grid², C) cut into zero-padded windows, as
    the SAM block feeds B5: edge windows carry zero rows."""
    grid = torch.randn((b, side_grid, side_grid, c), generator=g, device=cuda)
    pad = (window - side_grid % window) % window
    grid = torch.nn.functional.pad(grid, (0, 0, 0, pad, 0, pad))
    n = (side_grid + pad) // window
    x = grid.reshape(b, n, window, n, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * n * n, window * window, c).to(torch.bfloat16).contiguous()


@pytest.mark.parametrize("c,heads,window,bias", [(1280, 16, 14, True), (768, 12, 16, True),
                                                 (1280, 16, 14, False)])
def test_window_qkv_kernel_matches_plain(cuda, c, heads, window, bias):
    g = torch.Generator(device=cuda).manual_seed(c + window)
    hd = c // heads
    x = _windows(g, cuda, 1, 2 * window + 3, window, c)
    w = _bf16(g, (c, 3 * c), cuda, c**-0.5)
    b = _bf16(g, (3 * c,), cuda, 0.1) if bias else None
    rh, rw = (_bf16(g, (window, window, hd), cuda, 0.1) for _ in range(2))
    before = _build.LAUNCHES["window_qkv_attention"]
    o = attention.window_qkv_attention(x, w, b, rh, rw, heads)
    ref = attention.window_qkv_attention_plain(x, w, b, rh, rw, heads)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["window_qkv_attention"] == before + 1
    errs = attention.attn_errors(o, ref)
    assert attention.within(errs, attention.WIN_QKV_BOUNDS), errs


@pytest.mark.parametrize("grid_hw,heads,d", [((32, 32), 2, 80), ((64, 64), 2, 64), ((16, 32), 3, 80)])
def test_relpos_flash_kernel_matches_plain(cuda, grid_hw, heads, d):
    g = torch.Generator(device=cuda).manual_seed(grid_hw[0] + d)
    n = grid_hw[0] * grid_hw[1]
    qkv = _bf16(g, (2, n, 3, heads, d), cuda)
    q, k, v = qkv.unbind(2)
    rh = _bf16(g, (grid_hw[0], grid_hw[0], d), cuda, 0.1)
    rw = _bf16(g, (grid_hw[1], grid_hw[1], d), cuda, 0.1)
    bh, bw = attention.rel_pos_bias(q, rh, rw, grid_hw)
    before = _build.LAUNCHES["flash_attention_relpos"]
    o = attention.flash_attention_relpos(q, k, v, rh, rw, grid_hw)
    ref = attention.relpos_attention_plain(q, k, v, bh, bw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention_relpos"] == before + 1
    errs = attention.attn_errors(o, ref)
    assert attention.within(errs, attention.RELPOS_BOUNDS), errs


@pytest.mark.parametrize("grid_hw,d", [((14, 16), 80), ((8, 8), 64), ((13, 16), 64)])
def test_window_kernel_matches_plain(cuda, grid_hw, d):
    g = torch.Generator(device=cuda).manual_seed(grid_hw[1] + d)
    n = grid_hw[0] * grid_hw[1]
    qkv = _bf16(g, (2, n, 3, 3, d), cuda)
    q, k, v = qkv.unbind(2)
    rh = _bf16(g, (grid_hw[0], grid_hw[0], d), cuda, 0.1)
    rw = _bf16(g, (grid_hw[1], grid_hw[1], d), cuda, 0.1)
    q_aug, k_aug = attention.relpos_aug(q, k, *attention.rel_pos_bias(q, rh, rw, grid_hw), grid_hw)
    before = _build.LAUNCHES["window_attention"]
    o = attention.flash_attention_relpos(q, k, v, rh, rw, grid_hw)
    ref = attention.window_attention_plain(q_aug, k_aug, v)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["window_attention"] == before + 1
    errs = attention.attn_errors(o, ref)
    assert attention.within(errs, attention.WINDOW_BOUNDS), errs


def test_ragged_relpos_grid_raises_on_the_card(cuda):
    q = torch.zeros((1, 400, 2, 80), dtype=torch.bfloat16, device=cuda)
    r = torch.zeros((20, 20, 80), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP C5"):
        attention.flash_attention_relpos(q, q, q, r, r, (20, 20))
