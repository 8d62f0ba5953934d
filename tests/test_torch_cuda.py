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
