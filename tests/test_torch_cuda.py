"""Hand-written CUDA kernels against their plain PyTorch versions, on the
card. Marked `gpu`: each test skips without a CUDA device. On a machine
without JAX run them as

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from cellvit_tpu_torch import _build
from cellvit_tpu_torch.ops import attention, cc, cc_cuda, conv_cm

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


def test_ragged_relpos_grid_takes_the_wide_flash_kernel(cuda):
    """A 20×20 grid fits neither B6 nor B7: B1 runs on q′/k′ 80 + 20 + 20
    wide against v of width 80, scale 1."""
    g = torch.Generator(device=cuda).manual_seed(20)
    q, k, v = _bf16(g, (1, 400, 3, 2, 80), cuda).unbind(2)
    rh, rw = (_bf16(g, (20, 20, 80), cuda, 0.1) for _ in range(2))
    bh, bw = attention.rel_pos_bias(q, rh, rw, (20, 20))
    before = _build.LAUNCHES["flash_attention"]
    o = attention.flash_attention_relpos(q, k, v, rh, rw, (20, 20))
    ref = attention.relpos_attention_plain(q, k, v, bh, bw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == before + 1
    errs = attention.attn_errors(o, ref)
    assert attention.within(errs, attention.RELPOS_BOUNDS), errs


def _wide(g, cuda, b, n, h, dqk, dv):
    """q′/k′ of width dqk whose logits at scale 1 have unit variance, and v."""
    q = _bf16(g, (b, n, h, dqk), cuda, dqk**-0.25)
    k = _bf16(g, (b, n, h, dqk), cuda, dqk**-0.25)
    return q, k, _bf16(g, (b, n, h, dv), cuda)


@pytest.mark.parametrize("n,dqk,dv", [(400, 120, 80), (1024, 208, 80), (513, 192, 64),
                                      (130, 80, 80), (97, 72, 64)])
def test_wide_flash_kernel_matches_plain(cuda, n, dqk, dv):
    q, k, v = _wide(torch.Generator(device=cuda).manual_seed(n + dqk), cuda, 1, n, 2, dqk, dv)
    before = _build.LAUNCHES["flash_attention"]
    o, lse = attention.flash_attention(q, k, v, scale=1.0, return_lse=True)
    po, plse = attention.flash_attention_plain(q, k, v, scale=1.0)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == before + 1
    assert o.shape == (1, n, 2, dv)
    errs = attention.flash_errors(o, lse, po, plse)
    assert attention.within(errs, attention.FLASH_BOUNDS), errs


def _bwd_inputs(cuda, b, n, h, dqk, dv, scale, strided):
    """q, k, v (strided views of one qkv tensor, or q′/k′ wider than v), the
    forward's o and lse, and do."""
    g = torch.Generator(device=cuda).manual_seed(n + dqk)
    if strided:
        q, k, v = _bf16(g, (b, n, 3, h, dqk), cuda).unbind(2)
    else:
        q, k, v = _wide(g, cuda, b, n, h, dqk, dv)
    do = _bf16(g, (b, n, h, dv), cuda, 0.02)
    o, lse = attention.flash_attention(q, k, v, scale=scale, return_lse=True)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("b,n,h,dqk,dv,scale,strided", [
    (2, 130, 3, 64, 64, None, False), (1, 1025, 2, 64, 64, None, False),
    (1, 400, 2, 120, 80, 1.0, False), (1, 256, 2, 208, 80, 1.0, False),
    (1, 1, 2, 64, 64, None, True), (2, 17, 3, 64, 64, None, True), (1, 127, 2, 64, 64, None, True),
    (1, 129, 2, 64, 64, None, True), (1, 4097, 2, 64, 64, None, True),
    (1, 300, 2, 64, 80, 1.0, False), (1, 300, 2, 256, 80, 1.0, False),
    (1, 333, 2, 80, 80, None, True),
])
def test_flash_bwd_kernels_match_plain(cuda, b, n, h, dqk, dv, scale, strided):
    """The fused B8 kernel, one launch, against the fp32 plain backward: N
    ragged against the 64-query and the 128-key tile, qkv-strided views, and
    v 80 wide against q/k 64, 80, 120, 208 and 256. At N = 1, ds is 0 up to
    rounding (p = 1, dp = Δ), so dq and dk are held to 0 absolutely."""
    scale = dqk**-0.5 if scale is None else scale
    q, k, v, o, lse, do = _bwd_inputs(cuda, b, n, h, dqk, dv, scale, strided)
    before = dict(_build.LAUNCHES)
    grads = attention._flash_attention_bwd_cuda(q, k, v, o, lse, do, scale)
    ref = attention.flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    assert {k_: v_ - before[k_] for k_, v_ in _build.LAUNCHES.items() if v_ != before[k_]} == {
        "flash_attention_bwd": 1}
    assert [t.shape for t in grads] == [t.shape for t in ref]
    if n == 1:
        assert all(t.float().abs().max().item() <= 1e-4 for t in grads[:2])
        assert attention.within(attention.attn_errors(grads[2], ref[2]), attention.FLASH_BWD_BOUNDS)
        return
    errs = attention.flash_bwd_errors(grads, ref)
    assert attention.within_bwd(errs), errs


@pytest.mark.parametrize("n,dqk,dv", [(1025, 64, 64), (400, 208, 80)])
def test_flash_bwd_dq_run_to_run_within_one_ulp(cuda, n, dqk, dv):
    """dq's fp32 partials are summed by atomics in an order that changes
    between runs: two calls on the same inputs differ by at most one bf16
    ulp of max|dq|; dk and dv are summed in a fixed order and equal."""
    q, k, v, o, lse, do = _bwd_inputs(cuda, 2, n, 2, dqk, dv, 1.0, False)
    first = attention._flash_attention_bwd_cuda(q, k, v, o, lse, do, 1.0)
    second = attention._flash_attention_bwd_cuda(q, k, v, o, lse, do, 1.0)
    spread = (first[0].float() - second[0].float()).abs().max().item()
    assert spread <= attention.bf16_ulp(first[0].float().abs().max().item()), spread
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])


def _grads(fn, inputs, do):
    leaves = [t.detach().requires_grad_() for t in inputs]
    return torch.autograd.grad(fn(*leaves), leaves, do)


@pytest.mark.parametrize("route", ["flash", "relpos_b6", "relpos_ragged", "window", "window_qkv"])
def test_autograd_ops_match_plain_gradients(cuda, route):
    """Each op's gradients on the card against autograd through its plain
    version on the same inputs."""
    g = torch.Generator(device=cuda).manual_seed(7)
    if route == "flash":
        q, k, v = _bf16(g, (2, 1025, 3, 2, 64), cuda).unbind(2)
        inputs = (q, k, v)
        fn = attention.flash_attention
        plain = lambda q, k, v: attention.flash_attention_plain(q, k, v)[0]
    elif route.startswith("relpos"):
        side = 32 if route == "relpos_b6" else 20
        q, k, v = _bf16(g, (1, side * side, 3, 2, 80), cuda).unbind(2)
        rh, rw = (_bf16(g, (side, side, 80), cuda, 0.1) for _ in range(2))
        inputs = (q, k, v, rh, rw)
        fn = lambda *t: attention.flash_attention_relpos(*t, (side, side))
        plain = lambda q, k, v, rh, rw: attention.relpos_attention_plain(
            q, k, v, *attention.rel_pos_bias(q, rh, rw, (side, side)))
    elif route == "window":
        q, k, v = _bf16(g, (2, 224, 3, 2, 80), cuda).unbind(2)
        rh, rw = _bf16(g, (14, 14, 80), cuda, 0.1), _bf16(g, (16, 16, 80), cuda, 0.1)
        inputs = attention.relpos_aug(q, k, *attention.rel_pos_bias(q, rh, rw, (14, 16)), (14, 16))
        inputs = (*inputs, v)
        fn, plain = attention.window_attention, attention.window_attention_plain
    else:
        c, heads = 256, 4
        x = _windows(g, cuda, 1, 17, 14, c)
        w, b = _bf16(g, (c, 3 * c), cuda, c**-0.5), _bf16(g, (3 * c,), cuda, 0.1)
        rh, rw = (_bf16(g, (14, 14, c // heads), cuda, 0.1) for _ in range(2))
        inputs = (x, w, b, rh, rw)
        fn = lambda *t: attention.window_qkv_attention(*t, heads)
        plain = lambda *t: attention.window_qkv_attention_plain(*t, heads)
    with torch.no_grad():
        do = torch.randn(fn(*inputs).shape, generator=g, device=cuda).to(torch.bfloat16) * 0.02
    grads = _grads(fn, inputs, do)
    ref = _grads(plain, inputs, do)
    for i, (a, r) in enumerate(zip(grads, ref)):
        assert a.dtype == inputs[i].dtype and a.shape == inputs[i].shape
        errs = attention.attn_errors(a, r)
        assert attention.within(errs, attention.FLASH_BWD_BOUNDS), (i, errs)


@pytest.mark.parametrize("frozen", [False, True])
def test_tiny_train_step_on_the_card(cuda, frozen):
    """A CellViT with 64-wide heads at 512² (1025 tokens, the flash route)
    takes one bf16 training step on the card: B1 in every block, and B8
    in every block unless the encoder is frozen; finite metrics, and the
    trainable parameters move."""
    from cellvit_tpu_torch.models.cellvit import CellViT
    from cellvit_tpu_torch.synthetic import TISSUE_TYPES, training_batch
    from cellvit_tpu_torch.train.optim import make_lr_schedule, retrieve_optimizer
    from cellvit_tpu_torch.train.trainer import (CellViTTrainer, default_loss_fn_dict,
                                                 prepare_batch)

    torch.manual_seed(0)
    model = CellViT(6, 19, 128, 4, 2, (1, 2, 3, 4), drop_path_rate=0.1)
    tx = retrieve_optimizer("AdamW", {"lr": 3e-4, "weight_decay": 1e-4},
                            make_lr_schedule("exponential", 3e-4, 10, 1, gamma=0.85))
    trainer = CellViTTrainer(model, default_loss_fn_dict(), tx, 6, TISSUE_TYPES, device="cuda",
                             mixed_precision=True)
    batch = trainer.to_device(prepare_batch(training_batch(1, 512, 3), TISSUE_TYPES))
    before = [p.detach().clone() for p in trainer.params]
    _build.reset_launches()
    metrics = trainer._host(trainer.train_step(batch, freeze_encoder=frozen))
    torch.cuda.synchronize()
    b8 = 0 if frozen else 4
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        k: v for k, v in {"flash_attention": 4, "flash_attention_bwd": b8}.items() if v}
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    moved = {n for n, p, p0 in zip(trainer.param_names, trainer.params, before)
             if not torch.equal(p.detach(), p0)}
    assert {"encoder.head.weight", "hv_map_decoder.decoder0_header.2.weight"} <= moved
    frozen_names = {n for n, keep in zip(trainer.param_names, trainer.trainable_frozen) if not keep}
    assert ("encoder.blocks.0.attn.qkv.weight" in moved) != frozen
    if frozen:
        assert not moved & frozen_names


def _labels_on(cuda, seed, b=2, h=100, w=150, p=0.35):
    """Compacted labels of a noisy mask, H and W not multiples of 32."""
    m = torch.from_numpy(np.random.default_rng(seed).random((b, h, w)) < p)
    return cc.connected_components(m).to(cuda)


@pytest.mark.parametrize("min_size", [1, 2, 10])
def test_window_size_filter_kernel_matches_plain(cuda, min_size):
    lab = _labels_on(cuda, min_size)
    before = _build.LAUNCHES["remove_small_objects"]
    got = cc_cuda.remove_small_objects_cuda(lab, min_size)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["remove_small_objects"] == before + (min_size > 1)
    assert torch.equal(got, cc.remove_small_objects_window(lab, min_size))


@pytest.mark.parametrize("min_size,bins", [(1, (64, 128)), (2, (64, 128)), (10, (64, 128)),
                                           (10, (4, 8))])
def test_bincount_kernels_match_plain(cuda, min_size, bins):
    lab = _labels_on(cuda, 20 + min_size)
    lab[0, 0, :3] = torch.tensor([-5, 2**30, 8192], dtype=torch.int32)
    hist = cc_cuda.radix_histogram_cuda(lab, *bins)
    assert torch.equal(hist, cc.radix_histogram(lab, *bins))
    assert torch.equal(cc_cuda.radix_keep_cuda(lab, hist, min_size), cc.radix_keep(lab, hist, min_size))
    got = cc_cuda.remove_small_objects_bincount_cuda(lab, min_size, *bins)
    torch.cuda.synchronize()
    assert torch.equal(got, cc.remove_small_objects_bincount(lab, min_size, bins[0] * bins[1], bins[0]))


def _disc_flood(cuda, seed, b=2, h=100, w=150, n=12, grown=False):
    """Disc masks with relief −exp(−r²/R²): one marker pixel per disc, or
    with `grown` its core of radius R − 3."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.zeros((b, h, w), np.float32)
    mask = np.zeros((b, h, w), bool)
    mark = np.zeros((b, h, w), np.int32)
    for i in range(b):
        for k in range(1, n + 1):
            cy, cx, r = int(rng.integers(8, h - 8)), int(rng.integers(8, w - 8)), int(rng.integers(5, 12))
            d2 = (yy - cy) ** 2 + (xx - cx) ** 2
            mask[i] |= d2 <= r * r
            img[i] = np.minimum(img[i], -np.exp(-d2 / (r * r)))
            if grown:
                mark[i][d2 <= (r - 3) ** 2] = k
            else:
                mark[i, cy, cx] = k
    return tuple(torch.from_numpy(a).to(cuda) for a in (img, mark * mask, mask))


@pytest.mark.parametrize("grown,kw", [(False, {}), (True, {}),
                                      (False, dict(levels=4, inner_iters=1, max_final_iters=3)),
                                      (False, dict(levels=5, inner_iters=3, max_final_iters=13))])
def test_watershed_kernel_matches_plain(cuda, grown, kw):
    img, mark, mask = _disc_flood(cuda, 3, grown=grown)
    before = _build.LAUNCHES["watershed"]
    got, passes = cc_cuda.watershed_cuda(img, mark, mask, return_passes=True, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["watershed"] == before + 1
    want, want_passes = cc_cuda.watershed_cuda(img.cpu(), mark.cpu(), mask.cpu(),
                                               return_passes=True, **kw)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(passes.cpu(), want_passes)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,f,with_res", [(8, 8, False), (48, 72, True), (48, 16, False)])
def test_conv3x3_kernel_matches_plain(cuda, dtype, c, f, with_res):
    """W = 100 (not a multiple of the 64-pixel tile), H = 12 (rows 4);
    F = 72 spans two output-channel blocks. bf16 within `CONV_BF16_L2`,
    fp32 within 2e-5 (the JAX test's bound)."""
    g = torch.Generator(device=cuda).manual_seed(c + f)
    x = torch.randn((2, c, 12, 100), generator=g, device=cuda).to(dtype)
    w = (torch.randn((3, 3, c, f), generator=g, device=cuda) * 0.1).to(dtype)
    b = torch.randn(f, generator=g, device=cuda)
    res = torch.randn((2, 3 * f, 12, 100), generator=g, device=cuda).to(dtype) if with_res else None
    before = _build.LAUNCHES["conv3x3_cm"]
    got = conv_cm.conv3x3_cm(x, w, b, rows=4, relu=True, res=res, res_block=1)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["conv3x3_cm"] == before + 1
    want = conv_cm.conv3x3_cm_reference(x, w, b, relu=True, res=res, res_block=1)
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    else:
        rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
        assert rel <= conv_cm.CONV_BF16_L2, rel
