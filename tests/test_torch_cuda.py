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
    """Random masks (55% open) with a U shape in image 0."""
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


# the resident-tile kernel of B2/B4 (128 × 256 tiles) and the bit-packed
# cluster kernel of B3 (flood and hole filling): the test masks, more
# passes, a 9-image batch of 1024² (more than one wave of images), ragged
# shapes that no tile divides, widths that are no multiple of 32, a single
# row and column, 1400², and an all-open image (one run across every tile)
# and an all-closed one
@pytest.mark.parametrize("b,h,w,n_outer,fill", [
    (2, 96, 160, 1, None), (2, 96, 160, 3, None), (2, 96, 160, 4, None), (9, 1024, 1024, 3, None),
    (1, 1000, 1030, 3, None), (2, 224, 256, 3, None), (2, 1, 700, 3, None), (2, 700, 1, 3, None),
    (1, 1400, 1400, 3, None), (2, 300, 520, 3, True), (2, 300, 520, 3, False),
    (3, 77, 33, 2, None), (2, 130, 95, 4, None), (9, 1024, 1024, 2, None),
])
def test_scan_kernels_match_plain(cuda, b, h, w, n_outer, fill):
    fg = _masks(n_outer + h + w, b, h, w).to(cuda)
    if fill is not None:
        fg[:] = fill
    before = dict(_build.LAUNCHES)
    lab = cc_cuda.connected_components_cuda(fg, n_outer)
    assert _build.LAUNCHES["connected_components"] == before["connected_components"] + 1
    assert torch.equal(lab, cc_cuda.connected_components_plain(fg, n_outer))
    seed, open_ = cc_cuda.border_seed(fg), ~fg
    interior = torch.rand(fg.shape, generator=torch.Generator(device=cuda).manual_seed(w), device=cuda) < 0.01
    for s in (seed, interior):
        got = cc_cuda.flood_cuda(s, open_, n_outer)
        assert got.dtype == torch.bool and torch.equal(got, cc_cuda.flood_plain(s, open_, n_outer))
    filled = cc_cuda.fill_holes_cuda(fg, n_outer)
    assert torch.equal(filled, fg | (open_ & ~cc_cuda.flood_plain(seed, open_, n_outer)))
    assert _build.LAUNCHES["flood"] == before["flood"] + 3  # one launch a call
    rank = torch.arange(fg[0].numel(), device=cuda, dtype=torch.int32).reshape(fg.shape[1:])
    g = torch.Generator(device=cuda).manual_seed(h + w)
    wide = torch.randint(-2**31, 2**31 - 1, fg.shape, generator=g, device=cuda, dtype=torch.int32)
    wide[..., ::3] = cc_cuda.INT_MAX  # B4 takes any int32 seed, INT_MAX and negatives included
    for seed in (torch.where(lab > 0, rank.expand_as(lab), cc_cuda.INT_MAX), wide):
        n = _build.LAUNCHES["propagate_min"]
        got = cc_cuda.propagate_min_cuda(seed, fg, n_outer)
        assert _build.LAUNCHES["propagate_min"] == n + 1
        assert torch.equal(got, cc_cuda.propagate_min_plain(seed, fg, n_outer))
    assert torch.equal(cc_cuda.compact_root_labels_cuda(lab, n_outer),
                       cc_cuda.compact_root_labels_cuda(lab.cpu(), n_outer).to(cuda))


@pytest.mark.parametrize("b,h,w", [
    (1, 2048, 2048), (2, 2048, 100), (2, 64, 2048), (2, 20, 2048), (3, 60, 1030), (2, 100, 513),
    (2, 1400, 1400),
])
def test_flood_kernel_at_its_limits_and_cluster_widths(cuda, b, h, w):
    """B3 at the edges of `FLOOD_MAX_HW` (beyond B2/B4's reach) and on the
    cluster widths short images take (1, 2 and 4 blocks an image; 8 from
    129 rows on), against the plain flood."""
    fg = _masks(h + w, b, h, w).to(cuda)
    seed, open_ = cc_cuda.border_seed(fg), ~fg
    assert cc_cuda.flood_cluster(h, w) == min(8, 1 << max(0, (-(-h // 32) - 1).bit_length()))
    for n_outer in (1, 2):
        want = cc_cuda.flood_plain(seed, open_, n_outer)
        assert torch.equal(cc_cuda.flood_cuda(seed, open_, n_outer), want)
        assert torch.equal(cc_cuda.fill_holes_cuda(fg, n_outer), fg | (open_ & ~want))


@pytest.mark.parametrize("h,w", [(1537, 64), (64, 2049), (2049, 64)])
def test_scan_kernels_refuse_beyond_their_limit(cuda, h, w):
    fg = torch.ones((1, h, w), dtype=torch.bool, device=cuda)
    calls = (
        (cc_cuda.RESIDENT_MAX_HW, (lambda: cc_cuda.connected_components_cuda(fg),
                                   lambda: cc_cuda.propagate_min_cuda(torch.zeros_like(fg, dtype=torch.int32), fg))),
        (cc_cuda.FLOOD_MAX_HW, (lambda: cc_cuda.flood_cuda(fg, fg), lambda: cc_cuda.fill_holes_cuda(fg))),
    )
    for (max_h, max_w), fns in calls:
        if h <= max_h and w <= max_w:
            continue
        for fn in fns:
            with pytest.raises(ValueError, match=str(max_h if h > max_h else max_w)):
                fn()


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


def _bf16_close(got, want, max_rel=4e-3, l2=3e-3):
    """bf16 results against an fp32 reference: one rounding (≤ 2⁻⁹ of each
    value) and the sums' order."""
    errs = attention.attn_errors(got, want)
    assert errs["max"] <= max_rel and errs["l2"] <= l2, errs


# SAM-H (C 1280, 16 × 80), SAM-B (768, 12 × 64) and SAM-L (1024, 16 × 64);
# side 14 (two 128-key tiles, the second ragged) and 16 (N = 256, exactly
# two); 9 windows of a 31² grid with zero-padded edge windows, or the 224×256
# tile's 2 (NW·N = 392, not a multiple of the projection's 128-row tile); and
# no qkv bias.
@pytest.mark.parametrize("c,heads,window,bias,batch,side_grid", [
    (1280, 16, 14, True, 1, 31), (768, 12, 16, True, 1, 35), (1280, 16, 14, False, 1, 31),
    (1024, 16, 14, True, 1, 31), (768, 12, 14, True, 1, 31), (1280, 16, 16, True, 1, 35),
    (1280, 16, 14, True, 2, 14),
])
def test_window_qkv_kernel_matches_plain(cuda, c, heads, window, bias, batch, side_grid):
    g = torch.Generator(device=cuda).manual_seed(c + window + batch)
    hd = c // heads
    x = _windows(g, cuda, batch, side_grid, window, c)
    w = _bf16(g, (c, 3 * c), cuda, c**-0.5)
    b = _bf16(g, (3 * c,), cuda, 0.1) if bias else None
    rh, rw = (_bf16(g, (window, window, hd), cuda, 0.1) for _ in range(2))
    before = dict(_build.LAUNCHES)
    o = attention.window_qkv_attention(x, w, b, rh, rw, heads)
    ref = attention.window_qkv_attention_plain(x, w, b, rh, rw, heads)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["window_qkv_attention"] == before["window_qkv_attention"] + 1
    assert _build.LAUNCHES["flash_attention_relpos"] == before["flash_attention_relpos"]
    errs = attention.attn_errors(o, ref)
    assert attention.within(errs, attention.WIN_QKV_BOUNDS), errs

    # the three kernels' own results: the same o again, the bf16 qkv and the
    # base-2 bias terms against their plain twins on the kernels' inputs
    o2, qkv, bh, bw = attention._window_qkv_attention_launch(x, w, b, rh, rw, heads)
    assert torch.equal(o, o2)
    nw, n = x.shape[:2]
    _bf16_close(qkv, attention.win_qkv_proj_plain(x.reshape(nw * n, c).float(), w, b))
    q = qkv.reshape(nw, n, 3, heads, hd)[:, :, 0]
    want = attention.win_qkv_terms_plain(q.float(), rh, rw)
    for got, ref_t in zip((bh, bw), want):
        _bf16_close(got[..., :window].float() / 1.4426950408889634, ref_t)
        assert not got[..., window:].any()


@pytest.mark.parametrize("m,c,bias", [(392, 1280, True), (1000, 768, True), (39200, 1280, False)])
def test_window_qkv_projection_matches_plain(cuda, m, c, bias):
    """B5's projection kernel alone: rows past the last 128-row tile, SAM-B's
    and SAM-H's widths, SAM-H's 200 windows, no bias."""
    g = torch.Generator(device=cuda).manual_seed(m)
    x = _bf16(g, (m, c), cuda)
    w = _bf16(g, (c, 3 * c), cuda, c**-0.5)
    b = _bf16(g, (3 * c,), cuda, 0.1) if bias else None
    got = attention.win_qkv_proj(x, w, b)
    _bf16_close(got, attention.win_qkv_proj_plain(x.float(), w, b))


@pytest.mark.parametrize("grid_hw,heads,d", [((32, 32), 2, 80), ((64, 64), 2, 64), ((16, 32), 3, 80),
                                             ((64, 16), 2, 64), ((128, 8), 1, 80), ((160, 48), 1, 64),
                                             ((32, 32), 1, 64), ((64, 8), 1, 64), ((32, 16), 2, 80),
                                             ((160, 48), 1, 80)])
def test_relpos_flash_kernel_matches_plain(cuda, grid_hw, heads, d):
    """B6 on every grid width the kernel holds in registers (64, 32, 16, 8)
    and on one it gathers per logit (48: a 160×48 grid, which the routing
    also sends to B6), each at D 64 and 80: with SAM-H's 64×64 grid at D 80
    in `chip_smoke.py`, every instantiation `relpos_attn.cu` can launch."""
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


@pytest.mark.parametrize("dqk", [96, 110, 112, 288])
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("n", [1, 17, 196, 224, 256])
def test_window_kernel_widths_match_plain(cuda, n, d, dqk):
    """B7 on q′/k′ strided out of one buffer (rows padded to 8 elements, or,
    at 110, unpadded: the wrapper copies them into 16-byte rows) and v out of
    a qkv buffer."""
    g = torch.Generator(device=cuda).manual_seed(n + d + dqk)
    width = dqk if dqk % 8 else dqk + 8
    qk = _bf16(g, (2, n, 2, 3, width), cuda, dqk**-0.25)
    q, k = qk[..., :dqk].unbind(2)
    v = _bf16(g, (2, n, 3, 3, d), cuda)[:, :, 1]
    ref = attention.window_attention_plain(q, k, v)
    before = _build.LAUNCHES["window_attention"]
    o = attention.window_attention(q, k, v)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["window_attention"] == before + 1
    errs = attention.attn_errors(o, ref)
    assert o.shape == (2, n, 3, d) and attention.within(errs, attention.WINDOW_BOUNDS), errs


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
                                      (130, 80, 80), (97, 72, 64), (257, 224, 64), (200, 160, 80),
                                      (300, 64, 80)])
def test_wide_flash_kernel_matches_plain(cuda, n, dqk, dv):
    """B1 on q′/k′ of the rel-pos routes' widths: with the encoder's 64-wide
    heads above, every instantiation `flash_attn.cu` can launch (q/k
    buckets of 64, 128, 192 and 256 columns, each against v 64 and 80
    wide)."""
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


def _size_filter_labels(seed, b, h, w, max_id=2**30):
    """Discs of radius 0-11 with random ids in 1 … max_id − 1, over noise of
    ids −5 … 19 on 2% of the pixels, and the ids −5, 8192 and 2³⁰ at the
    first pixels: components of every size, the window's early exit inside
    the large ones, ids the radix table clips and overflows."""
    rng = np.random.default_rng(seed)
    lab = np.zeros((b, h, w), np.int32)
    for i in range(b):
        noise = rng.random((h, w)) < 0.02
        lab[i][noise] = rng.integers(-5, 20, int(noise.sum()))
        for _ in range(max(1, h * w // 400)):
            cy, cx, r = int(rng.integers(0, h)), int(rng.integers(0, w)), int(rng.integers(0, 12))
            y0, x0 = max(cy - r, 0), max(cx - r, 0)
            yy, xx = np.mgrid[y0:min(cy + r + 1, h), x0:min(cx + r + 1, w)]
            lab[i, y0:cy + r + 1, x0:cx + r + 1][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = rng.integers(1, max_id)
    lab.reshape(-1)[:3] = [-5, 8192, 2**30][:lab.size]
    return lab


# B10: the TMA route (W a multiple of 4) and the element-staged one, single
# pixels, ragged tiles, min_size 2 up to the limit, and 9 × 1024² (4608
# tiles of 32 × 64 at min_size 10: more than the persistent grid's blocks,
# so that each block walks several tiles)
@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 77, 33), (2, 40, 1030), (2, 96, 160), (9, 1024, 1024)])
@pytest.mark.parametrize("min_size", [2, 10, 64, cc_cuda.RM_SMALL_MAX_MIN_SIZE])
def test_window_size_filter_kernel_shapes(cuda, shape, min_size):
    lab = torch.from_numpy(_size_filter_labels(min_size, *shape)).to(cuda)
    before = _build.LAUNCHES["remove_small_objects"]
    got = cc_cuda.remove_small_objects_cuda(lab, min_size)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["remove_small_objects"] == before + 1
    want = cc.remove_small_objects_window(lab, min_size)
    assert torch.equal(got, want), int((got != want).sum())
    if shape[0] == 9 and min_size == 10:
        assert 0 < int((got > 0).sum()) < int((lab > 0).sum())


def test_window_size_filter_refuses_beyond_its_limit(cuda):
    with pytest.raises(ValueError):
        cc_cuda.remove_small_objects_cuda(torch.ones((1, 8, 8), dtype=torch.int32, device=cuda),
                                          cc_cuda.RM_SMALL_MAX_MIN_SIZE + 1)


# B11: one cluster launch a call, its histogram and lookup entries; 1, 9 and
# 17 images (17 clusters of 8 blocks: more than the card holds at once), H·W
# no multiple of 4 (the scalar route), clipped and overflow ids
@pytest.mark.parametrize("b,h,w", [(1, 1, 1), (1, 100, 150), (9, 77, 33), (17, 256, 256), (9, 1024, 1024)])
@pytest.mark.parametrize("min_size,bins", [(2, (64, 128)), (10, (64, 128)), (10, (4, 8)), (64, (64, 128))])
def test_radix_size_filter_kernel_shapes(cuda, b, h, w, min_size, bins):
    lab = torch.from_numpy(_size_filter_labels(100 + min_size, b, h, w, max_id=9000)).to(cuda)
    nb = bins[0] * bins[1]
    counts = dict(_build.LAUNCHES)
    got = cc_cuda.remove_small_objects_bincount_cuda(lab, min_size, *bins)
    hist = cc_cuda.radix_histogram_cuda(lab, *bins)
    kept = cc_cuda.radix_keep_cuda(lab, hist, min_size)
    torch.cuda.synchronize()
    assert {k: v - counts[k] for k, v in _build.LAUNCHES.items() if v != counts[k]} == {
        "radix_filter": 1, "radix_hist": 1, "rm_mapback": 1}
    want_hist = cc.radix_histogram(lab, *bins)
    assert torch.equal(hist, want_hist)
    assert torch.equal(kept, cc.radix_keep(lab, want_hist, min_size))
    assert torch.equal(got, cc.remove_small_objects_bincount(lab, min_size, nb, bins[0]))
    n = min(3, lab.numel())
    assert got.reshape(-1)[:n].tolist() == [0, 8192, 2**30][:n]  # ≤ 0 dropped, overflow ids kept


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


def _flood_inputs(cuda, seed, b, h, w, negative=False):
    """Discs over a (B, H, W) relief, one marker pixel a disc (ids 1…), as
    many discs as the area holds about 1 in 400 pixels; with `negative`, a
    band of negative labels across every image."""
    rng = np.random.default_rng(seed)
    img = np.zeros((b, h, w), np.float32)
    mask = np.zeros((b, h, w), bool)
    mark = np.zeros((b, h, w), np.int32)
    n = max(1, h * w // 400)
    for i in range(b):
        cy, cx = rng.integers(0, h, n), rng.integers(0, w, n)
        r = rng.integers(2, 14, n)
        for k in range(n):
            y0, y1, x0, x1 = max(cy[k] - r[k], 0), min(cy[k] + r[k] + 1, h), max(cx[k] - r[k], 0), min(cx[k] + r[k] + 1, w)
            yy, xx = np.mgrid[y0:y1, x0:x1]
            d2 = (yy - cy[k]) ** 2 + (xx - cx[k]) ** 2
            disc = d2 <= r[k] ** 2
            mask[i, y0:y1, x0:x1] |= disc
            img[i, y0:y1, x0:x1] = np.minimum(img[i, y0:y1, x0:x1], np.where(disc, -np.exp(-d2 / r[k] ** 2), 0))
            mark[i, cy[k], cx[k]] = k + 1
    if negative:
        mark[:, h // 3:h // 3 + 3, :] = -2
    return tuple(torch.from_numpy(a).to(cuda) for a in (img, mark * mask, mask))


_WS_CROWDED = ((9, 1024, 1024), (4, 2048, 2048), (2, 2048, 2048), (150, 40, 40))


@pytest.mark.parametrize("shape,kw,negative", [
    ((1, 1, 1), {}, False),
    ((3, 77, 33), {}, False),
    ((2, 100, 1030), {}, False),
    ((1, 2048, 2048), {}, False),
    ((2, 300, 200), dict(levels=1, inner_iters=2), False),
    ((2, 300, 200), dict(levels=256), False),
    ((2, 300, 200), dict(levels=300, inner_iters=1), False),
    ((2, 300, 200), dict(max_final_iters=1), False),
    ((2, 300, 200), {}, True),
    ((9, 256, 256), dict(levels=8, inner_iters=1, max_final_iters=40), True),
    ((9, 1024, 1024), {}, False),
    ((4, 2048, 2048), dict(levels=8, inner_iters=1), True),
    ((2, 2048, 2048), dict(levels=300, inner_iters=1), False),
    ((150, 40, 40), dict(max_final_iters=13), True),
])
def test_watershed_kernel_shapes_match_plain(cuda, shape, kw, negative):
    """B9, one launch a call, pixel-equal with equal pass counts to the plain
    sweep on the card: a single pixel, odd shapes, width 1030, 2048², one
    and 256 levels (byte heights) and 300 (16-bit heights), a cap of one
    pass, negative markers, and more images than one group of tiles. The
    last four have more tiles than the card holds blocks (one an SM), so
    blocks run several tiles of an image in turn, restaging each phase
    ((9, 1024²), (4, 2048²), (2, 2048²) with 128-row tiles), or a group
    runs several images in turn ((150, 40²))."""
    from cellvit_tpu_torch.ops.watershed import watershed

    b, h, w = shape
    if shape in _WS_CROWDED:  # the premise of these cases
        th = 128 if kw.get("levels", 64) > 256 else 256
        tiles = b * -(-h // th) * -(-w // 256)
        assert tiles > torch.cuda.get_device_properties(cuda).multi_processor_count, tiles

    img, mark, mask = _flood_inputs(cuda, sum(shape), *shape, negative=negative)
    if shape == (1, 1, 1):
        mask[:] = True
        mark[:] = 5
    before = _build.LAUNCHES["watershed"]
    got, passes = cc_cuda.watershed_cuda(img, mark, mask, return_passes=True, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["watershed"] == before + 1
    args = dict(levels=kw.get("levels", 64), inner_iters=kw.get("inner_iters", 4),
                max_final_iters=kw.get("max_final_iters", 512))
    want, want_passes = watershed(img, mark, mask, schedule="sweep", return_passes=True, **args)
    assert torch.equal(got, want)
    assert torch.equal(passes, want_passes)
    if negative:
        assert torch.equal(got[mark < 0], mark[mark < 0])


def test_watershed_kernel_refuses_more_than_16_bit_levels(cuda):
    img, mark, mask = _flood_inputs(cuda, 1, 1, 32, 32)
    with pytest.raises(ValueError, match="65535"):
        cc_cuda.watershed_cuda(img, mark, mask, levels=65536)


@pytest.mark.parametrize("h,w", [(12, 100), (12, 1030), (12, 1024), (6, 16), (10, 200), (6, 1000),
                                 (10, 16)])
@pytest.mark.parametrize("f", [1, 64, 65, 192])
@pytest.mark.parametrize("c", [3, 64, 72, 192])
def test_conv3x3_bf16_kernel_shapes_match_plain(cuda, c, f, h, w):
    """B12 in bf16 within `CONV_BF16_L2` of its plain version with each block
    of a 3·F-channel residual and without one: input channels past one
    64-channel chunk and not a multiple of 16, output channels past one
    64-channel tile, widths that TMA takes (1024; 16, 200 and 1000, whose
    last 64-pixel tile runs past the image, so the loads are zero-filled and
    the stores clipped there) and that it does not (100, 1030: rows not
    16-byte aligned), and heights that are not a multiple of the kernel's
    4-row item (6, 10; the op's `rows`, the JAX kernel's contract H % rows
    == 0, is then 2: the CUDA tiling does not depend on it)."""
    g = torch.Generator(device=cuda).manual_seed(c * f + h * w)
    x = torch.randn((2, c, h, w), generator=g, device=cuda).to(torch.bfloat16)
    wt = (torch.randn((3, 3, c, f), generator=g, device=cuda) * c**-0.5).to(torch.bfloat16)
    b = torch.randn(f, generator=g, device=cuda)
    res = torch.randn((2, 3 * f, h, w), generator=g, device=cuda).to(torch.bfloat16)
    for block in (None, 0, 1, 2):
        kw = {} if block is None else dict(res=res, res_block=block)
        before = _build.LAUNCHES["conv3x3_cm"]
        got = conv_cm.conv3x3_cm(x, wt, b, rows=4 if h % 4 == 0 else 2, relu=block != 1, **kw)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["conv3x3_cm"] == before + 1
        want = conv_cm.conv3x3_cm_reference(x, wt, b, relu=block != 1, **kw)
        rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
        assert got.shape == want.shape and rel <= conv_cm.CONV_BF16_L2, (block, rel)
