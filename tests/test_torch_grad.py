"""Backward of the port's differentiable attention ops against `jax.grad` of
the JAX package's Pallas kernels in interpret mode, and the bounds that hold
the CUDA flash backward (B8a/B8b) to its plain version against planted
faults of its algorithm.

Tolerances: the flash backward within 3e-5 in fp32 (the JAX package's own
test of its VJP, `tests/test_attention.py`); the rel-pos VJP within 5e-5;
the B5 VJP within 5e-5 absolute and 1e-4 relative (its gradients sum over
the whole window projection).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellvit_tpu.ops import attention as jax_attention
from cellvit_tpu_torch import _build
from cellvit_tpu_torch.ops import attention

# one intra-op thread each: the suite runs as parallel pytest workers
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _torch_grads(fn, inputs, cot):
    leaves = [_t(a).requires_grad_() for a in inputs]
    return [g.numpy() for g in torch.autograd.grad(fn(*leaves), leaves, _t(cot))]


def _jax_grads(fn, inputs, cot):
    loss = lambda *a: jnp.vdot(fn(*a), jnp.asarray(cot))
    return [np.asarray(g) for g in
            jax.grad(loss, tuple(range(len(inputs))))(*(jnp.asarray(a) for a in inputs))]


@pytest.mark.parametrize("b,n,h,dqk,dv", [(1, 37, 2, 16, 16), (2, 130, 2, 32, 32),
                                          (1, 70, 2, 48, 32)])
def test_flash_grads_match_pallas_interpret(rng, b, n, h, dqk, dv):
    """The autograd op (B1 forward, B8 backward; their plain versions on the
    CPU) and `flash_attention_bwd_plain` against `jax.grad` of the Pallas
    flash attention, whose VJP runs the Pallas B8a/B8b. q/k may be wider
    than v."""
    q, k = (rng.standard_normal((b, n, h, dqk)).astype(np.float32) for _ in range(2))
    v, cot = (rng.standard_normal((b, n, h, dv)).astype(np.float32) for _ in range(2))
    want = _jax_grads(lambda q, k, v: jax_attention.flash_attention(
        q, k, v, block_q=64, block_k=64, interpret=True), (q, k, v), cot)
    got = _torch_grads(attention.flash_attention, (q, k, v), cot)
    o, lse = attention.flash_attention_plain(_t(q), _t(k), _t(v))
    twin = attention.flash_attention_bwd_plain(_t(q), _t(k), _t(v), o, lse, _t(cot), dqk**-0.5)
    for name, a, c, w in zip(("dq", "dk", "dv"), got, twin, want):
        assert a.shape == w.shape, name
        np.testing.assert_allclose(a, w, atol=3e-5, err_msg=name)
        np.testing.assert_allclose(c.numpy(), w, atol=3e-5, err_msg=name)


@pytest.mark.parametrize("grid_hw", [(32, 32), (16, 16), (16, 20)])
def test_relpos_grads_match_pallas_interpret(rng, grid_hw):
    """Gradients in q, k, v and both gathered tables: the direct-bias route
    (32×32; its VJP runs the flash backward on the lane-augmented q′/k′), the
    whole-window route (16×16) and the ragged fallback (16×20)."""
    gh, gw = grid_hw
    n, d = gh * gw, 32
    q, k = ((rng.standard_normal((1, n, 2, d)) * 0.5).astype(np.float32) for _ in range(2))
    v, cot = (rng.standard_normal((1, n, 2, d)).astype(np.float32) for _ in range(2))
    rh = (rng.standard_normal((gh, gh, d)) * 0.3).astype(np.float32)
    rw = (rng.standard_normal((gw, gw, d)) * 0.3).astype(np.float32)
    inputs = (q, k, v, rh, rw)
    want = _jax_grads(lambda *a: jax_attention.flash_attention_relpos(
        *a, grid_hw=grid_hw, interpret=True), inputs, cot)
    got = _torch_grads(lambda *a: attention.flash_attention_relpos(*a, grid_hw), inputs, cot)
    for name, a, w in zip(("q", "k", "v", "rel_pos_h", "rel_pos_w"), got, want):
        np.testing.assert_allclose(a, w, atol=5e-5, err_msg=name)


def test_window_qkv_grads_match_pallas_interpret(rng):
    """B5's VJP (a recompute through its plain version) against `jax.grad`
    through the Pallas window qkv attention (the VJP of `_win_qkv_ref`), in
    x, the projection and the tables."""
    c, nh, side = 64, 2, 6
    n, hd = side * side, c // nh
    x = (rng.standard_normal((3, n, c)) * 0.4).astype(np.float32)
    x[-1, n // 2:] = 0.0  # the zero-padded tokens of an edge window
    w = (rng.standard_normal((c, 3 * c)) * c**-0.5).astype(np.float32)
    b = (rng.standard_normal(3 * c) * 0.1).astype(np.float32)
    rh, rw = ((rng.standard_normal((side, side, hd)) * 0.2).astype(np.float32) for _ in range(2))
    cot = rng.standard_normal((3, n, c)).astype(np.float32)
    inputs = (x, w, b, rh, rw)
    want = _jax_grads(lambda *a: jax_attention.window_qkv_attention(*a, nh, interpret=True),
                      inputs, cot)
    got = _torch_grads(lambda *a: attention.window_qkv_attention(*a, nh), inputs, cot)
    for name, a, g in zip(("x", "w", "b", "rel_pos_h", "rel_pos_w"), got, want):
        np.testing.assert_allclose(a, g, atol=5e-5, rtol=1e-4, err_msg=name)


def test_window_attention_grads_match_pallas_interpret(rng):
    """B7's VJP (a recompute through its plain version) against `jax.grad`
    through the Pallas whole-window attention, q/k wider than v."""
    q, k = ((rng.standard_normal((2, 50, 2, 24)) * 0.4).astype(np.float32) for _ in range(2))
    v, cot = (rng.standard_normal((2, 50, 2, 16)).astype(np.float32) for _ in range(2))
    want = _jax_grads(lambda *a: jax_attention.window_attention(*a, window_block=2, interpret=True),
                      (q, k, v), cot)
    got = _torch_grads(attention.window_attention, (q, k, v), cot)
    for name, a, w in zip(("q", "k", "v"), got, want):
        np.testing.assert_allclose(a, w, atol=3e-5, err_msg=name)


def test_cpu_backward_launches_nothing(rng):
    q = _t(rng.standard_normal((1, 40, 2, 64))).requires_grad_()
    before = dict(_build.LAUNCHES)
    attention.flash_attention(q, q, q).sum().backward()
    assert _build.LAUNCHES == before and q.grad.shape == q.shape


# ------------------------------------------ B8 bounds against planted faults


def _bf(t):
    return t.to(torch.bfloat16).float()


def _replay_bwd(q, k, v, o, lse, do, scale, fault, extra):
    """B8a/B8b's arithmetic on the CPU: p recomputed from lse in fp32, dp
    from bf16 do and v, ds = p∘(dp − Δ)·scale; p and ds rounded to bf16
    before their products, the gradients at the end. `fault` plants one of
    the bugs FLASH_BWD_BOUNDS must catch; `extra` holds the rows a kernel
    without its bound checks would read past N (the next rows in memory)."""
    qf, kf, vf, dof, of = (t.float() for t in (q, k, v, do, o))
    delta = (dof * of).sum(-1).transpose(1, 2)
    kq, vq = kf, vf
    if fault == "unmasked_key":
        kq, vq = torch.cat([kf, extra["k"]], 1), torch.cat([vf, extra["v"]], 1)
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kq) * scale - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, of if fault == "dp_from_o" else vq)
    ds = p * (dp - (0.0 if fault == "no_delta" else delta[..., None])) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", _bf(ds), kq)
    ds_k = ds / scale if fault == "dk_unscaled" else ds
    qk, dok, pk = qf, dof, p
    if fault == "query_past_n":
        sg = torch.einsum("bqhd,bkhd->bhqk", extra["q"], kq) * scale
        pg = torch.exp(sg - extra["lse"][..., None])
        dpg = torch.einsum("bqhd,bkhd->bhqk", extra["do"], vq)
        ds_k = torch.cat([ds_k, pg * (dpg - extra["delta"][..., None]) * scale], 2)
        pk = torch.cat([p, pg], 2)
        qk, dok = torch.cat([qf, extra["q"]], 1), torch.cat([dof, extra["do"]], 1)
    n = k.shape[1]
    dk = torch.einsum("bhqk,bqhd->bkhd", _bf(ds_k), qk)[:, :n]
    dv = torch.einsum("bhqk,bqhd->bkhd", _bf(pk), dok)[:, :n]
    return _bf(dq), _bf(dk), _bf(dv)


def _bwd_case(b, n, h, dqk, dv, scale, seed):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    q, k = _bf(r(b, n, h, dqk)), _bf(r(b, n, h, dqk))
    v, do = _bf(r(b, n, h, dv)), _bf(r(b, n, h, dv) * 0.02)
    o, lse = attention.flash_attention_plain(q, k, v, scale)
    o = _bf(o)
    pad = -n % 64
    extra = dict(k=_bf(r(b, pad, h, dqk)), v=_bf(r(b, pad, h, dv)), q=_bf(r(b, pad, h, dqk)),
                 do=_bf(r(b, pad, h, dv) * 0.02), lse=lse[:, :, :pad].clone(),
                 delta=r(b, h, pad) * 1e-3)
    return (q, k, v, o, lse, do, scale), extra


@pytest.mark.parametrize("case,fault", [
    ("vit", "none"), ("wide", "none"), ("vit", "no_delta"), ("vit", "dk_unscaled"),
    ("vit", "unmasked_key"), ("vit", "query_past_n"), ("vit", "dp_from_o"),
])
def test_flash_bwd_bounds_separate_rounding_from_kernel_faults(case, fault):
    """At (1, 1025, 2, 64) with the ViT scale, and with q′/k′ 120 wide against
    v 80 at scale 1 (a ragged rel-pos grid), B8's bf16 roundings stay within
    FLASH_BWD_BOUNDS of the fp32 plain backward; each planted fault (Δ not
    subtracted, dk's scale dropped, a key past N left unmasked, a query past
    N counted in dk/dv, dp taken from o instead of v) does not."""
    if case == "vit":
        args, extra = _bwd_case(1, 1025, 2, 64, 64, 64**-0.5, 0)
    else:
        args, extra = _bwd_case(1, 400, 2, 120, 80, 1.0, 1)
    got = _replay_bwd(*args, fault, extra)
    ref = attention.flash_attention_bwd_plain(*args)
    errs = attention.flash_bwd_errors(got, ref)
    assert attention.within_bwd(errs) == (fault == "none"), errs
