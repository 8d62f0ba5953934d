"""Port's SAM encoder slice against the JAX package on the same inputs: the
plain versions of the SAM attention kernels (B5 window qkv attention, also as
the plain twins of its three kernels, B6 direct-bias flash attention, B7
whole-window attention) against the Pallas kernels in interpret mode, the
tiny CellViT-SAM on each kernel's route, the weight bridge and checkpoint
loading, and the bounds that hold the CUDA kernels to their plain versions
against planted faults.

Tolerances: the plain kernels within 3e-5 in fp32; the models within 2e-4
(docs/PARITY.md)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellvit_tpu.models import CellViT as JaxCellViT
from cellvit_tpu.models.checkpoint_io import convert_state_dict, export_torch_state_dict
from cellvit_tpu.models.fused import fused_forward_maps
from cellvit_tpu.models.layers import resize_matrix_1d as jax_resize
from cellvit_tpu.models.sam_vit import gather_rel_pos as jax_gather_rel_pos
from cellvit_tpu.ops import attention as jax_attention
from cellvit_tpu.ops.hv_postproc import instance_map_batch_maps as jax_instance_maps
from cellvit_tpu.ops.instance_stats import instance_stats_batch as jax_stats
from cellvit_tpu.ops.instance_stats import relabel_consecutive as jax_relabel
from cellvit_tpu_torch import _build
from cellvit_tpu_torch.inference.cell_detection import CellSegmentationInference
from cellvit_tpu_torch.models import cellvit as torch_cellvit
from cellvit_tpu_torch.models import sam_vit
from cellvit_tpu_torch.models.cellvit import CellViT
from cellvit_tpu_torch.models.checkpoint_io import (
    load_checkpoint,
    load_state_dict_into,
    state_dict_from_flax,
)
from cellvit_tpu_torch.models.fused import forward_maps
from cellvit_tpu_torch.models.layers import resize_matrix_1d
from cellvit_tpu_torch.ops import attention
from cellvit_tpu_torch.synthetic import set_probe_weights
from test_torch_models import _random_variables

# one intra-op thread each: the suite runs as parallel pytest workers
torch.set_num_threads(1)

# global blocks 1 and 3 take the B6/B7 routes; the windowed blocks 0 and 2 take B5
KW = dict(num_nuclei_classes=6, num_tissue_classes=19, embed_dim=64, depth=4, num_heads=2,
          extract_layers=(1, 2, 3, 4), encoder_type="sam", global_attn_indexes=(1, 3),
          window_size=14)
SIZES = ((512, 512), (224, 256), (128, 128))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ------------------------------------------------ plain kernels vs Pallas


def _win_qkv_inputs(rng, c, nh, side, with_bias, nw=5):
    n, hd = side * side, c // nh
    x = (rng.standard_normal((nw, n, c)) * 0.4).astype(np.float32)
    x[-1, n // 2:] = 0.0  # the zero-padded tokens of an edge window
    w = (rng.standard_normal((c, 3 * c)) * c**-0.5).astype(np.float32)
    b = (rng.standard_normal(3 * c) * 0.1).astype(np.float32) if with_bias else None
    rh, rw = ((rng.standard_normal((side, side, hd)) * 0.2).astype(np.float32) for _ in range(2))
    return x, w, b, rh, rw


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("c,nh,side", [(128, 4, 14), (160, 2, 14), (64, 2, 4)])
def test_window_qkv_plain_matches_pallas(rng, c, nh, side, with_bias):
    x, w, b, rh, rw = _win_qkv_inputs(rng, c, nh, side, with_bias)
    jb = None if b is None else jnp.asarray(b)
    want = jax_attention.window_qkv_attention(jnp.asarray(x), jnp.asarray(w), jb, jnp.asarray(rh),
                                              jnp.asarray(rw), nh, interpret=True)
    oracle = jax_attention._win_qkv_ref(jnp.asarray(x), jnp.asarray(w), jb, jnp.asarray(rh),
                                        jnp.asarray(rw), nh)
    got = attention.window_qkv_attention(_t(x), _t(w), None if b is None else _t(b), _t(rh),
                                         _t(rw), nh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=3e-5)


def _win_qkv_twins(x, w, b, rh, rw, nh):
    """B5 as the plain twins of its three kernels: the projection, the bias
    terms, then the rel-pos attention on q, k and v read from the qkv rows."""
    nw, n, c = x.shape
    qkv = attention.win_qkv_proj_plain(x.reshape(nw * n, c), w, b).reshape(nw, n, 3, nh, c // nh)
    q, k, v = qkv.unbind(2)
    bh, bw = attention.win_qkv_terms_plain(q, rh, rw)
    return attention.relpos_attention_plain(q, k, v, bh, bw).reshape(nw, n, c)


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("c,nh,side", [(128, 4, 14), (160, 2, 16)])
def test_window_qkv_twins_compose_to_the_plain_op(rng, c, nh, side, with_bias):
    """In fp32 the three twins compose to `window_qkv_attention_plain`: the
    same products summed in other orders, within 2e-5 at |o| ≤ 2."""
    x, w, b, rh, rw = (None if a is None else _t(a) for a in _win_qkv_inputs(rng, c, nh, side, with_bias))
    got = _win_qkv_twins(x, w, b, rh, rw, nh)
    want = attention.window_qkv_attention_plain(x, w, b, rh, rw, nh)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


@pytest.mark.parametrize("with_bias", [True, False])
def test_window_qkv_twins_in_bf16_match_pallas(rng, with_bias):
    """On bf16 inputs the twins round qkv and Bh/Bw to bf16, as the kernels
    do; the Pallas kernel (interpret mode) rounds its own way (k and v, q·scale
    and the bias terms, the softmax's exponent argument). The two agree within
    `WIN_QKV_BOUNDS`, relative to the fp32 oracle's |o|."""
    x, w, b, rh, rw = _win_qkv_inputs(rng, 320, 4, 14, with_bias)
    bf = lambda a: None if a is None else jnp.asarray(a, jnp.bfloat16)
    want = jax_attention._win_qkv_fwd_only(bf(x), bf(w), bf(b), bf(rh), bf(rw), 4, None, True)
    tb = lambda a: None if a is None else _t(a).to(torch.bfloat16)
    got = _win_qkv_twins(tb(x), tb(w), tb(b), tb(rh), tb(rw), 4)
    oracle = attention.window_qkv_attention_plain(
        *(None if a is None else _t(a) for a in (x, w, b, rh, rw)), 4)
    errs = attention.attn_errors(got.float() - _t(np.asarray(want, np.float32)) + oracle, oracle)
    assert attention.within(errs, attention.WIN_QKV_BOUNDS), errs


@pytest.mark.parametrize("gh,gw,bq", [(32, 32, 128), (16, 32, 64)])
def test_relpos_flash_plain_matches_pallas(rng, gh, gw, bq):
    b, h, d, n = 1, 2, 32, gh * gw
    q, k = ((rng.standard_normal((b, n, h, d)) * 0.5).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((b, n, h, d)).astype(np.float32)
    rh = np.asarray(jax_gather_rel_pos(jnp.asarray(rng.standard_normal((2 * gh - 1, d)) * 0.3,
                                                   jnp.float32), gh))
    rw = np.asarray(jax_gather_rel_pos(jnp.asarray(rng.standard_normal((2 * gw - 1, d)) * 0.3,
                                                   jnp.float32), gw))
    want = jax_attention.flash_attention_relpos(
        *(jnp.asarray(a) for a in (q, k, v, rh, rw)), grid_hw=(gh, gw), block_q=bq,
        interpret=True)
    assert attention.direct_bias_fits((gh, gw))
    tq = _t(q)
    bh, bw = attention.rel_pos_bias(tq, _t(rh), _t(rw), (gh, gw))
    got = attention.relpos_flash_attention(tq, _t(k), _t(v), bh, bw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)
    routed = attention.flash_attention_relpos(tq, _t(k), _t(v), _t(rh), _t(rw), (gh, gw))
    assert torch.equal(routed, got)


def test_ragged_grid_fallback_matches_pallas(rng):
    """A 16×20 grid fits neither B7 (N > 256) nor B6: the augmented-lane
    flash fallback, whose plain version runs on the CPU."""
    gh, gw, d = 16, 20, 32
    q, k, v = (rng.standard_normal((1, gh * gw, 2, d)).astype(np.float32) for _ in range(3))
    rh, rw = ((rng.standard_normal((s, s, d)) * 0.3).astype(np.float32) for s in (gh, gw))
    want = jax_attention.flash_attention_relpos(
        *(jnp.asarray(a) for a in (q, k, v, rh, rw)), grid_hw=(gh, gw), block_q=32,
        interpret=True)
    assert not attention.direct_bias_fits((gh, gw))
    got = attention.flash_attention_relpos(*(_t(a) for a in (q, k, v, rh, rw)), (gh, gw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


@pytest.mark.parametrize("b,n,h,d,dv", [(5, 196, 2, 32, 24), (3, 64, 1, 16, 16)])
def test_window_attention_plain_matches_pallas(rng, b, n, h, d, dv):
    q, k = ((rng.standard_normal((b, n, h, d)) * 0.3).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((b, n, h, dv)).astype(np.float32)
    want = jax_attention.window_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          window_block=2, interpret=True)
    got = attention.window_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


@pytest.mark.parametrize("n_in,n_out", [(127, 27), (127, 31), (127, 63), (27, 27)])
def test_linear_resize_and_gather_match_jax(rng, n_in, n_out):
    scale = n_out / n_in
    np.testing.assert_array_equal(resize_matrix_1d(n_in, n_out, scale, "linear").numpy(),
                                  np.asarray(jax_resize(n_in, n_out, scale, "linear")))
    table = rng.standard_normal((n_in, 8)).astype(np.float32)
    side = (n_out + 1) // 2
    np.testing.assert_allclose(sam_vit.gather_rel_pos(_t(table), side).numpy(),
                               np.asarray(jax_gather_rel_pos(jnp.asarray(table), side)), atol=1e-6)


# ------------------------------------------------------- the tiny model


@pytest.fixture(scope="module")
def pair():
    """The tiny JAX CellViT-SAM with distinct seeded weights (rel-pos tables
    at std 0.3, so the bias moves the logits) and the port's model carrying
    the same weights."""
    jm = JaxCellViT(**KW)
    variables = _random_variables(jm, (1, 64, 64, 3), 2, train=False)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, a: a * 15.0 if p[-1].key.startswith("rel_pos") else a, variables)
    tm = CellViT(**KW).eval()
    load_state_dict_into(tm, state_dict_from_flax(variables["params"], variables["batch_stats"]))
    return jm, variables, tm


def test_bridge_equals_export(pair):
    _, variables, tm = pair
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"])
    ref = export_torch_state_dict(variables, sam_encoder=True)
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)
    model_keys = {k for k in tm.state_dict() if not k.endswith("num_batches_tracked")}
    assert model_keys == set(ref)
    assert "encoder.blocks.0.mlp.lin1.weight" in ref and "encoder.neck.3.bias" in ref


def _spy_routes(monkeypatch):
    """Record which SAM kernel route each attention call takes."""
    calls = []
    for mod, name in ((sam_vit, "window_qkv_attention"), (attention, "relpos_flash_attention"),
                      (attention, "window_attention")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append((_name, tuple(a[0].shape)))
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    return calls


@pytest.mark.parametrize("size", SIZES)
def test_encoder_routes_match_jax(pair, monkeypatch, size):
    """512²: 9 padded 14×14 windows (B5) and a 32×32 global grid (B6);
    224×256: 2 windows (B5) and a 14×16 global grid (B7), its rel-pos tables
    resized 127 → 27 and 127 → 31; 128²: 1 window (B5) and an 8×8 global
    grid on the einsum path."""
    jm, variables, tm = pair
    calls = _spy_routes(monkeypatch)
    x = np.random.default_rng(size[1]).uniform(-1, 1, (1, *size, 3)).astype(np.float32)
    want_pooled, want_map, want_skips = jm.apply(variables, jnp.asarray(x),
                                                 method=lambda m, x: m.encoder(x))
    with torch.no_grad():
        pooled, neck, skips = tm.encoder(torch.from_numpy(x).permute(0, 3, 1, 2))
    if size == (512, 512):
        assert calls == [("window_qkv_attention", (9, 196, 64)),
                         ("relpos_flash_attention", (1, 1024, 2, 32))] * 2
    elif size == (224, 256):
        assert calls == [("window_qkv_attention", (2, 196, 64)),
                         ("window_attention", (1, 224, 2, 32 + 14 + 16))] * 2
    else:
        assert calls == [("window_qkv_attention", (1, 196, 64))] * 2
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled), atol=2e-4)
    np.testing.assert_allclose(neck.permute(0, 2, 3, 1).numpy(), np.asarray(want_map), atol=2e-4)
    for a, b in zip(skips, want_skips):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4)


def test_forward_matches_jax(pair):
    jm, variables, tm = pair
    x = np.random.default_rng(1).uniform(-1, 1, (1, 224, 256, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False, retrieve_tokens=True))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), retrieve_tokens=True)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=2e-4, err_msg=k)
    assert got["tokens"].shape == (1, 14, 16, 64)


def test_forward_maps_matches_jax(pair):
    jm, variables, tm = pair
    x = np.random.default_rng(2).uniform(-1, 1, (1, 224, 256, 3)).astype(np.float32)
    want = fused_forward_maps(jm, variables, jnp.asarray(x), retrieve_tokens=True)
    got = forward_maps(tm, torch.from_numpy(x), retrieve_tokens=True)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=2e-4, err_msg=k)


def test_device_outputs_match_jax():
    """The device stage of a probe-weighted tiny CellViT-SAM: instance maps,
    statistics and tokens equal the JAX composition of the same stage."""
    torch.manual_seed(0)
    model = CellViT(**KW)
    set_probe_weights(model)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jm, variables = JaxCellViT(**KW), convert_state_dict(sd, True)
    rng = np.random.default_rng(7)
    imgs = np.full((1, 224, 256, 3), 0.75, np.float32)
    yy, xx = np.mgrid[0:224, 0:256]
    for _ in range(25):
        cy, cx, r = rng.integers(10, 214), rng.integers(10, 246), rng.integers(4, 9)
        imgs[0][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = rng.uniform(0.1, 0.4)
    infer = CellSegmentationInference(model=model, run_conf={}, max_instances_per_tile=256,
                                      device="cpu")
    inst, stats, tokens = infer._device_outputs(imgs, 40)

    out = fused_forward_maps(jm, variables, jnp.asarray((imgs - 0.5) / 0.5), retrieve_tokens=True)
    want_inst = jax_instance_maps(out["np_prob"], out["hv0"], out["hv1"], use_pallas=False)
    want_inst = jax.vmap(lambda m: jax_relabel(m, 224 * 256 // 2 + 2))(want_inst)
    type_map = jnp.argmax(out["type_map_cmajor"], 1).astype(jnp.int32)
    want = jax_stats(want_inst, type_map, out["np_prob"], max_instances=256, num_classes=6)
    np.testing.assert_array_equal(inst, np.asarray(want_inst))
    np.testing.assert_allclose(tokens, np.asarray(out["tokens"]), atol=2e-4)
    for key in ("valid", "area", "bbox", "type"):
        np.testing.assert_array_equal(stats[key], np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(stats["centroid"], np.asarray(want["centroid"]), rtol=1e-5, atol=1e-6)
    assert tokens.shape == (1, 14, 16, 64) and stats["valid"].sum() >= 5


def test_load_checkpoint_reads_cellvitsam(pair, tmp_path, monkeypatch):
    """A reference-format `CellViTSAM` checkpoint: the config names the
    backbone (a SAM-B entry cut to the tiny model's size here)."""
    _, variables, tm = pair
    tiny = {k: KW[k] for k in ("embed_dim", "depth", "num_heads", "global_attn_indexes",
                               "extract_layers")}
    monkeypatch.setitem(torch_cellvit.SAM_CONFIGS, "SAM-B", tiny)
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"])
    config = {"data.num_nuclei_classes": 6, "data.num_tissue_classes": 19,
              "model.backbone": "SAM-B"}
    path = tmp_path / "model.pth"
    torch.save({"arch": "CellViTSAM", "model_state_dict": sd, "config": config}, path)
    model, _, run_conf = load_checkpoint(path)
    assert run_conf["model"]["backbone"] == "SAM-B" and model.encoder_type == "sam"
    for k, v in tm.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


# -------------------------------------- kernel bounds against planted faults


def _bf(t):
    return t.to(torch.bfloat16).float()


def _softmax_bf16_p(logits, v, valid=None):
    """The kernels' softmax·v: fp32 logits and row sum, p rounded to bf16
    before the product, o rounded to bf16."""
    if valid is not None:
        logits = logits.masked_fill(~valid, -np.inf)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    return (_bf(p) @ v) / p.sum(-1, keepdim=True)


def _emulated_win_qkv_sm90(x, w, b, rh, rw, nh, fault, tile=128):
    """B5's arithmetic as its three Hopper kernels play it. The projection:
    fp32 products plus the fp32 bias, rounded once to bf16 into (NW·N, 3C)
    rows read back as q, k and v by strides. The bias terms: Bh and Bw from
    the bf16 unscaled q, fp32 products times log2(e), rounded to bf16. The
    attention: q rescaled to bf16(q·scale·log2 e); per 128-key tile S = q·kᵀ
    plus [Bh | Bw] times the one-hot of each key's grid row and column (keys
    past N: zero k, v and one-hot, then masked); a running max and sum in
    base 2, p rounded to bf16 before P·V, o rounded at the end. The faults:
    the epilogue's head offset one head off, k and v swapped in the strided
    views, the ragged tile's keys past N left unmasked, Bh's grid row taken
    per 8-key group (wrong where the side does not divide the group's
    keys), the bias from the scaled q, and the zero-padded window tokens
    masked as keys."""
    nw, n, c = x.shape
    hd, side = c // nh, rh.shape[0]
    log2e = 1.4426950408889634
    qkv = _bf(x.float() @ w.float() + b.float()).reshape(nw, n, 3, nh, hd)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))  # (NW, H, N, D)
    if fault == "k_v_swapped":
        k, v = v, k
    qb = _bf(q * hd**-0.5) if fault == "bias_from_scaled_q" else q
    t = torch.arange(n)
    bh = _bf(torch.einsum("whtd,trd->whtr", qb, rh.float()[t // side]) * log2e)
    bw = _bf(torch.einsum("whtd,tcd->whtc", qb, rw.float()[t % side]) * log2e)
    qs = _bf(q * (hd**-0.5 * log2e))
    n_kt = -(-n // tile)
    kp, vp = (torch.nn.functional.pad(a, (0, 0, 0, n_kt * tile - n)) for a in (k, v))
    pad_key = (x.abs().sum(-1) == 0)[:, None, None, :]  # (NW, 1, 1, N)
    m = torch.full((nw, nh, n, 1), -np.inf)
    l, acc = torch.zeros((nw, nh, n, 1)), torch.zeros((nw, nh, n, hd))
    for k0 in range(0, n_kt * tile, tile):
        key = k0 + torch.arange(tile)
        valid = key < n
        row = key // side
        if fault == "bh_row_per_8_keys":
            row = (k0 + 8 * (torch.arange(tile) // 8)) // side
        row, col = row.clamp(max=side - 1), (key % side)
        bias = (bh[..., row] + bw[..., col]) * valid  # the one-hot rows past N are zero
        s = qs @ kp[..., k0:k0 + tile, :].transpose(-1, -2) + bias
        if fault != "ragged_unmasked":
            s = s.masked_fill(~valid, -np.inf)
        if fault == "masked_padding":
            s = s.masked_fill(torch.nn.functional.pad(pad_key, (0, n_kt * tile - n))[..., k0:k0 + tile],
                              -np.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha, p = torch.exp2(m - m_new), torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _bf(p) @ vp[..., k0:k0 + tile, :]
        m = m_new
    o = _bf(acc / l)
    if fault == "head_offset_one_head":
        o = o.roll(1, dims=1)
    return o.transpose(1, 2).reshape(nw, n, c)


def _emulated_relpos(q, k, v, bh, bw, fault):
    """B6's arithmetic: bf16 q/k/v and Bh/Bw, fp32 logits, p and o rounded."""
    b, n, h, d = q.shape
    gh, gw = bh.shape[-1], bw.shape[-1]
    key = torch.arange(n)
    row, col = key // gw, key % gw
    if fault == "index_off_by_one":
        col = (col + 1) % gw
    if fault == "swapped_bh_bw":
        bh, bw = bw, bh
    qh, kh, vh = (t.float().transpose(1, 2) for t in (q, k, v))
    bias = bh.float().transpose(1, 2)[..., row] + bw.float().transpose(1, 2)[..., col]
    o = _softmax_bf16_p(qh @ kh.transpose(-1, -2) * d**-0.5 + bias, vh)
    return _bf(o).transpose(1, 2)


def _emulated_relpos_tiled(q, k, v, bh, bw, fault, tile=128):
    """B6's arithmetic as the Hopper kernel plays it: 128-key tiles with a
    running max and sum; each accumulator column c of a tile reads the Bw
    value its thread holds in a register for the whole key loop, grid
    column (8·((c / 8) mod 8) + c mod 8) mod gw, and Bh of its 8-key group's
    grid row; p rounded to bf16 before P·V, o at the end. A Bw column offset
    by a whole key tile would land on the same grid column (gw divides the
    tile), which is why the registers may hold it; the faults plant a
    register one thread off (2 columns) and Bh one key tile ahead."""
    b, n, h, d = q.shape
    gh, gw = bh.shape[-1], bw.shape[-1]
    qh, kh, vh = (t.float().transpose(1, 2) for t in (q, k, v))
    bhf, bwf = bh.float().transpose(1, 2), bw.float().transpose(1, 2)
    c = torch.arange(tile)
    reg_col = (8 * ((c // 8) % 8) + c % 8) % gw
    if fault == "bw_register_one_thread_off":
        reg_col = (reg_col + 2) % gw
    bw_reg = bwf[..., reg_col]
    m = torch.full((b, h, n, 1), -np.inf)
    l, acc = torch.zeros((b, h, n, 1)), torch.zeros((b, h, n, d))
    for k0 in range(0, n, tile):
        row = (k0 + 8 * (c // 8)) // gw
        if fault == "bh_row_one_tile_ahead":
            row = (row + tile // gw) % gh
        s = qh @ kh[..., k0:k0 + tile, :].transpose(-1, -2) * d**-0.5 + bhf[..., row] + bw_reg
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha, p = torch.exp(m - m_new), torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _bf(p) @ vh[..., k0:k0 + tile, :]
        m = m_new
    return _bf(acc / l).transpose(1, 2)


def _emulated_window(q, k, v, fault, tile=128):
    """B7's arithmetic as its Hopper kernel plays it: q′ and k′ with their
    columns zero-padded to the 16-deep steps of the products (random pad
    columns with the fault "nonzero_pad_columns"), the keys in 128-key tiles
    zero-filled past N, fp32 logits of the whole row at once, the keys past N
    masked (left in, with zero logits, by "unmasked_padded_keys" and
    "keys_past_n_unmasked"), a single-pass softmax in base 2 with the fp32
    row sum, p rounded to bf16 before P·V, o rounded once; "head_offset"
    writes each head's output one head over."""
    b, n, h, dqk = q.shape
    pad = -dqk % 16
    fill = torch.zeros if fault != "nonzero_pad_columns" else (
        lambda shape: torch.randn(shape, generator=torch.Generator().manual_seed(5)))
    qp, kp = (torch.cat([t.float(), fill((b, n, h, pad))], -1) for t in (q, k))
    keys = -(-n // tile) * tile
    kp = torch.nn.functional.pad(kp, (0, 0, 0, 0, 0, keys - n))
    vh = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, keys - n)).transpose(1, 2)
    s = qp.transpose(1, 2) @ kp.permute(0, 2, 3, 1)  # (B, H, N, keys)
    if fault not in ("unmasked_padded_keys", "keys_past_n_unmasked"):
        s = s.masked_fill(torch.arange(keys) >= n, -np.inf)
    log2e = 1.4426950408889634
    p = torch.exp2(s * log2e - s.amax(-1, keepdim=True) * log2e)
    o = _bf((_bf(p) @ vh) / p.sum(-1, keepdim=True))
    if fault == "head_offset":
        o = o.roll(1, dims=1)
    return o.transpose(1, 2)


def _sam_inputs(seed, side_grid=20, window=14, c=320, nh=4):
    """SAM-H-like inputs at a small size: LN'd tokens, weights of std
    C^-0.5 (so q, k, v have unit variance) and rel-pos tables of std 0.1
    (so the bias moves the logits by O(1))."""
    g = torch.Generator().manual_seed(seed)
    grid = torch.randn((1, side_grid, side_grid, c), generator=g)
    x, _ = sam_vit.window_partition(grid, window)
    x = x.reshape(-1, window * window, c).to(torch.bfloat16)
    w = (torch.randn((c, 3 * c), generator=g) * c**-0.5).to(torch.bfloat16)
    b = (torch.randn(3 * c, generator=g) * 0.1).to(torch.bfloat16)
    hd = c // nh
    rh, rw = ((torch.randn((window, window, hd), generator=g) * 0.1).to(torch.bfloat16)
              for _ in range(2))
    return x, w, b, rh, rw, nh


@pytest.mark.parametrize("kernel,fault", [
    ("window_qkv", "none"), ("window_qkv", "bias_from_scaled_q"),
    ("window_qkv", "masked_padding"), ("window_qkv", "head_offset_one_head"),
    ("window_qkv", "k_v_swapped"), ("window_qkv", "ragged_unmasked"),
    ("window_qkv", "bh_row_per_8_keys"),
    ("relpos", "none"), ("relpos", "swapped_bh_bw"), ("relpos", "index_off_by_one"),
    ("relpos_tiled", "none"), ("relpos_tiled", "bw_register_one_thread_off"),
    ("relpos_tiled", "bh_row_one_tile_ahead"),
    ("window", "none"), ("window", "unmasked_padded_keys"),
    ("window", "keys_past_n_unmasked"), ("window", "nonzero_pad_columns"), ("window", "head_offset"),
])
def test_sam_bounds_separate_rounding_from_kernel_faults(kernel, fault):
    """Each SAM kernel's arithmetic, played on the CPU with its bf16
    roundings, stays within its bounds against the fp32 plain version, and
    each planted fault does not."""
    if kernel == "window_qkv":
        args = _sam_inputs(0)
        got = _emulated_win_qkv_sm90(*args, fault)
        ref = attention.window_qkv_attention_plain(*(a.float() if torch.is_tensor(a) else a
                                                     for a in args))
        bounds = attention.WIN_QKV_BOUNDS
    else:
        g = torch.Generator().manual_seed(1)
        grid_hw = (14, 16) if kernel == "window" else (32, 32)
        n, d = grid_hw[0] * grid_hw[1], 80
        q, k, v = (torch.randn((1, n, 2, d), generator=g).to(torch.bfloat16) for _ in range(3))
        rh = (torch.randn((grid_hw[0], grid_hw[0], d), generator=g) * 0.1).to(torch.bfloat16)
        rw = (torch.randn((grid_hw[1], grid_hw[1], d), generator=g) * 0.1).to(torch.bfloat16)
        bh, bw = attention.rel_pos_bias(q, rh, rw, grid_hw)
        if kernel.startswith("relpos"):
            emulate = _emulated_relpos_tiled if kernel == "relpos_tiled" else _emulated_relpos
            got = emulate(q, k, v, bh, bw, fault)
            ref = attention.relpos_attention_plain(q, k, v, bh, bw)
            bounds = attention.RELPOS_BOUNDS
        else:
            q_aug, k_aug = attention.relpos_aug(q, k, bh, bw, grid_hw)
            got = _emulated_window(q_aug, k_aug, v, fault)
            ref = attention.window_attention_plain(q_aug, k_aug, v)
            bounds = attention.WINDOW_BOUNDS
    errs = attention.attn_errors(got, ref)
    assert attention.within(errs, bounds) == (fault == "none"), errs


def test_cpu_tensors_take_the_plain_versions():
    before = dict(_build.LAUNCHES)
    x, w, b, rh, rw, nh = _sam_inputs(3)
    attention.window_qkv_attention(x.float(), w.float(), b.float(), rh.float(), rw.float(), nh)
    attention.win_qkv_proj(x[0], w, b)
    q = torch.randn((1, 1024, 2, 64))
    r = torch.randn((32, 32, 64)) * 0.1
    attention.flash_attention_relpos(q, q, q, r, r, (32, 32))
    q = torch.randn((1, 224, 2, 64))
    attention.flash_attention_relpos(q, q, q, r[:14, :14], r[:16, :16], (14, 16))
    assert _build.LAUNCHES == before
