"""Port's CellViT (histo) against the JAX model on the same weights: the
flax → torch bridge, the module forward, the inference maps, the flash
route of the encoder, and reading a reference-format checkpoint.
fp32 outputs agree within 2e-4 (docs/PARITY.md)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellvit_tpu.models import CellViT as JaxCellViT
from cellvit_tpu.models.checkpoint_io import export_torch_state_dict
from cellvit_tpu.models.fused import fused_forward_maps
from cellvit_tpu.models.vit import HistoViT as JaxHistoViT
from cellvit_tpu_torch.models import vit as torch_vit
from cellvit_tpu_torch.models.cellvit import CellViT, CellViTSAM
from cellvit_tpu_torch.models.checkpoint_io import (
    load_checkpoint,
    load_state_dict_into,
    state_dict_from_flax,
)
from cellvit_tpu_torch.models.fused import forward_maps
from cellvit_tpu_torch.models.layers import resize_matrix_1d

# one intra-op thread each: the suite runs as parallel pytest workers
torch.set_num_threads(1)

KW = dict(num_nuclei_classes=6, num_tissue_classes=19, embed_dim=64, depth=4,
          num_heads=2, extract_layers=(1, 2, 3, 4))


def _random_variables(module, x_shape, seed, **init_kw):
    """Variables of `module` for inputs of `x_shape`: the tree of its init
    (traced, not compiled) filled with seeded numpy values. Unlike flax's
    init (zero biases, unit norms), every leaf is distinct, so a key the
    bridge swaps shows in the outputs; BN statistics are random so that
    folding matters."""
    shapes = jax.eval_shape(lambda k, x: module.init(k, x, **init_kw),
                            jax.random.PRNGKey(0), jnp.zeros(x_shape))
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == "kernel":  # (…, fan_in, out)
            v = rng.normal(0, np.prod(a.shape[:-1]) ** -0.5, a.shape)
        elif name == "scale":
            v = rng.normal(1.0, 0.1, a.shape)
        elif name == "var":
            v = rng.uniform(0.5, 2.0, a.shape)
        elif name == "mean":
            v = rng.normal(0, 0.05, a.shape)
        else:  # bias, cls_token, pos_embed
            v = rng.normal(0, 0.02, a.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def pair():
    """JAX model + variables and the port's model carrying the same weights."""
    jm = JaxCellViT(encoder_type="histo", **KW)
    variables = _random_variables(jm, (1, 64, 64, 3), 1, train=False)
    tm = CellViT(**KW).eval()
    load_state_dict_into(tm, state_dict_from_flax(variables["params"], variables["batch_stats"]))
    return jm, variables, tm


def test_bridge_equals_export(pair):
    _, variables, tm = pair
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"])
    ref = export_torch_state_dict(variables, sam_encoder=False)
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)
    model_keys = {k for k in tm.state_dict() if not k.endswith("num_batches_tracked")}
    assert model_keys == set(ref)


@pytest.mark.parametrize("size", [64, 128])
def test_forward_matches_jax(pair, size):
    jm, variables, tm = pair
    x = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False, retrieve_tokens=True))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), retrieve_tokens=True)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=2e-4, err_msg=k)
    assert np.abs(np.asarray(want["hv_map"])).max() > 1e-2  # the towers are live


@pytest.mark.parametrize("size", [64, 128])
def test_forward_maps_matches_jax(pair, size):
    jm, variables, tm = pair
    x = np.random.default_rng(size + 1).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    want = fused_forward_maps(jm, variables, jnp.asarray(x), retrieve_tokens=True)
    got = forward_maps(tm, torch.from_numpy(x), retrieve_tokens=True)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=2e-4, err_msg=k)


def test_forward_maps_refolds_changed_weights():
    """The BN fold is kept across calls and redone when a weight changes in
    place or is replaced."""
    torch.manual_seed(0)
    tm = CellViT(**KW).eval()
    x = torch.from_numpy(np.random.default_rng(5).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32))
    before = forward_maps(tm, x)["hv0"]
    np.testing.assert_array_equal(forward_maps(tm, x)["hv0"].numpy(), before.numpy())
    bn = tm.hv_map_decoder.decoder0_header[0].block[1]
    with torch.no_grad():
        bn.running_var.mul_(4.0)
    after = forward_maps(tm, x)["hv0"]
    assert not torch.equal(after, before)
    np.testing.assert_array_equal(after.numpy(), forward_maps(copy.deepcopy(tm), x)["hv0"].numpy())
    tm.load_state_dict(CellViT(**KW).state_dict())
    np.testing.assert_array_equal(forward_maps(tm, x)["hv0"].numpy(),
                                  forward_maps(copy.deepcopy(tm), x)["hv0"].numpy())


def test_encoder_flash_route_at_1025_tokens(monkeypatch):
    """512² → 1025 tokens ≥ 1024: the port's attention takes the flash
    wrapper (its plain version on CPU) and matches the JAX einsum path."""
    calls = []
    real = torch_vit.flash_attention
    monkeypatch.setattr(torch_vit, "flash_attention",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    jm = JaxHistoViT(embed_dim=64, depth=2, num_heads=2, extract_layers=(1, 2))
    x = np.random.default_rng(3).uniform(-1, 1, (1, 512, 512, 3)).astype(np.float32)
    v = _random_variables(jm, x.shape, 3)
    want_logits, want_cls, want_skips = jax.jit(jm.apply)(v, jnp.asarray(x))
    sd = {k[len("encoder."):]: t for k, t in state_dict_from_flax({"encoder": v["params"]}).items()}
    tm = torch_vit.HistoViT(embed_dim=64, depth=2, num_heads=2, extract_layers=(1, 2)).eval()
    tm.load_state_dict(sd)
    with torch.no_grad():
        logits, cls, skips = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert calls == [(1, 1025, 2, 32)] * 2
    np.testing.assert_allclose(cls.numpy(), np.asarray(want_cls), atol=2e-4)
    for a, b in zip(skips, want_skips):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4)


def test_resize_matrix_matches_jax():
    from cellvit_tpu.models.layers import resize_matrix_1d as jax_resize

    for n_in, n_out in ((14, 8), (14, 64), (14, 16)):
        scale = (n_out + 0.1) / n_in
        np.testing.assert_array_equal(resize_matrix_1d(n_in, n_out, scale).numpy(),
                                      np.asarray(jax_resize(n_in, n_out, scale)))


def test_load_checkpoint_reads_reference_format(pair, tmp_path):
    _, variables, tm = pair
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"])
    config = {"data.num_nuclei_classes": 6, "data.num_tissue_classes": 19,
              "model.embed_dim": 64, "model.depth": 4, "model.num_heads": 2,
              "model.extract_layers": [1, 2, 3, 4],
              "transformations.normalize.mean": [0.5, 0.5, 0.5]}
    path = tmp_path / "model.pth"
    torch.save({"arch": "CellViT", "epoch": 1, "model_state_dict": sd, "config": config}, path)
    model, state_dict, run_conf = load_checkpoint(path)
    assert run_conf["model"]["depth"] == 4
    assert run_conf["transformations"]["normalize"]["mean"] == [0.5, 0.5, 0.5]
    for k, v in tm.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_sam_b_builds_with_reference_keys():
    """CellViTSAM(6, 19, "SAM-B") has the reference torch key of every leaf
    of the JAX SAM-B model, with as many values (the traced init tree, not
    computed)."""
    from cellvit_tpu.models import CellViTSAM as JaxCellViTSAM
    from cellvit_tpu.models.checkpoint_io import _flax_path_to_torch_key

    jm = JaxCellViTSAM(6, 19, "SAM-B")
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, train=False), jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    want = {}
    for coll, tree in shapes.items():
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key, _ = _flax_path_to_torch_key(tuple(p.key for p in path), coll, True)
            want[key] = int(np.prod(leaf.shape))
    tm = CellViTSAM(6, 19, "SAM-B")
    got = {k: v.numel() for k, v in tm.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert got == want
    assert tm.encoder.blocks[2].window_size == 0 and tm.encoder.blocks[3].window_size == 14
