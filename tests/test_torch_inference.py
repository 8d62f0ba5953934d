"""Port's device stage of WSI inference against the JAX composition of the
same stage, the package's independence from JAX, and its device rules."""

import copy
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellvit_tpu.models import CellViT as JaxCellViT
from cellvit_tpu.models.checkpoint_io import convert_state_dict
from cellvit_tpu.models.fused import fused_forward_maps
from cellvit_tpu.ops.hv_postproc import instance_map_batch_maps as jax_instance_maps
from cellvit_tpu.ops.instance_stats import instance_stats_batch as jax_stats
from cellvit_tpu.ops.instance_stats import relabel_consecutive as jax_relabel
from cellvit_tpu_torch.inference.cell_detection import CellSegmentationInference
from cellvit_tpu_torch.models.cellvit import CellViT
from cellvit_tpu_torch.models.fused import forward_maps
from cellvit_tpu_torch.synthetic import set_probe_weights

# one intra-op thread each: the suite runs as parallel pytest workers
torch.set_num_threads(1)

PACKAGE = Path(__file__).resolve().parent.parent / "cellvit_tpu_torch"
KW = dict(num_nuclei_classes=6, num_tissue_classes=19, embed_dim=64, depth=4,
          num_heads=2, extract_layers=(1, 2, 3, 4))
#: relative L2 of the tiny CellViT's bf16 tokens against JAX's: the two round
#: activations to bf16 at different places (7.1e-3 with every LayerNorm
#: affine in fp32 as flax keeps it)
TOKENS_L2 = 1e-2
RUN_CONF = {"data": {"num_nuclei_classes": 6, "num_tissue_classes": 19},
            "transformations": {"normalize": {"mean": [0.6, 0.5, 0.4],
                                              "std": [0.3, 0.25, 0.2]}}}


def _tiles(n=2, size=128):
    """Light tiles with dark discs (bench.py's synthetic H&E look)."""
    rng = np.random.default_rng(7)
    imgs = np.full((n, size, size, 3), 0.75, np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    for b in range(n):
        for _ in range(20):
            cy, cx = rng.integers(8, size - 8, 2)
            r = int(rng.integers(4, 9))
            imgs[b][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = rng.uniform(0.1, 0.4)
    return imgs


def _probe_model():
    """The port's tiny CellViT with seeded random weights and the probe
    weights of `synthetic.py` (nucleus and HV maps that follow the tile), and
    the JAX model carrying the same weights."""
    torch.manual_seed(0)
    model = CellViT(**KW)
    set_probe_weights(model)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return model, JaxCellViT(encoder_type="histo", **KW), convert_state_dict(sd, False)


def test_device_outputs_match_jax_composition():
    model, jm, variables = _probe_model()
    imgs = _tiles()
    infer = CellSegmentationInference(model=model, run_conf=RUN_CONF,
                                      max_instances_per_tile=256, device="cpu")
    inst, stats, tokens = infer._device_outputs(imgs, 40)

    mean = np.asarray([0.6, 0.5, 0.4], np.float32)
    std = np.asarray([0.3, 0.25, 0.2], np.float32)
    x = jnp.asarray((imgs - mean) / std)
    out = fused_forward_maps(jm, variables, x, retrieve_tokens=True)
    want_inst = jax_instance_maps(out["np_prob"], out["hv0"], out["hv1"], use_pallas=False)
    type_map = jnp.argmax(out["type_map_cmajor"], 1).astype(jnp.int32)
    want_inst = jax.vmap(lambda m: jax_relabel(m, 128 * 128 // 2 + 2))(want_inst)
    want = jax_stats(want_inst, type_map, out["np_prob"], max_instances=256, num_classes=6)

    np.testing.assert_array_equal(inst, np.asarray(want_inst))
    np.testing.assert_allclose(tokens, np.asarray(out["tokens"]), atol=2e-4)
    for key in ("valid", "area", "bbox", "type"):
        np.testing.assert_array_equal(stats[key], np.asarray(want[key]), err_msg=key)
    for key in ("centroid", "type_prob", "mean_prob"):
        np.testing.assert_allclose(stats[key], np.asarray(want[key]), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    assert inst.shape == (2, 128, 128) and tokens.shape == (2, 8, 8, 64)
    assert (stats["valid"].sum(1) >= 5).all()  # the maps hold real nuclei
    assert infer.last_watershed_passes.shape == (2,)


def test_mixed_precision_keeps_fp32_weights_and_matches_jax_bf16():
    """`mixed_precision=True` keeps the parameters and BatchNorm statistics
    in fp32 and computes in bf16 under autocast, folding BN in fp32: the
    JAX package's `model.clone(dtype=bfloat16)`. The forward maps of the
    tiny CellViT, with every BN statistic randomised (seed 2) so that the
    folds matter, stand against JAX's bf16 `fused_forward_maps` on the same
    fp32 weights. The two still round activations to bf16 at different
    places (accumulation order, fused bias adds, GELU): 1.5e-4 max and
    6.9e-7 mean on np_prob, 1.5e-2 max and 9.1e-5 mean on hv. The bounds sit
    3-14× above that and 3.6-7× below what weights stored in bf16 give (np_prob
    1.4e-2 / 3.6e-5, hv 9.4e-2 / 2.3e-3): the same forward on a bf16 copy
    of the model, which folds BN from rounded statistics, must break the
    np_prob bounds. `-s` prints both sets of errors."""
    model, jm, _ = _probe_model()
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.copy_(torch.randn(mod.running_mean.shape, generator=g) * 0.2)
                mod.running_var.copy_(torch.rand(mod.running_var.shape, generator=g) * 1.5 + 0.5)
    variables = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()}, False)
    stored_bf16 = copy.deepcopy(model).to(torch.bfloat16).eval()
    infer = CellSegmentationInference(model=model, run_conf=RUN_CONF, mixed_precision=True,
                                      device="cpu")
    assert {t.dtype for t in infer.model.state_dict().values() if t.is_floating_point()} == {
        torch.float32}
    x = (_tiles(2, 256) - np.asarray([0.6, 0.5, 0.4], np.float32)) / np.asarray(
        [0.3, 0.25, 0.2], np.float32)
    xt = torch.from_numpy(x).to(infer.dtype)
    got = infer.forward_maps(xt)
    with torch.no_grad():
        rounded = forward_maps(stored_bf16, xt)
    want = fused_forward_maps(jm.clone(dtype=jnp.bfloat16), variables, jnp.asarray(x))
    bounds = {"np_prob": (2e-3, 1e-5), "hv0": (4e-2, 3e-4), "hv1": (4e-2, 3e-4)}
    for key, (max_bound, mean_bound) in bounds.items():
        assert got[key].dtype == torch.float32 and want[key].dtype == jnp.float32
        err = np.abs(got[key].numpy() - np.asarray(want[key]))
        err_rounded = np.abs(rounded[key].float().numpy() - np.asarray(want[key]))
        print(f"{key}: max {err.max():.3e}, mean {err.mean():.3e}; weights stored in bf16: "
              f"max {err_rounded.max():.3e}, mean {err_rounded.mean():.3e}")
        assert err.max() <= max_bound and err.mean() <= mean_bound, (key, err.max(), err.mean())
        if key == "np_prob":
            assert err_rounded.max() > max_bound and err_rounded.mean() > mean_bound, (
                err_rounded.max(), err_rounded.mean())
    assert got["type_map_cmajor"].dtype == torch.bfloat16
    assert {p.dtype for p in infer.model.parameters()} == {torch.float32}


def test_mixed_precision_layernorm_affines_match_jax_bf16():
    """The same tiny CellViT and randomised BN statistics, with every
    LayerNorm weight drawn as 1 + 0.3·N(0, 1) and every bias as 0.2·N(0, 1)
    (seed 3), which bf16 does not round exactly, held against JAX's bf16
    `fused_forward_maps` (flax keeps the LayerNorm affines in fp32): np_prob
    and hv within the bounds of the test above. With the probe weights those
    maps read only the image skip path, so the encoder's tokens, which every
    LayerNorm feeds, are held too: relative L2 within TOKENS_L2. Measured:
    7.4e-3 with the port's bf16 affines, 7.1e-3 with the affines in fp32
    (the rest is bf16 rounding at other places), 2.9e-2 with the affines
    rounded to fp8 e4m3, which must break the bound. `-s` prints the three."""
    from cellvit_tpu_torch.models import layers

    model, jm, _ = _probe_model()
    g = torch.Generator().manual_seed(2)
    ln = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.copy_(torch.randn(mod.running_mean.shape, generator=g) * 0.2)
                mod.running_var.copy_(torch.rand(mod.running_var.shape, generator=g) * 1.5 + 0.5)
            if isinstance(mod, torch.nn.LayerNorm):
                mod.weight.copy_(1.0 + 0.3 * torch.randn(mod.weight.shape, generator=ln))
                mod.bias.copy_(0.2 * torch.randn(mod.bias.shape, generator=ln))
    assert sum(isinstance(m, layers.LayerNorm) for m in model.modules()) == 9  # 2 a block, the last
    variables = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()}, False)
    infer = CellSegmentationInference(model=model, run_conf=RUN_CONF, mixed_precision=True,
                                      device="cpu")
    x = (_tiles(2, 256) - np.asarray([0.6, 0.5, 0.4], np.float32)) / np.asarray(
        [0.3, 0.25, 0.2], np.float32)
    xt = torch.from_numpy(x).to(infer.dtype)

    def affines_as(dtype):
        def forward(self, x):
            out_dtype = layers.compute_dtype(x)
            with torch.autocast(x.device.type, enabled=False):
                w, b = (t.to(dtype).float() for t in (self.weight, self.bias))
                out = torch.nn.functional.layer_norm(x.float(), self.normalized_shape, w, b, self.eps)
            return out.to(out_dtype)
        return forward

    got = {"bf16 (the port)": infer.forward_maps(xt, retrieve_tokens=True)}
    for name, dtype in (("fp32", torch.float32), ("fp8 e4m3", torch.float8_e4m3fn)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(layers.LayerNorm, "forward", affines_as(dtype))
            got[name] = infer.forward_maps(xt, retrieve_tokens=True)
    want = fused_forward_maps(jm.clone(dtype=jnp.bfloat16), variables, jnp.asarray(x),
                              retrieve_tokens=True)
    bounds = {"np_prob": (2e-3, 1e-5), "hv0": (4e-2, 3e-4), "hv1": (4e-2, 3e-4)}
    for key, (max_bound, mean_bound) in bounds.items():
        errs = {n: np.abs(o[key].numpy() - np.asarray(want[key])) for n, o in got.items()}
        print(f"{key}: max, mean |Δ| with the LayerNorm affines in "
              + "; ".join(f"{n} {e.max():.3e}, {e.mean():.3e}" for n, e in errs.items()))
        err = errs["bf16 (the port)"]
        assert err.max() <= max_bound and err.mean() <= mean_bound, (key, err.max(), err.mean())
    tok = np.asarray(want["tokens"], np.float32)
    rel = {n: float(np.linalg.norm(o["tokens"].float().numpy() - tok) / np.linalg.norm(tok))
           for n, o in got.items()}
    print("tokens: relative L2 with the LayerNorm affines in "
          + "; ".join(f"{n} {v:.3e}" for n, v in rel.items()) + f" (bound {TOKENS_L2:g})")
    assert rel["bf16 (the port)"] <= TOKENS_L2 and rel["fp32"] <= TOKENS_L2, rel
    assert rel["fp8 e4m3"] > TOKENS_L2, rel


def test_package_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib, cellvit_tpu_torch\n"
        "for m in pkgutil.walk_packages(cellvit_tpu_torch.__path__, 'cellvit_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'flax', 'cellvit_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('cellvit_tpu_torch')]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=PACKAGE.parent,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15


def test_package_sources_name_no_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|cellvit_tpu)(\.|\s|$)", re.MULTILINE)
    offenders = [p.name for p in PACKAGE.rglob("*.py") if pattern.search(p.read_text())]
    assert offenders == []
    assert pattern.search("from cellvit_tpu.ops import cc")
    assert not pattern.search("from cellvit_tpu_torch.ops import cc")


def test_entry_points_need_a_gpu_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = CellViT(**KW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CellSegmentationInference(model=model, run_conf=RUN_CONF)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CellSegmentationInference(model=model, run_conf=RUN_CONF, device="cuda")
    infer = CellSegmentationInference(model=model, run_conf=RUN_CONF, device="cpu")
    assert infer.device.type == "cpu"
    assert np.allclose(infer.mean, [0.6, 0.5, 0.4])


def test_check_wsi():
    infer = CellSegmentationInference(model=CellViT(**KW), run_conf=RUN_CONF, device="cpu")
    meta = {"magnification": 40, "patch_size": 1024, "patch_overlap": 64}
    infer.check_wsi(SimpleNamespace(metadata=meta))
    infer.check_wsi({"magnification": None, "base_magnification": 40, "downsampling": 2,
                     "patch_size": 1024, "patch_overlap": 64}, magnification=20)
    with pytest.raises(RuntimeError, match="magnification"):
        infer.check_wsi(meta, magnification=20)
    with pytest.raises(RuntimeError, match="overlap"):
        infer.check_wsi(dict(meta, patch_overlap=32))


def test_bindings_match_c_entry_points():
    """Every `_build.bind(source, name, sig)` in the package spells the
    argument list of the C entry point it binds: pointers (p), ints (i) and
    floats (f), then the stream."""
    import ast

    protos = {}
    for src in (PACKAGE / "csrc").glob("*.cu"):
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            params = [p.strip() for p in m.group(2).split(",")]
            assert params[-1] == "void* stream", (src.name, m.group(1))
            kinds = "".join("p" if "*" in p else {"int": "i", "float": "f"}[p.split()[0]]
                            for p in params[:-1])
            protos[(src.name, m.group(1))] = kinds
    bound = []
    for py in PACKAGE.rglob("*.py"):
        for node in ast.walk(ast.parse(py.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "bind"):
                src, name, sig = (ast.literal_eval(a) for a in node.args)
                bound.append(name)
                assert protos[(src, name)] == sig, (src, name, sig, protos[(src, name)])
    assert sorted(bound) == sorted(name for _, name in protos)
    from cellvit_tpu_torch import _build

    assert {src for src, _ in protos} == set(_build.SOURCES)  # every built source is bound
