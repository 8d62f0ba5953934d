"""The training CLI's host side against the JAX package: `yaml_lite` on the
configs, the datasets and their sampling weights, every augmentation against
the JAX package's cv2 pipeline, and the pretrained-encoder loaders.

Augmentations, on 256² PanNuke-like patches (≈37 nuclei) with the same
generator seed, one thread:
- exact: the flips, rot90, Downscale, Blur, GaussNoise, Superpixels,
  Normalize, RGB→GRAY, RandomSizedCrop's mask, ElasticTransform's mask on
  these seeds;
- within 1 grey level at every pixel and equal on ≥ 99% of pixels: the HSV
  round trip, ColorJitter, ZoomBlur, RandomSizedCrop's image;
- ElasticTransform: the image's mean absolute difference ≤ 0.5 grey levels
  and its mask labels equal on ≥ 99.9% of pixels.
The shares these seeds give are printed (`-s`).
"""

from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import yaml

from cellvit_tpu.data import datasets as jax_datasets
from cellvit_tpu.data import labels as jax_labels
from cellvit_tpu.data import transforms as J
from cellvit_tpu.data.loader import get_sampler as jax_get_sampler
from cellvit_tpu_torch.data import datasets, labels
from cellvit_tpu_torch.data import transforms as T
from cellvit_tpu_torch.data.loader import get_sampler
from cellvit_tpu_torch.utils import yaml_lite
from tests.synth import make_conic_dataset, make_pannuke_dataset, random_instance_image
from test_torch_wsi import _same

ROOT = Path(__file__).resolve().parents[1]
SEEDS = range(6)
CONFIG = yaml.safe_load((ROOT / "configs/examples/train_cellvit.yaml").read_text())["transformations"]


def _patch(seed: int, size: int = 256):
    """A PanNuke-like patch: ≈37 nuclei, a 3×3 blur so neighbours differ
    smoothly as in tissue; the (inst, type) mask."""
    rng = np.random.default_rng(seed)
    img, inst, typ = random_instance_image(rng, h=size, w=size, n_cells=37)
    return cv2.GaussianBlur(img, (3, 3), 1), np.stack([inst, typ], -1).astype(np.int32)


def _ops(M):
    """Each op of the example config at its parameters, always applied."""
    s = CONFIG
    return {
        "RandomRotate90": M.RandomRotate90(1.0),
        "HorizontalFlip": M.HorizontalFlip(1.0),
        "VerticalFlip": M.VerticalFlip(1.0),
        "Downscale": M.Downscale(1.0, s["downscale"]["scale"]),
        "Blur": M.Blur(1.0, s["blur"]["blur_limit"]),
        "GaussNoise": M.GaussNoise(1.0, s["gaussnoise"]["var_limit"]),
        "ColorJitter": M.ColorJitter(1.0, s["colorjitter"]["scale_setting"],
                                     s["colorjitter"]["scale_setting"],
                                     s["colorjitter"]["scale_color"],
                                     s["colorjitter"]["scale_color"] / 2),
        "Superpixels": M.Superpixels(1.0, 0.1, 200, 128),
        "ZoomBlur": M.ZoomBlur(1.0, 1.05),
        "RandomSizedCrop": M.RandomSizedCrop(1.0, (128, 256), 256, 256),
        "ElasticTransform": M.ElasticTransform(1.0, 0.5, 25, 15),
    }


EXACT = ("RandomRotate90", "HorizontalFlip", "VerticalFlip", "Downscale", "Blur", "GaussNoise",
         "Superpixels")
WITHIN_ONE = ("ColorJitter", "ZoomBlur", "RandomSizedCrop")


@pytest.mark.parametrize("name", list(_ops(J)))
def test_each_transform_matches_jax(name):
    shares, mads = [], []
    for seed in SEEDS:
        img, mask = _patch(seed)
        a_img, a_mask = _ops(J)[name](img, mask, np.random.default_rng(seed))
        b_img, b_mask = _ops(T)[name](img, mask, np.random.default_rng(seed))
        assert b_img.dtype == a_img.dtype and b_img.shape == a_img.shape, name
        assert b_mask.shape == a_mask.shape, name
        d = np.abs(a_img.astype(np.int64) - b_img.astype(np.int64))
        shares.append(float((d == 0).mean()))
        mads.append(float(d.mean()))
        if name in EXACT:
            assert d.max() == 0, (name, seed)
        elif name in WITHIN_ONE:
            assert d.max() <= 1 and (d == 0).mean() >= 0.99, (name, seed, d.max(), (d == 0).mean())
        else:
            assert d.mean() <= 0.5, (name, seed, d.mean())
        if name == "ElasticTransform":
            assert (a_mask == b_mask).mean() >= 0.999, (name, seed)
        else:
            np.testing.assert_array_equal(b_mask, a_mask, err_msg=f"{name} {seed}")
    print(f"{name}: image pixels equal {min(shares):.6f} (worst seed), "
          f"mean |Δ| {max(mads):.6f}")


def test_cv2_colour_conversions():
    """RGB→GRAY exact; RGB→HSV exact; HSV→RGB within 1, ≥ 99% equal."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
    np.testing.assert_array_equal(T.rgb_to_gray_u8(img), cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))
    np.testing.assert_array_equal(T.rgb_to_hsv_u8(img), cv2.cvtColor(img, cv2.COLOR_RGB2HSV))
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    d = np.abs(T.hsv_to_rgb_u8(hsv).astype(int) - cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
    print(f"HSV→RGB: equal {(d == 0).mean():.6f}")
    assert d.max() <= 1 and (d == 0).mean() >= 0.99


@pytest.mark.parametrize("src,dst", [(256, 268), (128, 256), (200, 256), (64, 67)])
def test_cv2_resizes(src, dst):
    img = np.random.default_rng(src).integers(0, 256, (src, src, 3), dtype=np.uint8)
    np.testing.assert_array_equal(T.resize_nearest(img, dst, dst),
                                  cv2.resize(img, (dst, dst), interpolation=cv2.INTER_NEAREST))
    d = np.abs(T.resize_linear_u8(img, dst, dst).astype(int)
               - cv2.resize(img, (dst, dst), interpolation=cv2.INTER_LINEAR))
    print(f"linear resize {src}→{dst}: equal {(d == 0).mean():.6f}")
    assert d.max() <= 1 and (d == 0).mean() >= 0.99


def test_pipeline_matches_jax_on_one_thread():
    """The example config's whole train pipeline (every op at its p) over
    24 patches, one Compose each side with the same seed, draws in order."""
    jt, _ = J.build_transforms(CONFIG, 256, seed=7)
    tt, _ = T.build_transforms(CONFIG, 256, seed=7)
    img, mask = _patch(99)
    np.testing.assert_array_equal(tt.transforms[-1](img, mask)[0], jt.transforms[-1](img, mask)[0])
    assert [type(t).__name__ for t in jt.transforms] == [type(t).__name__ for t in tt.transforms]
    for i in range(24):
        img, mask = _patch(100 + i)
        a_img, a_mask = jt(img, mask)
        b_img, b_mask = tt(img, mask)
        # normalized floats: one grey level is 2/255
        assert np.abs(a_img - b_img).max() <= 2 / 255 + 1e-6, i
        assert np.abs(a_img - b_img).mean() <= 0.5 * 2 / 255, i
        assert (a_mask == b_mask).mean() >= 0.999, i


# ------------------------------------------------------------------ YAML


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in ROOT.glob("configs/**/*.yaml")))
def test_yaml_lite_reads_every_config(path):
    text = (ROOT / path).read_text()
    assert _same(yaml_lite.load(text), yaml.safe_load(text)), path


# -------------------------------------------------------------- datasets


def test_labels_match_jax():
    _, inst, _ = random_instance_image(np.random.default_rng(3), 96, 96, n_cells=12)
    inst[90:, 90:] = 1  # a second component of instance 1
    np.testing.assert_array_equal(labels.fix_duplicates(inst), jax_labels.fix_duplicates(inst))
    np.testing.assert_array_equal(labels.gen_regression_map(inst),
                                  jax_labels.gen_regression_map(inst))


def _items_equal(a, b):
    img_a, masks_a, *rest_a = a
    img_b, masks_b, *rest_b = b
    np.testing.assert_array_equal(img_b, img_a)
    assert masks_a.keys() == masks_b.keys()
    for k in masks_a:
        np.testing.assert_array_equal(masks_b[k], masks_a[k], err_msg=k)
    assert rest_a == rest_b


def test_pannuke_dataset_matches_jax(tmp_path):
    root = make_pannuke_dataset(tmp_path, folds=(0, 1), n_images=5, size=64)
    jt, _ = J.build_transforms(CONFIG, 64, seed=3)
    tt, _ = T.build_transforms(CONFIG, 64, seed=3)
    for regression in (False, True):
        a = jax_datasets.select_dataset("pannuke", "train", {"dataset_path": root,
                                        "train_folds": [0, 1]}, regression=regression)
        b = datasets.select_dataset("pannuke", "train", {"dataset_path": root,
                                    "train_folds": [0, 1]}, regression=regression)
        assert len(a) == len(b) == 10 and a.img_names == b.img_names
        for i in range(len(a)):
            _items_equal(a[i], b[i])
    # augmented items, one thread each side: the pipeline test's bounds
    a.set_transforms(jt)
    b.set_transforms(tt)
    for i in range(len(a)):
        (img_a, masks_a, *rest_a), (img_b, masks_b, *rest_b) = a[i], b[i]
        assert np.abs(img_a - img_b).max() <= 2 / 255 + 1e-6 and rest_a == rest_b
        for k in masks_a:
            assert (masks_a[k] == masks_b[k]).mean() >= 0.999, (i, k)
    for strategy in ("random", "cell", "tissue", "cell+tissue"):
        sa = jax_get_sampler(a, strategy, gamma=0.85, seed=19)
        sb = get_sampler(b, strategy, gamma=0.85, seed=19)
        if strategy != "random":
            np.testing.assert_array_equal(sb.p, sa.p)
        assert list(sb) == list(sa)
    with pytest.raises(NotImplementedError):
        datasets.PanNukeDataset(root, 0, stardist=True)


def test_conic_dataset_matches_jax(tmp_path):
    root = make_conic_dataset(tmp_path, folds=(0, 1), n_images=4)
    cfg = {"dataset_path": root, "train_folds": [0, 1], "val_folds": [1]}
    for split in ("train", "val"):
        a = jax_datasets.select_dataset("conic", split, cfg)
        b = datasets.select_dataset("conic", split, cfg)
        assert len(a) == len(b)
        for i in range(len(a)):
            _items_equal(a[i], b[i])
    a.load_cell_count()
    b.load_cell_count()
    np.testing.assert_array_equal(b.get_sampling_weights_cell(0.85), a.get_sampling_weights_cell(0.85))


# ------------------------------------------------------ pretrained encoders


def _tiny_models(encoder_type: str):
    from cellvit_tpu.models import CellViT as JaxCellViT
    from cellvit_tpu_torch.models.cellvit import CellViT
    from test_torch_models import _random_variables

    kw = dict(num_nuclei_classes=6, num_tissue_classes=19, embed_dim=64, depth=4, num_heads=2,
              extract_layers=(1, 2, 3, 4))
    if encoder_type == "sam":
        kw.update(global_attn_indexes=(1, 3), window_size=4, prompt_embed_dim=32)
    jm = JaxCellViT(encoder_type=encoder_type, **kw)
    return jm, CellViT(encoder_type=encoder_type, **kw), _random_variables


@pytest.mark.parametrize("encoder_type", ["histo", "sam"])
def test_encoder_loaders_match_jax(tmp_path, encoder_type):
    """A DINO-teacher or SAM `.pth` (with the heads, prompt encoder and mask
    decoder a real one carries) loaded into the same initial model by JAX's
    loader and the port's: the same tokens and outputs."""
    import jax

    from cellvit_tpu.models.checkpoint_io import load_dino_encoder, load_sam_encoder
    from cellvit_tpu.train.experiment import ExperimentCellVitPanNuke as JaxExperiment
    from cellvit_tpu_torch.models.checkpoint_io import (load_dino_encoder as port_dino,
                                                        load_encoder_into, load_sam_encoder as port_sam,
                                                        load_state_dict_into, state_dict_from_flax)

    jm, tm, random_variables = _tiny_models(encoder_type)
    x = np.random.default_rng(0).normal(size=(1, 64, 64, 3)).astype(np.float32)
    pretrained = random_variables(jm, x.shape, 1, train=False)
    init = random_variables(jm, x.shape, 2, train=False)
    enc = {k[len("encoder."):]: v for k, v in
           state_dict_from_flax(pretrained["params"], pretrained.get("batch_stats")).items()
           if k.startswith("encoder.")}
    if encoder_type == "histo":
        extra = {"head.mlp.0.weight": torch.zeros(8, 64), "head.last_layer.weight_g": torch.ones(1)}
        ckpt = {"teacher": {**{f"module.backbone.{k}": v for k, v in enc.items()}, **extra},
                "student": {}}
    else:
        ckpt = {**{f"image_encoder.{k}": v for k, v in enc.items()},
                "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix": torch.zeros(2, 16),
                "mask_decoder.iou_token.weight": torch.zeros(1, 32)}
    path = tmp_path / "pretrained.pth"
    torch.save(ckpt, str(path))

    jax_exp = JaxExperiment.__new__(JaxExperiment)
    jax_exp.run_conf = {"model": {"pretrained_encoder": str(path)}}
    merged = jax_exp.load_pretrained(jm, init)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False, retrieve_tokens=True))(merged, x)

    load_state_dict_into(tm, state_dict_from_flax(init["params"], init.get("batch_stats")))
    loaded = (port_sam if encoder_type == "sam" else port_dino)(path)
    assert not any(k.startswith(("head.mlp", "head.last", "prompt", "mask")) for k in loaded)
    load_encoder_into(tm, loaded)
    for k, v in enc.items():
        torch.testing.assert_close(tm.encoder.state_dict()[k], v, rtol=0, atol=0, msg=k)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x), retrieve_tokens=True)
    for k in ("tokens", "tissue_types", "nuclei_binary_map", "hv_map"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=2e-4, err_msg=k)
