"""Synthetic workload: H&E-like blob tiles (the JAX package's
`bench.py:119-128`), training batches with HoVer-Net targets built from
them, a dataset in PanNuke's on-disk layout for the training CLI, and probe
weights that make a randomly initialised CellViT's nucleus and HV maps
follow those tiles, so that the postprocessing has real nuclei to
segment."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from scipy import ndimage

from cellvit_tpu_torch.data.labels import gen_instance_hv_map

#: tissue names of `training_batch`, mapped to class ids (19 tissue classes)
TISSUE_TYPES = {f"tissue_{i:02d}": i for i in range(19)}


def blob_tiles(batch: int = 8, tile: int = 1024, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """600 dark discs of radius 4-12 per `tile`² tile on a 0.75 background.
    Returns ((batch, tile, tile, 3) fp32 images in [0, 1], disc masks)."""
    rng = np.random.default_rng(seed)
    imgs = np.full((batch, tile, tile, 3), 0.75, np.float32)
    masks = np.zeros((batch, tile, tile), bool)
    for b in range(batch):
        for _ in range(600):
            cy, cx = rng.integers(10, tile - 10, 2)
            r = int(rng.integers(4, 12))
            y0, x0 = max(cy - r, 0), max(cx - r, 0)
            y1, x1 = min(cy + r + 1, tile), min(cx + r + 1, tile)
            yy, xx = np.mgrid[y0:y1, x0:x1]
            m = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
            imgs[b, y0:y1, x0:x1][m] = rng.uniform(0.1, 0.4)
            masks[b, y0:y1, x0:x1] |= m
    return imgs, masks


def training_batch(batch: int = 4, tile: int = 1024, seed: int = 0,
                   num_nuclei_classes: int = 6) -> Dict:
    """A loader batch (`data.loader.default_collate` keys) of `blob_tiles`:
    images normalised with mean = std = 0.5; instances the 4-connected
    components of the disc masks; HV maps from `gen_instance_hv_map`; a
    seeded nucleus type in 1..num_nuclei_classes−1 per instance and a seeded
    tissue per tile."""
    imgs, masks = blob_tiles(batch, tile, seed)
    rng = np.random.default_rng(seed + 1)
    inst = np.zeros(masks.shape, np.int32)
    types = np.zeros(masks.shape, np.int32)
    hv = np.zeros(masks.shape + (2,), np.float32)
    for b in range(batch):
        inst[b], n = ndimage.label(masks[b])
        lut = np.concatenate([[0], rng.integers(1, num_nuclei_classes, n)]).astype(np.int32)
        types[b] = lut[inst[b]]
        hv[b] = gen_instance_hv_map(inst[b])
    names = list(TISSUE_TYPES)
    return {
        "image": (imgs - 0.5) / 0.5,
        "masks/instance_map": inst,
        "masks/nuclei_binary_map": (inst > 0).astype(np.int32),
        "masks/nuclei_type_map": types,
        "masks/hv_map": hv,
        "tissue_types": [names[i] for i in rng.integers(0, len(names), batch)],
        "names": [f"blob_{seed}_{b}" for b in range(batch)],
    }


def write_pannuke_folds(root: Path, folds: Mapping[int, int], dataset_config: Dict,
                        weight_config: Dict, tile: int = 256, seed: int = 13) -> None:
    """A dataset in PanNuke's layout, written with the port's own tools: per
    fold (`folds`: fold → number of patches) `images/*.png` (`tile`² RGB,
    `encode_png`), `labels/*.npy` ({inst_map, type_map}), `types.csv` (the
    tissue names of `dataset_config` in turn) and `cell_count.csv`; the two
    configs as `dataset_config.yaml` and `weight_config.yaml`
    (`yaml_lite.dump`). Nuclei as `blob_tiles` draws them: dark discs of
    radius 4-12 at 600 a 1024² area, each of a type in 1-5 and claiming
    only free pixels, on a light background with ±8 grey levels of noise."""
    from cellvit_tpu_torch.data.png import encode_png
    from cellvit_tpu_torch.utils import yaml_lite

    root = Path(root)
    tissues = list(dataset_config["tissue_types"])
    nuclei = [n for n, i in sorted(dataset_config["nuclei_types"].items(), key=lambda kv: kv[1]) if i]
    yy, xx = np.mgrid[0:tile, 0:tile]
    rng = np.random.default_rng(seed)
    k = 0
    for fold, n in folds.items():
        d = root / f"fold{fold}"
        (d / "images").mkdir(parents=True)
        (d / "labels").mkdir()
        types_rows, count_rows = ["img,type"], ["Image," + ",".join(nuclei)]
        for i in range(n):
            img = np.full((tile, tile, 3), 191, np.int32) + rng.integers(-8, 9, (tile, tile, 3))
            inst = np.zeros((tile, tile), np.int32)
            typ = np.zeros((tile, tile), np.int32)
            for j in range(600 * tile * tile // 1024**2):
                cy, cx = rng.integers(10, tile - 10, 2)
                r = int(rng.integers(4, 12))
                disc = ((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r) & (inst == 0)
                img[disc] = int(rng.integers(25, 103))
                inst[disc] = j + 1
                typ[disc] = int(rng.integers(1, 6))
            name = f"{fold}_{i}"
            (d / "images" / f"{name}.png").write_bytes(encode_png(img.clip(0, 255).astype(np.uint8)))
            np.save(d / "labels" / f"{name}.npy",
                    np.array({"inst_map": inst, "type_map": typ}, dtype=object), allow_pickle=True)
            types_rows.append(f"{name}.png,{tissues[k % len(tissues)]}")
            counts = [len(np.unique(inst[typ == c])) for c in range(1, 6)]
            count_rows.append(f"{name}.png," + ",".join(map(str, counts)))
            k += 1
        (d / "types.csv").write_text("\n".join(types_rows) + "\n")
        (d / "cell_count.csv").write_text("\n".join(count_rows) + "\n")
    (root / "dataset_config.yaml").write_text(yaml_lite.dump(dataset_config))
    (root / "weight_config.yaml").write_text(yaml_lite.dump(weight_config))


def cellvit256_trainer(seed: int = 2, device: str = "cuda"):
    """The training workload: a full-width CellViT-256 (random weights from
    `seed` plus the probe weights, drop-path 0.1, no dropout) in a
    `CellViTTrainer` with the reference's default losses, AdamW as
    `configs/examples/train_cellvit.yaml` sets it (lr 3e-4, betas 0.85/0.95,
    weight decay 1e-4, exponential schedule with gamma 0.85) and bf16
    autocast, on `device`."""
    from cellvit_tpu_torch.models.cellvit import CellViT256
    from cellvit_tpu_torch.train.optim import make_lr_schedule, retrieve_optimizer
    from cellvit_tpu_torch.train.trainer import CellViTTrainer, default_loss_fn_dict

    torch.manual_seed(seed)
    model = CellViT256(num_nuclei_classes=6, num_tissue_classes=19, drop_rate=0.0,
                       attn_drop_rate=0.0, drop_path_rate=0.1)
    set_probe_weights(model)
    schedule = make_lr_schedule("exponential", 3e-4, epochs=130, steps_per_epoch=100, gamma=0.85)
    tx = retrieve_optimizer("AdamW", {"lr": 3e-4, "betas": (0.85, 0.95), "weight_decay": 1e-4},
                            schedule)
    return CellViTTrainer(model, default_loss_fn_dict(), tx, num_classes=6,
                          tissue_types=TISSUE_TYPES, device=device, mixed_precision=True)


def random_sam_h(seed: int, device: str = "cuda"):
    """A full-width CellViT-SAM-H (6 nucleus, 19 tissue classes) with random
    weights from `seed`, built on `device`. The rel-pos tables are drawn at
    std 0.05: their init is zero, which would leave the bias dead."""
    from cellvit_tpu_torch.models.cellvit import CellViTSAM

    torch.manual_seed(seed)
    with torch.device(device):
        model = CellViTSAM(num_nuclei_classes=6, num_tissue_classes=19, vit_structure="SAM-H")
        for blk in model.encoder.blocks:
            torch.nn.init.normal_(blk.attn.rel_pos_h, std=0.05)
            torch.nn.init.normal_(blk.attn.rel_pos_w, std=0.05)
    return model


@torch.no_grad()
def set_probe_weights(model) -> None:
    """Overwrite the image skip path (`decoder0`) and the last stage of the
    nucleus and HV towers so that the forward maps follow the tile. With
    darkness d = ReLU(−red) after normalisation, the skip path carries the
    saturated nucleus mask m = ReLU(20·d) − ReLU(20·d − 1); the nucleus logit
    is 10·m − 5, and the HV maps are the signed x / y Sobel gradients of the
    box-blurred mask (negative on a nucleus's left/top edge, positive on its
    right/bottom edge, as HoVer-Net's targets). Every other weight keeps its
    random value: the towers' last stage reads only the image skip, and the
    random encoder feeds the tokens, the tissue logits and the type map."""

    def conv_bn(block, weight, bias=None):
        conv, bn = block.block[0], block.block[1]
        conv.weight.copy_(weight)
        conv.bias.zero_()
        bn.weight.fill_(1.0)
        bn.bias.zero_()
        if bias is not None:
            bn.bias.copy_(bias)
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0 - bn.eps)

    w = torch.zeros(32, 3, 3, 3)
    w[0, 0, 1, 1] = -1.0
    conv_bn(model.decoder0[0], w)
    w, b = torch.zeros(64, 32, 3, 3), torch.zeros(64)
    w[0, 0, 1, 1] = w[1, 0, 1, 1] = 20.0
    b[1] = -1.0
    conv_bn(model.decoder0[1], w, b)
    nb = model.nuclei_binary_map_decoder.decoder0_header
    w = torch.zeros(64, 128, 3, 3)
    w[0, 0, 1, 1], w[0, 1, 1, 1] = 1.0, -1.0
    conv_bn(nb[0], w)
    w = torch.zeros(64, 64, 3, 3)
    w[0, 0, 1, 1] = 1.0
    conv_bn(nb[1], w)
    nb[2].weight.zero_()
    nb[2].weight[1, 0] = 10.0
    nb[2].bias.zero_()
    nb[2].bias[1] = -5.0
    hv = model.hv_map_decoder.decoder0_header
    w = torch.zeros(64, 128, 3, 3)
    w[0, 0], w[0, 1] = 1.0 / 9.0, -1.0 / 9.0
    conv_bn(hv[0], w)
    gx = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]]) / 8.0
    w = torch.zeros(64, 64, 3, 3)
    w[0, 0], w[1, 0], w[2, 0], w[3, 0] = gx, -gx, gx.T, -gx.T
    conv_bn(hv[1], w)
    hv[2].weight.zero_()
    hv[2].weight[0, 0], hv[2].weight[0, 1] = -1.0, 1.0
    hv[2].weight[1, 2], hv[2].weight[1, 3] = -1.0, 1.0
    hv[2].bias.zero_()
