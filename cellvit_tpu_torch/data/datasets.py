"""Cell-segmentation datasets (PanNuke, CoNIC, MoNuSeg, CoNSeP).

Same on-disk contracts as the reference
(`cell_segmentation/datasets/`): PanNuke folds with `images/*.png`,
`labels/*.npy` ({inst_map, type_map}), `types.csv`, `cell_count.csv`,
and a top-level `weight_config.yaml` (pannuke.py:36-332); CoNIC folds with
`images.npy`/`labels.npy` + counts (conic.py:43-243); MoNuSeg/CoNSeP
test-only layouts. Samples are numpy dicts in channel-last layout, images
float32 in [0, 1]; normalization and augmentation happen in
`cellvit_tpu_torch.data.transforms`, batching in
`cellvit_tpu_torch.data.loader`.

Port of `cellvit_tpu/data/datasets.py`: the PNG images are decoded by
`data/png.py` (`native_png` picks its compiled unfilter) and
`weight_config.yaml` is read by `utils/yaml_lite.py`. The StarDist targets
(`stardist=True`) wait for that model's port and raise.
"""

from __future__ import annotations

import csv
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from cellvit_tpu_torch.data import labels as L
from cellvit_tpu_torch.data.png import decode_png
from cellvit_tpu_torch.utils import yaml_lite


def natsorted(items: Sequence) -> List:
    """Natural sort (numeric-aware), replacing the natsort dependency."""

    def key(s):
        return [
            int(t) if t.isdigit() else t.lower()
            for t in re.split(r"(\d+)", str(s))
        ]

    return sorted(items, key=key)


class CellDataset:
    """Base dataset API (reference base_cell.py:20-85)."""

    def __init__(self) -> None:
        self.transforms: Optional[Callable] = None

    def set_transforms(self, transforms: Callable) -> None:
        self.transforms = transforms

    def __len__(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def __getitem__(self, index: int):  # pragma: no cover - abstract
        raise NotImplementedError

    def load_cell_count(self) -> None:
        raise NotImplementedError

    def get_sampling_weights_tissue(self, gamma: float = 1) -> np.ndarray:
        raise NotImplementedError

    def get_sampling_weights_cell(self, gamma: float = 1) -> np.ndarray:
        """Per-image weights from the cell types present in it, each type
        weighted against its dataset-wide count (`BINARY_WEIGHT_FACTORS`)."""
        assert 0 <= gamma <= 1
        assert hasattr(self, "cell_count"), "call load_cell_count() first"
        factors = self.BINARY_WEIGHT_FACTORS.astype(np.float64)
        k = factors.sum()
        present = np.clip(self.cell_count, 0, 1)
        weight_vector = k / (gamma * factors + (1 - gamma) * k)
        img_weight = (1 - gamma) * present.max(axis=-1) + gamma * np.sum(
            present * weight_vector, axis=-1
        )
        nonzero = img_weight[np.nonzero(img_weight)]
        if nonzero.size:
            img_weight[img_weight == 0] = nonzero.min()
        return img_weight

    def get_sampling_weights_cell_tissue(self, gamma: float = 1) -> np.ndarray:
        tw = self.get_sampling_weights_tissue(gamma)
        cw = self.get_sampling_weights_cell(gamma)
        return tw / tw.max() + cw / cw.max()


def _unit_float(img: np.ndarray) -> np.ndarray:
    """The transformed image as float32, scaled to [0, 1] when it is still on
    the [0, 255] scale. The scale is told by dtype, not value: a uint8 image
    (no transforms, or transforms without normalize) always needs /255, and
    a near-black patch with max < 5 must not slip through at 255 scale.
    Float outputs of normalize stay below 5 for any std >= 0.2."""
    was_uint8 = np.asarray(img).dtype == np.uint8
    img = np.asarray(img, np.float32)
    if was_uint8 or img.max() >= 5:
        img = img / 255.0
    return img


def _build_masks(
    inst_map: np.ndarray,
    type_map: np.ndarray,
    stardist: bool,
    regression: bool,
) -> Dict[str, np.ndarray]:
    np_map = (inst_map > 0).astype(np.int64)
    masks = {
        "instance_map": inst_map.astype(np.int64),
        "nuclei_type_map": type_map.astype(np.int64),
        "nuclei_binary_map": np_map,
        "hv_map": L.gen_instance_hv_map(inst_map),  # (H, W, 2)
    }
    if stardist:
        raise NotImplementedError("the StarDist targets are not ported yet")
    if regression:
        masks["regression_map"] = L.gen_regression_map(inst_map)  # (H, W, 2)
    return masks


class PanNukeDataset(CellDataset):
    """PanNuke fold dataset (reference pannuke.py:36-332).

    Returns (image (H, W, 3) float32 in [0, 1] pre-normalization,
    masks dict, tissue_type str, image name str).
    """

    # PanNuke-wide binary cell-count factors (pannuke.py:300)
    BINARY_WEIGHT_FACTORS = np.array([4191, 4132, 6140, 232, 1528])

    def __init__(
        self,
        dataset_path: Union[Path, str],
        folds: Union[int, Sequence[int]],
        transforms: Optional[Callable] = None,
        stardist: bool = False,
        regression: bool = False,
        cache_dataset: bool = False,
        native_png: bool = False,
    ) -> None:
        super().__init__()
        if isinstance(folds, int):
            folds = [folds]
        if stardist:
            raise NotImplementedError("the StarDist targets are not ported yet")
        self.dataset = Path(dataset_path).resolve()
        self.folds = list(folds)
        self.transforms = transforms
        self.stardist = stardist
        self.regression = regression
        self.cache_dataset = cache_dataset
        self.native_png = native_png
        self._cache: Dict[int, tuple] = {}

        self.images: List[Path] = []
        self.masks: List[Path] = []
        self.img_names: List[str] = []
        self.types: Dict[str, str] = {}
        for fold in self.folds:
            image_path = self.dataset / f"fold{fold}" / "images"
            for img in natsorted(image_path.glob("*.png")):
                mask_path = self.dataset / f"fold{fold}" / "labels" / f"{img.stem}.npy"
                if mask_path.is_file():
                    self.images.append(img)
                    self.masks.append(mask_path)
                    self.img_names.append(img.name)
            with open(self.dataset / f"fold{fold}" / "types.csv") as f:
                for row in csv.DictReader(f):
                    self.types[row["img"]] = row["type"]

    def __len__(self) -> int:
        return len(self.images)

    def load_imgfile(self, index: int) -> np.ndarray:
        return decode_png(self.images[index].read_bytes(), native=self.native_png)

    def load_maskfile(self, index: int) -> np.ndarray:
        mask = np.load(self.masks[index], allow_pickle=True)
        inst_map = mask[()]["inst_map"].astype(np.int32)
        type_map = mask[()]["type_map"].astype(np.int32)
        return np.stack([inst_map, type_map], axis=-1)

    def __getitem__(self, index: int):
        if self.cache_dataset and index in self._cache:
            img, mask = self._cache[index]
        else:
            img = self.load_imgfile(index)
            mask = self.load_maskfile(index)
            if self.cache_dataset:
                self._cache[index] = (img, mask)

        if self.transforms is not None:
            img, mask = self.transforms(img, mask)

        inst_map = mask[..., 0].copy()
        type_map = mask[..., 1].copy()
        img = _unit_float(img)
        masks = _build_masks(inst_map, type_map, self.stardist, self.regression)
        tissue_type = self.types[self.img_names[index]]
        return img, masks, tissue_type, self.img_names[index]

    # -- weighted sampling (pannuke.py:252-332) --

    def load_cell_count(self) -> None:
        rows: Dict[str, np.ndarray] = {}
        columns: List[str] = []
        for fold in self.folds:
            with open(self.dataset / f"fold{fold}" / "cell_count.csv") as f:
                reader = csv.reader(f)
                header = next(reader)
                columns = header[1:]
                for row in reader:
                    rows[row[0]] = np.array([float(v) for v in row[1:]])
        self.cell_count = np.stack([rows[name] for name in self.img_names])
        self.cell_count_columns = columns

    def get_sampling_weights_tissue(self, gamma: float = 1) -> np.ndarray:
        assert 0 <= gamma <= 1
        text = (self.dataset / "weight_config.yaml").read_text()
        tissue_counts = yaml_lite.load(text)["tissue"]
        k = float(np.sum(list(tissue_counts.values())))
        weights_dict = {
            t: k / (gamma * c + (1 - gamma) * k) for t, c in tissue_counts.items()
        }
        return np.array(
            [weights_dict[self.types[name]] for name in self.img_names], np.float64
        )


class CoNicDataset(CellDataset):
    """CoNIC fold dataset, fully RAM-preloaded (reference conic.py:43-243).

    Layout: `fold{i}/images.npy` (N, H, W, 3 uint8), `fold{i}/labels.npy`
    (N, H, W, 2: inst, type), `fold{i}/types.csv`, optional counts.
    """

    BINARY_WEIGHT_FACTORS = np.array([4012, 222017, 93612, 77403, 98783, 48157])

    def __init__(
        self,
        dataset_path: Union[Path, str],
        folds: Union[int, Sequence[int]],
        transforms: Optional[Callable] = None,
        stardist: bool = False,
        regression: bool = False,
        **kwargs,
    ) -> None:
        super().__init__()
        if isinstance(folds, int):
            folds = [folds]
        if stardist:
            raise NotImplementedError("the StarDist targets are not ported yet")
        self.dataset = Path(dataset_path).resolve()
        self.folds = list(folds)
        self.transforms = transforms
        self.stardist = stardist
        self.regression = regression

        imgs, lbls, names, types = [], [], [], {}
        for fold in self.folds:
            fold_dir = self.dataset / f"fold{fold}"
            imgs.append(np.load(fold_dir / "images.npy"))
            lbls.append(np.load(fold_dir / "labels.npy"))
            with open(fold_dir / "types.csv") as f:
                for row in csv.DictReader(f):
                    types[row["img"]] = row["type"]
            n = imgs[-1].shape[0]
            names.extend([f"{fold}_{i}.png" for i in range(n)])
        self.images = np.concatenate(imgs)
        self.labels = np.concatenate(lbls)
        self.img_names = names
        self.types = types

    def __len__(self) -> int:
        return self.images.shape[0]

    def __getitem__(self, index: int):
        img = self.images[index].astype(np.uint8)
        mask = self.labels[index].astype(np.int32)
        if self.transforms is not None:
            img, mask = self.transforms(img, mask)
        img = _unit_float(img)
        masks = _build_masks(
            mask[..., 0].copy(), mask[..., 1].copy(), self.stardist, self.regression
        )
        name = self.img_names[index]
        return img, masks, self.types.get(name, "colon"), name

    def load_cell_count(self) -> None:
        counts = []
        for fold in self.folds:
            counts.append(np.load(self.dataset / f"fold{fold}" / "cell_count.npy"))
        self.cell_count = np.concatenate(counts)


class MoNuSegDataset(CellDataset):
    """MoNuSeg test dataset (reference monuseg.py:27-128): whole 1024²
    images (`images/*.png` + `labels/*.npy` inst/type maps), optionally cut
    into 256² patches with 64-px overlap."""

    def __init__(
        self,
        dataset_path: Union[Path, str],
        transforms: Optional[Callable] = None,
        patching: bool = False,
        overlap: int = 64,
        patch_size: int = 256,
        native_png: bool = False,
    ) -> None:
        super().__init__()
        self.native_png = native_png
        self.dataset = Path(dataset_path).resolve()
        self.transforms = transforms
        self.patching = patching
        self.overlap = overlap
        self.patch_size = patch_size
        self.images = natsorted((self.dataset / "images").glob("*.png"))
        self.masks = [
            self.dataset / "labels" / f"{p.stem}.npy" for p in self.images
        ]

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, index: int):
        img = decode_png(self.images[index].read_bytes(), native=self.native_png)
        mask = np.load(self.masks[index], allow_pickle=True)
        if isinstance(mask.reshape(-1)[0], dict) or mask.dtype == object:
            m = mask[()]
            inst_map = m["inst_map"].astype(np.int32)
            type_map = m.get("type_map", (inst_map > 0).astype(np.int32))
            mask = np.stack([inst_map, type_map], axis=-1)
        if self.transforms is not None:
            img, mask = self.transforms(img, mask)
        img = _unit_float(img)
        name = self.images[index].name
        if self.patching:
            img = self._patch(img)
            mask = self._patch(mask)
        return img, mask, name

    def _patch(self, arr: np.ndarray) -> np.ndarray:
        """Cut (H, W, C) into overlapping (N, p, p, C) patches."""
        p, ov = self.patch_size, self.overlap
        stride = p - ov
        h, w = arr.shape[:2]
        tiles = []
        for y in range(0, h - p + 1, stride):
            for x in range(0, w - p + 1, stride):
                tiles.append(arr[y : y + p, x : x + p])
        return np.stack(tiles)


class CoNSePDataset(MoNuSegDataset):
    """CoNSeP test dataset (reference consep.py:26-118) — same layout."""


def select_dataset(
    dataset_name: str,
    split: str,
    dataset_config: dict,
    transforms: Optional[Callable] = None,
    stardist: bool = False,
    regression: bool = False,
    native_png: bool = False,
) -> CellDataset:
    """Dataset factory (reference dataset_coordinator.py:16-73)."""
    if split not in ("train", "val", "validation", "test"):
        raise ValueError(f"unknown split {split}")
    key = "train_folds" if split == "train" else (
        "val_folds" if split in ("val", "validation") else "test_folds"
    )
    folds = dataset_config[key]
    path = dataset_config["dataset_path"]
    name = dataset_name.lower()
    if name == "pannuke":
        return PanNukeDataset(
            path, folds, transforms=transforms, stardist=stardist,
            regression=regression, native_png=native_png,
        )
    if name == "conic":
        return CoNicDataset(
            path, folds, transforms=transforms, stardist=stardist,
            regression=regression,
        )
    raise NotImplementedError(f"unknown dataset {dataset_name}")
