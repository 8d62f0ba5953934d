"""WSI datamodel + patched-WSI inference dataset (port of
`cellvit_tpu/data/wsi.py`).

Same on-disk contracts as the reference (`datamodel/wsi_datamodel.py:21-193`
and `preprocessing/encoding/datasets/patched_wsi_inference.py:15-87`):
a preprocessed slide directory holds `metadata.yaml`, `patch_metadata.json`
(list of {patch_name: {row, col, …}}) and `patches/*.png`. The metadata is
read by `utils/yaml_lite.py` and the patches by `data/png.py`. The inference
dataset yields (image float32 HWC in [0, 1], patch metadata) and collates to
NHWC numpy batches for the device.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from cellvit_tpu_torch.data.png import decode_png
from cellvit_tpu_torch.utils import yaml_lite


@dataclass
class WSI:
    name: str
    patient: str
    slide_path: Union[str, Path]
    patched_slide_path: Optional[Union[str, Path]] = None
    embedding_name: Optional[str] = None
    label: Optional[object] = None

    metadata: Dict = field(init=False, repr=False, default=None)
    all_patch_metadata: Dict = field(init=False, repr=False, default=None)
    patches_list: List[str] = field(init=False, repr=False, default=None)

    def __post_init__(self) -> None:
        self.slide_path = Path(self.slide_path)
        if self.patched_slide_path is not None:
            self.patched_slide_path = Path(self.patched_slide_path).resolve()
            self.metadata = yaml_lite.load(
                (self.patched_slide_path / "metadata.yaml").read_text()
            )
            self.metadata["label_map_inverse"] = {
                v: k for k, v in self.metadata["label_map"].items()
            }
            with open(self.patched_slide_path / "patch_metadata.json") as f:
                entries = json.load(f)
            self.patches_list = [next(iter(e.keys())) for e in entries]
            self.all_patch_metadata = {
                next(iter(e.keys())): e[next(iter(e.keys()))] for e in entries
            }

    def get_number_patches(self) -> int:
        return len(self.patches_list)

    def load_patch_metadata(self, patch_name: str) -> Dict:
        meta = dict(self.all_patch_metadata[patch_name])
        meta["name"] = patch_name
        return meta

    def load_embedding(self):
        """Load a precomputed WSI embedding from embeddings/<name>.pt
        (reference wsi_datamodel.py:173-193)."""
        import torch

        path = self.patched_slide_path / "embeddings" / f"{self.embedding_name}.pt"
        if not path.is_file():
            raise FileNotFoundError(f"embedding not found: {path}")
        return torch.load(path)

    def process_patch_image(self, patch_name: str, native: bool = False) -> Tuple[np.ndarray, Dict]:
        """(patch uint8 HWC, metadata); `native` picks the compiled PNG
        unfilter (`data/png.py`)."""
        data = (self.patched_slide_path / "patches" / patch_name).read_bytes()
        return decode_png(data, native=native), self.load_patch_metadata(patch_name)


class PatchedWSIInference:
    """Dataset over one preprocessed WSI's patches
    (reference patched_wsi_inference.py:15-87). `native_png` picks the
    compiled PNG unfilter."""

    def __init__(
        self,
        wsi_object: WSI,
        transform: Optional[Callable] = None,
        native_png: bool = False,
    ) -> None:
        if wsi_object.patched_slide_path is None:
            raise ValueError("the WSI has no patched_slide_path")
        self.wsi_object = wsi_object
        self.transform = transform
        self.native_png = native_png

    def __len__(self) -> int:
        return self.wsi_object.get_number_patches()

    def __getitem__(self, index: int) -> Tuple[np.ndarray, Dict]:
        name = self.wsi_object.patches_list[index]
        patch, metadata = self.wsi_object.process_patch_image(name, self.native_png)
        img = patch.astype(np.float32) / 255.0
        if self.transform is not None:
            img = self.transform(img)
        return img, metadata

    @staticmethod
    def collate_batch(samples: List[Tuple[np.ndarray, Dict]]):
        imgs = np.stack([s[0] for s in samples]).astype(np.float32)
        metadata = [s[1] for s in samples]
        return imgs, metadata
