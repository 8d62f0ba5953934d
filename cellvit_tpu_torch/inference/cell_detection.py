"""Device stage of WSI cell detection (port of the device half of
`cellvit_tpu/inference/cell_detection.py:CellSegmentationInference`).

A batch of normalised tiles goes through the model's inference forward, the
HV → instance postprocessing, relabelling and per-instance statistics on the
device; `_fetch_device` copies instance maps, statistics and token maps to
the host. The host half of the pipeline (patch reader, contours, dedup,
GeoJSON, CLI) belongs to a later slice of the port.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from cellvit_tpu_torch import resolve_device
from cellvit_tpu_torch.models.checkpoint_io import load_checkpoint, load_state_dict_into
from cellvit_tpu_torch.models.fused import forward_maps
from cellvit_tpu_torch.ops.hv_postproc import instance_map_batch_maps
from cellvit_tpu_torch.ops.instance_stats import instance_stats_batch, relabel_consecutive

STAGES = ("forward", "postproc", "stats")


class CellSegmentationInference:
    """WSI cell segmentation inference, device stage.

    Args:
        model_path: a reference `.pth` training checkpoint; or
        model / state_dict / run_conf: a built model, optionally its weights,
            and its run config (normalisation, class counts).
        batch_size: tiles per batch of the host pipeline (a later slice); the
            device stage takes the batch it is given.
        mixed_precision: compute in bf16 under `torch.autocast` with the
            parameters kept in fp32 (the reference's AMP, and the JAX
            package's `model.clone(dtype=bfloat16)`).
        max_instances_per_tile: capacity of the per-instance statistics.
        device: "cuda" (default; raises without a GPU) or "cpu".
    """

    def __init__(
        self,
        model_path: Optional[Union[str, Path]] = None,
        model: Optional[torch.nn.Module] = None,
        state_dict: Optional[Mapping[str, Any]] = None,
        run_conf: Optional[Mapping[str, Any]] = None,
        batch_size: int = 8,
        mixed_precision: bool = False,
        max_instances_per_tile: int = 2048,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        self.device = resolve_device(device)
        if model_path is not None:
            model, _, run_conf = load_checkpoint(model_path)
        elif model is None:
            raise ValueError("provide model_path, or model (and optionally state_dict)")
        elif state_dict is not None:
            load_state_dict_into(model, state_dict)
        self.run_conf = dict(run_conf or {})
        self.batch_size = batch_size
        self.max_instances = max_instances_per_tile
        self.mixed_precision = mixed_precision
        #: the dtype of the input batch and of the model's compute
        self.dtype = torch.bfloat16 if mixed_precision else torch.float32
        self.model = model.to(device=self.device, dtype=torch.float32).eval()

        norm = (self.run_conf.get("transformations") or {}).get("normalize", {})
        self.mean = np.asarray(norm.get("mean", (0.5, 0.5, 0.5)), np.float32)
        self.std = np.asarray(norm.get("std", (0.5, 0.5, 0.5)), np.float32)
        data = self.run_conf.get("data") or {}
        self.num_nuclei_classes = data.get("num_nuclei_classes", model.num_nuclei_classes)
        #: per-tile watershed pass counts of the last dispatched batch
        self.last_watershed_passes: Optional[torch.Tensor] = None
        #: device ms per stage of the last fetched batch (CUDA only)
        self.last_stage_ms: Dict[str, float] = {}

    def check_wsi(self, wsi: Any, magnification: float = 40.0, patch_size: int = 1024,
                  overlap: int = 64) -> None:
        """Sanity checks of a preprocessed WSI's metadata (an object with a
        `metadata` mapping, or the mapping itself)."""
        meta = getattr(wsi, "metadata", wsi)
        if meta.get("magnification") is not None:
            patch_mag = float(meta["magnification"])
        else:
            patch_mag = float(meta["base_magnification"]) / float(meta["downsampling"])
        if patch_mag != float(magnification):
            raise RuntimeError(
                f"magnification mismatch: patches at {patch_mag}, requested {magnification}"
            )
        if int(meta["patch_size"]) != patch_size:
            raise RuntimeError(f"patch size must be {patch_size}")
        if int(meta["patch_overlap"]) != overlap:
            raise RuntimeError(f"patch overlap must be {overlap}")

    def autocast(self):
        """The mixed-precision context of the model's forward (off in fp32)."""
        return torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.mixed_precision)

    @torch.no_grad()
    def forward_maps(self, x: torch.Tensor, retrieve_tokens: bool = False) -> Dict:
        """`models.fused.forward_maps` of the model on NHWC `x` (normalised,
        in `self.dtype`) under `autocast()`."""
        with self.autocast():
            return forward_maps(self.model, x, retrieve_tokens=retrieve_tokens)

    def _event(self) -> Optional[torch.cuda.Event]:
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    @torch.no_grad()
    def _dispatch_device(self, imgs: np.ndarray, magnification: float) -> Tuple:
        """Queue the device stage for a (B, H, W, 3) [0, 1] batch without
        waiting for it: forward maps, instance maps and an argmax type map,
        relabelling and statistics."""
        x = torch.from_numpy(np.ascontiguousarray((imgs - self.mean) / self.std, np.float32))
        if self.device.type == "cuda":
            x = x.pin_memory()
        x = x.to(self.device, non_blocking=True).to(self.dtype)
        ksize, object_size = (21, 10) if magnification == 40 else (11, 3)
        events = [self._event()]
        out = self.forward_maps(x, retrieve_tokens=True)
        events.append(self._event())
        inst, passes = instance_map_batch_maps(
            out["np_prob"], out["hv0"], out["hv1"], object_size=object_size, ksize=ksize,
            return_passes=True,
        )
        # softmax is monotone per pixel: argmax over the raw logits
        type_map = out["type_map_cmajor"].argmax(dim=1).to(torch.int32)
        events.append(self._event())
        h, w = inst.shape[1], inst.shape[2]
        inst = relabel_consecutive(inst, h * w // 2 + 2)
        stats = instance_stats_batch(
            inst, type_map, out["np_prob"], max_instances=self.max_instances,
            num_classes=self.num_nuclei_classes,
        )
        events.append(self._event())
        self.last_watershed_passes = passes
        return inst, stats, out["tokens"], events

    def _fetch_device(self, handles: Tuple) -> Tuple[np.ndarray, Dict[str, np.ndarray], np.ndarray]:
        """Wait for a `_dispatch_device` result and copy it to the host."""
        inst, stats, tokens, events = handles
        inst_np = inst.cpu().numpy()
        stats_np = {k: v.cpu().numpy() for k, v in stats.items()}
        tokens_np = tokens.float().cpu().numpy()
        if events[0] is not None:
            torch.cuda.synchronize(self.device)
            self.last_stage_ms = {
                name: events[i].elapsed_time(events[i + 1]) for i, name in enumerate(STAGES)
            }
        return inst_np, stats_np, tokens_np

    def _device_outputs(self, imgs: np.ndarray, magnification: float):
        """Device stage: host copies of (instance maps (B, H, W), stats dict,
        token maps (B, Ht, Wt, E))."""
        return self._fetch_device(self._dispatch_device(imgs, magnification))
