"""WSI cell detection: tile stream → device forward+postproc → host
contours and assembly → dedup → cells.json / GeoJSON / cell graph (port of
`cellvit_tpu/inference/cell_detection.py`).

Reference `cell_segmentation/inference/cell_detection.py`
(CellSegmentationInference:92-598 + writers): a preprocessed WSI (1024²
patches, 64 px overlap) goes through the model; the HV → instance
postprocessing, relabelling and per-instance statistics run on the device
(`_dispatch_device`), and `_fetch_device` copies instance maps, statistics
and token maps to the host. There contours are traced (`ops/contours.py`,
cv2's contract without cv2), cells converted to global slide coordinates
with the reference's formula (:343-350), given margin codes 0-8 and edge
neighbour lists, deduplicated across tiles, and written as `cells.json`,
`cell_detection.json`, optional QuPath `.geojson` files and the `cells.pt`
token graph.
"""

from __future__ import annotations

import contextlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from cellvit_tpu_torch import resolve_device
from cellvit_tpu_torch.data.loader import DataLoader, SequentialSampler
from cellvit_tpu_torch.data.wsi import WSI, PatchedWSIInference
from cellvit_tpu_torch.inference import dedup as dd
from cellvit_tpu_torch.inference.geojson_export import TYPE_NUCLEI_DICT, convert_geojson
from cellvit_tpu_torch.models.checkpoint_io import load_checkpoint, load_state_dict_into
from cellvit_tpu_torch.models.fused import forward_maps
from cellvit_tpu_torch.ops.hv_postproc import instance_map_batch_maps
from cellvit_tpu_torch.ops.instance_stats import (
    contours_from_instance_map,
    instance_stats_batch,
    relabel_consecutive,
)
from cellvit_tpu_torch.utils.logger import Logger
from cellvit_tpu_torch.utils.tools import Timer, device_trace

STAGES = ("forward", "postproc", "stats")


def assemble_patch_instances(
    inst_map: np.ndarray, stats: Dict[str, np.ndarray]
) -> Dict[int, Dict]:
    """Host stage: contours + per-instance dicts for one patch. Each
    instance's contour is traced inside its device-statistics box."""
    contours = contours_from_instance_map(inst_map, bboxes=stats["bbox"])
    info: Dict[int, Dict] = {}
    for inst_id, contour in contours.items():
        k = inst_id - 1
        if k >= stats["valid"].shape[0] or not stats["valid"][k]:
            continue
        r0, r1, c0, c1 = stats["bbox"][k]
        info[inst_id] = {
            "bbox": np.array([[r0, c0], [r1, c1]]),
            "centroid": stats["centroid"][k],
            "contour": contour,
            "type_prob": float(stats["type_prob"][k]),
            "type": int(stats["type"][k]),
        }
    return info


def assemble_patch_cells(
    instances: Dict[int, Dict],
    tokens: np.ndarray,
    row: int,
    col: int,
    patch_size: int,
    overlap: int,
    scaling: float,
    token_patch: int,
) -> Tuple[List[Dict], List[Dict], List[np.ndarray], List[np.ndarray], List[np.ndarray]]:
    """Per-patch host assembly: instances → global-coordinate cell dicts
    (reference cell_detection.py:343-350 for the global offset).

    Returns (cells, detections, graph_tokens, graph_positions,
    graph_contours) for one patch; `tokens` is that patch's (Ht, Wt, E)
    token map.
    """
    cells: List[Dict] = []
    detections: List[Dict] = []
    g_tokens: List[np.ndarray] = []
    g_positions: List[np.ndarray] = []
    g_contours: List[np.ndarray] = []
    x_global = int(row * patch_size * scaling - (row + 0.5) * overlap)
    y_global = int(col * patch_size * scaling - (col + 0.5) * overlap)
    offset_global = np.array([x_global, y_global])
    for cell in instances.values():
        if cell["type"] == 0:
            continue
        centroid_global = cell["centroid"] + np.flip(offset_global)
        contour_global = cell["contour"] + np.flip(offset_global)
        bbox_global = cell["bbox"] + offset_global
        cell_dict = {
            "bbox": bbox_global.tolist(),
            "centroid": centroid_global.tolist(),
            "contour": contour_global.tolist(),
            "type_prob": cell["type_prob"],
            "type": cell["type"],
            "patch_coordinates": [row, col],
            "cell_status": dd.get_cell_position_margin(
                cell["bbox"], patch_size, overlap
            ),
            "offset_global": offset_global.tolist(),
        }
        if np.max(cell["bbox"]) == patch_size or np.min(cell["bbox"]) == 0:
            position = dd.get_cell_position(cell["bbox"], patch_size)
            cell_dict["edge_position"] = True
            cell_dict["edge_information"] = {
                "position": position,
                "edge_patches": dd.get_edge_patch(position, row, col),
            }
        else:
            cell_dict["edge_position"] = False
        cells.append(cell_dict)
        detections.append(
            {
                "bbox": bbox_global.tolist(),
                "centroid": centroid_global.tolist(),
                "type": cell["type"],
            }
        )
        # ViT-token crop mean over the cell bbox (reference :397-413)
        bb = cell["bbox"].astype(np.float64) / token_patch
        r0, c0 = np.floor(bb[0]).astype(int)
        r1, c1 = np.ceil(bb[1]).astype(int)
        crop = tokens[r0 : max(r1, r0 + 1), c0 : max(c1, c0 + 1)]
        g_tokens.append(crop.reshape(-1, crop.shape[-1]).mean(0))
        g_positions.append(centroid_global)
        g_contours.append(contour_global)
    return cells, detections, g_tokens, g_positions, g_contours


@dataclass
class CellGraphDataWSI:
    """Cell-token graph (reference datamodel/cell_graph_datamodel.py:18-26)."""

    x: object  # (N, E) tokens
    positions: object  # (N, 2)
    contours: List
    metadata: Dict = field(default_factory=dict)


class CellSegmentationInference:
    """WSI cell segmentation inference.

    Args:
        model_path: a reference `.pth` training checkpoint; or
        model / state_dict / run_conf: a built model, optionally its weights,
            and its run config (normalisation, class counts).
        run_dir: a training run directory (not ported yet).
        batch_size: tiles per batch of `process_wsi`; the device stage takes
            the batch it is given.
        mixed_precision: compute in bf16 under `torch.autocast` with the
            parameters kept in fp32 (the reference's AMP, and the JAX
            package's `model.clone(dtype=bfloat16)`).
        max_instances_per_tile: capacity of the per-instance statistics.
        mesh: tile batches sharded over devices (not ported yet).
        logger: a python logger (default: INFO to stdout).
        device: "cuda" (default; raises without a GPU), "cuda:N" or "cpu".
            The device stage makes it the current device while it runs. On
            CUDA the patch reader uses the compiled PNG unfilter (`native_png`).
    """

    def __init__(
        self,
        model_path: Optional[Union[str, Path]] = None,
        model: Optional[torch.nn.Module] = None,
        state_dict: Optional[Mapping[str, Any]] = None,
        run_conf: Optional[Mapping[str, Any]] = None,
        run_dir: Optional[Union[str, Path]] = None,
        batch_size: int = 8,
        mixed_precision: bool = False,
        max_instances_per_tile: int = 2048,
        mesh: Any = None,
        logger: Any = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        if run_dir is not None:
            raise NotImplementedError(
                "run_dir needs eval_pannuke.InferenceCellViT, which is not ported yet "
                "(ROADMAP A9); pass model_path (a reference .pth checkpoint) or model"
            )
        if mesh is not None:
            raise NotImplementedError("mesh needs parallel/, which is not ported yet (ROADMAP A11)")
        self.device = resolve_device(device)
        self.logger = logger or Logger(level="INFO").create_logger()
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
        #: `last_stage_ms` of each batch of the last `process_wsi` (CUDA only)
        self.batch_stage_ms: List[Dict[str, float]] = []
        #: decode patches with the compiled PNG unfilter (host C code)
        self.native_png = self.device.type == "cuda"

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

    def on_device(self):
        """A context that makes `self.device` the current CUDA device (a no-op
        on the CPU): the kernels launch on the current device, into the
        current stream of their tensors' device."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def autocast(self):
        """The mixed-precision context of the model's forward (off in fp32)."""
        return torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.mixed_precision)

    @torch.no_grad()
    def forward_maps(self, x: torch.Tensor, retrieve_tokens: bool = False) -> Dict:
        """`models.fused.forward_maps` of the model on NHWC `x` (normalised,
        in `self.dtype`) under `autocast()`."""
        with self.on_device(), self.autocast():
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
        with self.on_device():
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

    def _predict_batch(
        self, imgs: np.ndarray, magnification: float
    ) -> Tuple[List[Dict[int, Dict]], np.ndarray]:
        """Forward + device postproc for a (B, H, W, 3) [0, 1] batch.

        Returns per-patch instance dicts (bbox/centroid/contour/type/
        type_prob — reference `get_cell_predictions_with_tokens`,
        cell_detection.py:485-514) and the (B, Ht, Wt, E) token maps.
        """
        inst_np, stats, tokens = self._device_outputs(imgs, magnification)
        batch_instances = [
            assemble_patch_instances(inst_np[i], {k: v[i] for k, v in stats.items()})
            for i in range(inst_np.shape[0])
        ]
        return batch_instances, tokens

    def process_wsi(
        self,
        wsi: WSI,
        subdir_name: Optional[str] = None,
        patch_size: int = 1024,
        overlap: int = 64,
        geojson: bool = False,
        magnification: Optional[float] = None,
        profile_dir: Optional[Path] = None,
    ) -> Path:
        """Process one preprocessed WSI; returns the output directory.

        Per-stage wall timings (patch load / device forward+postproc / host
        assembly / dedup / serialization) are logged and written to
        `timings.json` in the output dir. `profile_dir` additionally records
        a torch.profiler trace of the detection loop (`utils.tools.device_trace`).
        """
        timer = Timer()
        self.logger.info(f"processing WSI {wsi.name}")
        if magnification is None:
            magnification = wsi.metadata.get("magnification") or 40
        dataset = PatchedWSIInference(wsi, native_png=self.native_png)
        loader = DataLoader(
            dataset,
            batch_size=self.batch_size,
            sampler=SequentialSampler(len(dataset)),
            num_workers=8,
            collate_fn=PatchedWSIInference.collate_batch,
        )
        nuclei_types = {"Background": 0}
        type_names = TYPE_NUCLEI_DICT
        nuclei_types.update({v: k for k, v in TYPE_NUCLEI_DICT.items()})

        cell_dict_wsi: List[Dict] = []
        cell_dict_detection: List[Dict] = []
        graph_tokens: List[np.ndarray] = []
        graph_positions: List[np.ndarray] = []
        graph_contours: List[np.ndarray] = []
        processed_patches: List[str] = []
        self.batch_stage_ms = []

        scaling = wsi.metadata["downsampling"]
        token_patch = self.model.patch_size

        def assemble(fetched, metadata):
            inst_np, stats, tokens = fetched
            for idx, patch_meta in enumerate(metadata):
                instances = assemble_patch_instances(
                    inst_np[idx], {k: v[idx] for k, v in stats.items()}
                )
                row, col = patch_meta["row"], patch_meta["col"]
                processed_patches.append(f"{row}_{col}")
                cells, dets, g_tok, g_pos, g_con = assemble_patch_cells(
                    instances, tokens[idx], row, col,
                    patch_size, overlap, scaling, token_patch,
                )
                cell_dict_wsi.extend(cells)
                cell_dict_detection.extend(dets)
                graph_tokens.extend(g_tok)
                graph_positions.extend(g_pos)
                graph_contours.extend(g_con)

        # One-step software pipeline: batch k+1 is queued on the device
        # (CUDA launches return before the work is done) before batch k is
        # fetched and assembled, so host contour tracing overlaps the
        # device's forward+postproc. `device_forward_postproc` times the
        # enqueue + the blocking fetch (the device time the host could not
        # hide); `host_assembly` is host work alone; `detection_loop` is the
        # wall clock of the whole pipelined loop.
        timer.start("detection_loop")
        with device_trace(str(profile_dir) if profile_dir else None):
            batches = iter(loader)
            pending = None
            while True:
                with timer.lap("patch_load"):
                    item = next(batches, None)
                if item is not None:
                    imgs, metadata = item
                    with timer.lap("device_forward_postproc"):
                        handles = self._dispatch_device(imgs, magnification)
                if pending is not None:
                    prev_handles, prev_meta = pending
                    with timer.lap("device_forward_postproc"):
                        fetched = self._fetch_device(prev_handles)
                    if self.last_stage_ms:
                        self.batch_stage_ms.append(dict(self.last_stage_ms))
                    with timer.lap("host_assembly"):
                        assemble(fetched, prev_meta)
                    pending = None
                if item is None:
                    break
                pending = (handles, metadata)
        timer.stop("detection_loop")

        self.logger.info(f"detected cells before cleaning: {len(cell_dict_wsi)}")
        timer.start("dedup")
        keep_idx = dd.CellPostProcessor(cell_dict_wsi, self.logger).post_process_cells()
        cell_dict_wsi = [cell_dict_wsi[i] for i in keep_idx]
        cell_dict_detection = [cell_dict_detection[i] for i in keep_idx]
        graph_tokens = [graph_tokens[i] for i in keep_idx]
        graph_positions = [graph_positions[i] for i in keep_idx]
        graph_contours = [graph_contours[i] for i in keep_idx]
        timer.stop("dedup")
        self.logger.info(f"detected cells after cleaning: {len(keep_idx)}")

        timer.start("serialize")
        outdir = wsi.patched_slide_path / "cell_detection"
        if subdir_name:
            outdir = outdir / subdir_name
        outdir.mkdir(parents=True, exist_ok=True)

        payload = {
            "wsi_metadata": wsi.metadata,
            "processed_patches": processed_patches,
            "type_map": nuclei_types,
            "cells": cell_dict_wsi,
        }
        (outdir / "cells.json").write_text(json.dumps(payload, indent=2))
        det_payload = dict(payload)
        det_payload["cells"] = cell_dict_detection
        (outdir / "cell_detection.json").write_text(json.dumps(det_payload, indent=2))
        if geojson:
            (outdir / "cells.geojson").write_text(
                json.dumps(convert_geojson(cell_dict_wsi, True, type_names), indent=2)
            )
            (outdir / "cell_detection.geojson").write_text(
                json.dumps(convert_geojson(cell_dict_wsi, False, type_names), indent=2)
            )

        graph = CellGraphDataWSI(
            x=torch.from_numpy(np.stack(graph_tokens)) if graph_tokens else torch.zeros((0, 1)),
            positions=torch.from_numpy(np.stack(graph_positions))
            if graph_positions
            else torch.zeros((0, 2)),
            contours=[torch.from_numpy(np.asarray(c)) for c in graph_contours],
            metadata={"wsi_metadata": wsi.metadata, "nuclei_types": nuclei_types},
        )
        torch.save(graph, outdir / "cells.pt")
        timer.stop("serialize")

        timings = {k: round(v, 4) for k, v in timer.summary().items()}
        n = max(len(processed_patches), 1)
        self.logger.info(
            "stage timings (s): "
            + ", ".join(f"{k}={v:.2f}" for k, v in timings.items())
            + f" | {timings.get('device_forward_postproc', 0.0) / n * 1e3:.1f}"
            " ms/patch device"
        )
        (outdir / "timings.json").write_text(
            json.dumps({"stages_s": timings, "n_patches": len(processed_patches)})
        )
        self.logger.info(f"results written to {outdir}")
        return outdir
