"""PanNuke patch evaluation of a training run (port of the HV family of
`cellvit_tpu/inference/eval_pannuke.py`; reference
`inference/inference_cellvit_experiment_pannuke.py:222-1009`).

Runs test-fold patch inference and computes the PanNuke metric suite:
per-image binary dice/jaccard, bPQ/bDQ/bSQ, per-type mPQ/mDQ/mSQ, tissue
accuracy, and detection F1/precision/recall from globally-paired centroids
(radius 12 at 40×, 6 at 20×), plus per-tissue and per-nucleus-type tables.
`inference_results.json` has the JAX package's (the reference's) keys.

The model is rebuilt from the run's `config.yaml` and loaded from its `.pth`;
the forward is the fused inference forward (`models/fused.forward_maps`),
under bf16 autocast when the run trained in mixed precision, and the
instance maps come from `ops/hv_postproc.instance_map_batch_maps` (B2-B4 on
the card). PQ pairing and the tables run on the host over the int32 label
maps. Runs on the card unless `device="cpu"`. The StarDist and CPP
families and the golden-metric diff (`--reference-log`) wait for their port
and raise.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from cellvit_tpu_torch import resolve_device
from cellvit_tpu_torch.data.datasets import PanNukeDataset
from cellvit_tpu_torch.data.loader import DataLoader, SequentialSampler
from cellvit_tpu_torch.data.transforms import build_transforms
from cellvit_tpu_torch.eval import metrics as M
from cellvit_tpu_torch.models.checkpoint_io import load_state_dict_into
from cellvit_tpu_torch.models.fused import forward_maps
from cellvit_tpu_torch.ops.hv_postproc import instance_map_batch_maps
from cellvit_tpu_torch.utils import yaml_lite
from cellvit_tpu_torch.utils.logger import Logger


def _per_instance_types(inst: np.ndarray, type_map: np.ndarray) -> Dict[int, Dict]:
    """Majority-vote type + centroid per instance."""
    out: Dict[int, Dict] = {}
    for i in np.unique(inst):
        if i == 0:
            continue
        sel = inst == i
        ys, xs = np.nonzero(sel)
        vals, counts = np.unique(type_map[sel], return_counts=True)
        order = np.argsort(-counts, kind="stable")
        t = vals[order][0]
        if t == 0 and len(vals) > 1:
            t = vals[order][1]
        out[int(i)] = {"centroid": np.array([xs.mean(), ys.mean()]), "type": int(t)}
    return out


class InferenceCellViT:
    """Patch-inference evaluator over a training run directory."""

    model_family = "hv"

    def __init__(
        self,
        run_dir: Union[str, Path],
        checkpoint_name: str = "latest_checkpoint",
        magnification: int = 40,
        batch_size: int = 32,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        self.run_dir = Path(run_dir)
        self.checkpoint_name = checkpoint_name
        self.magnification = magnification
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.logger = Logger(level="INFO", log_dir=self.run_dir, comment="inference").create_logger()

        self.run_conf = yaml_lite.load((self.run_dir / "config.yaml").read_text())
        dataset_path = Path(self.run_conf["data"]["dataset_path"])
        self.dataset_config = yaml_lite.load((dataset_path / "dataset_config.yaml").read_text())
        self.num_classes = self.run_conf["data"]["num_nuclei_classes"]
        self.mixed_precision = bool(self.run_conf.get("training", {}).get("mixed_precision", False))
        #: the first batch's device maps and instance maps of the last run
        self.first_batch: Dict[str, torch.Tensor] = {}
        self._build_model()

    def _build_model(self) -> None:
        from cellvit_tpu_torch.train.experiment import ExperimentCellVitPanNuke

        exp = ExperimentCellVitPanNuke.__new__(ExperimentCellVitPanNuke)
        exp.run_conf = self.run_conf
        exp.dataset_config = self.dataset_config
        self.model = exp.get_train_model()
        name = self.checkpoint_name
        path = self.run_dir / "checkpoints" / (name if name.endswith(".pth") else f"{name}.pth")
        ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
        load_state_dict_into(self.model, ckpt["model_state_dict"])
        self.model.to(self.device).eval()

    # --------------------------------------------------------------- data

    def setup_patch_inference(self) -> DataLoader:
        data = self.run_conf["data"]
        folds = data.get("test_folds") or data.get("val_folds")
        _, val_tf = build_transforms(self.run_conf.get("transformations", {}),
                                     input_shape=data.get("input_shape", 256))
        ds = PanNukeDataset(data["dataset_path"], folds=folds, transforms=val_tf,
                            native_png=self.device.type == "cuda")
        return DataLoader(ds, batch_size=self.batch_size, sampler=SequentialSampler(len(ds)),
                          num_workers=8)

    # ------------------------------------------------------------ device

    def _device_batch(self, images: np.ndarray, *, object_size: int, ksize: int):
        """Forward + HV postprocessing of one batch on the device: (instance
        maps, type argmax, binary argmax, tissue argmax), host arrays."""
        x = torch.as_tensor(np.ascontiguousarray(images)).to(self.device)
        with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.mixed_precision):
            out = forward_maps(self.model, x)
        np_prob, hv0, hv1 = out["np_prob"], out["hv0"], out["hv1"]
        inst = instance_map_batch_maps(np_prob, hv0, hv1, object_size=object_size, ksize=ksize)
        if not self.first_batch:
            self.first_batch = {"np_prob": np_prob, "hv0": hv0, "hv1": hv1, "inst": inst}
        return (inst.cpu().numpy(), out["type_map_cmajor"].argmax(1).cpu().numpy(),
                (np_prob > 0.5).cpu().numpy().astype(np.int64),
                out["tissue_types"].argmax(-1).cpu().numpy())

    # --------------------------------------------------------------- run

    @torch.no_grad()
    def run_patch_inference(self, loader: Optional[DataLoader] = None) -> Dict:
        loader = loader or self.setup_patch_inference()
        tissue_map = self.dataset_config["tissue_types"]
        ksize, object_size = (21, 10) if self.magnification == 40 else (11, 3)

        binary_dice, binary_jacc = [], []
        img_names: List[str] = []
        pq_s, dq_s, sq_s = [], [], []
        type_pq, type_dq, type_sq = [], [], []
        tissue_pred_all, tissue_gt_all, tissue_str = [], [], []
        paired_types: List[Tuple[int, int]] = []
        unpaired_true_types: List[int] = []
        unpaired_pred_types: List[int] = []
        radius = 12 if self.magnification == 40 else 6
        self.first_batch = {}

        for raw in loader:
            inst_np, nt_argmax, np_argmax, tt_pred = self._device_batch(
                raw["image"], object_size=object_size, ksize=ksize)

            batch_names = raw.get("names") or [
                f"img_{len(img_names) + i}" for i in range(inst_np.shape[0])
            ]
            img_names.extend(batch_names)
            gt_inst = raw["masks/instance_map"].astype(np.int32)
            gt_type = raw["masks/nuclei_type_map"].astype(np.int32)
            gt_bin = raw["masks/nuclei_binary_map"].astype(np.int32)
            tissue_gt = np.array([tissue_map[t] for t in raw["tissue_types"]])

            for i in range(inst_np.shape[0]):
                pred_bin = np_argmax[i]
                inter = ((pred_bin == 1) & (gt_bin[i] == 1)).sum()
                p_n, g_n = (pred_bin == 1).sum(), (gt_bin[i] == 1).sum()
                binary_dice.append(float(2 * inter / (p_n + g_n)) if (p_n + g_n) else np.nan)
                union = p_n + g_n - inter
                binary_jacc.append(float(inter / union) if union else np.nan)

                pred_types_of_inst = _per_instance_types(inst_np[i], nt_argmax[i])
                gt_types_of_inst = _per_instance_types(gt_inst[i], gt_type[i])

                # binary PQ (nan when GT empty — reference :846-856)
                if len(np.unique(gt_inst[i])) == 1:
                    dq = sq = pq = np.nan
                else:
                    [dq, sq, pq], _ = M.get_fast_pq(M.remap_label(gt_inst[i]),
                                                    M.remap_label(inst_np[i]))
                pq_s.append(pq), dq_s.append(dq), sq_s.append(sq)

                # per-class PQ over type-restricted instance maps
                t_pq, t_dq, t_sq = [], [], []
                for j in range(self.num_classes):
                    pred_j = np.where(
                        np.isin(inst_np[i],
                                [k for k, v in pred_types_of_inst.items() if v["type"] == j]),
                        inst_np[i], 0)
                    gt_j = np.where(gt_type[i] == j, gt_inst[i], 0)
                    if len(np.unique(gt_j)) == 1:
                        vals = (np.nan, np.nan, np.nan)
                    else:
                        [d_, s_, p_], _ = M.get_fast_pq(M.remap_label(gt_j), M.remap_label(pred_j))
                        vals = (d_, s_, p_)
                    t_dq.append(vals[0]), t_sq.append(vals[1]), t_pq.append(vals[2])
                type_pq.append(t_pq), type_dq.append(t_dq), type_sq.append(t_sq)

                # detection pairing
                tc = (np.array([v["centroid"] for v in gt_types_of_inst.values()])
                      if gt_types_of_inst else np.array([[0, 0]]))
                tt = (np.array([v["type"] for v in gt_types_of_inst.values()])
                      if gt_types_of_inst else np.array([0]))
                pc = (np.array([v["centroid"] for v in pred_types_of_inst.values()])
                      if pred_types_of_inst else np.array([[0, 0]]))
                pt = (np.array([v["type"] for v in pred_types_of_inst.values()])
                      if pred_types_of_inst else np.array([0]))
                paired, unp_t, unp_p = M.pair_coordinates(tc, pc, radius)
                for a, b in paired:
                    paired_types.append((int(tt[a]), int(pt[b])))
                unpaired_true_types.extend(tt[unp_t].tolist())
                unpaired_pred_types.extend(pt[unp_p].tolist())

            tissue_pred_all.extend(tt_pred.tolist())
            tissue_gt_all.extend(tissue_gt.tolist())
            tissue_str.extend([t.lower() for t in raw["tissue_types"]])

        # ------------------------------------------------- aggregation
        paired_true_t = np.array([a for a, _ in paired_types])
        paired_pred_t = np.array([b for _, b in paired_types])
        unp_true_t = np.array(unpaired_true_types)
        unp_pred_t = np.array(unpaired_pred_types)
        f1_d, prec_d, rec_d = M.cell_detection_scores(paired_true_t, paired_pred_t,
                                                      unp_true_t, unp_pred_t)
        tissue_acc = float(np.mean(np.array(tissue_pred_all) == np.array(tissue_gt_all)))
        binary_dice = np.array(binary_dice)
        binary_jacc = np.array(binary_jacc)
        pq_arr = np.array(pq_s)

        dataset_metrics = {
            "Binary-Cell-Dice-Mean": float(np.nanmean(binary_dice)),
            "Binary-Cell-Jacard-Mean": float(np.nanmean(binary_jacc)),
            "Tissue-Multiclass-Accuracy": tissue_acc,
            "bPQ": float(np.nanmean(pq_arr)),
            "bDQ": float(np.nanmean(dq_s)),
            "bSQ": float(np.nanmean(sq_s)),
            "mPQ": float(np.nanmean([np.nanmean(p[1:]) for p in type_pq])),
            "mDQ": float(np.nanmean([np.nanmean(p[1:]) for p in type_dq])),
            "mSQ": float(np.nanmean([np.nanmean(p[1:]) for p in type_sq])),
            "f1_detection": float(f1_d),
            "precision_detection": float(prec_d),
            "recall_detection": float(rec_d),
        }

        tissue_metrics = {}
        tissue_arr = np.asarray(tissue_str)
        for tissue in self.dataset_config["tissue_types"]:
            sel = tissue_arr == tissue.lower()
            if not sel.any():
                continue
            tissue_metrics[tissue.lower()] = {
                "Dice": float(np.nanmean(binary_dice[sel])),
                "Jaccard": float(np.nanmean(binary_jacc[sel])),
                "bPQ": float(np.nanmean(pq_arr[sel])),
                "mPQ": float(np.nanmean([np.nanmean(p[1:]) for p, s in zip(type_pq, sel) if s])),
            }

        nuclei_metrics = {}
        for name, j in self.dataset_config["nuclei_types"].items():
            if j == 0:
                continue
            scores = np.array([p[j] for p in type_pq])
            f1, prec, rec = M.cell_type_detection_scores(paired_true_t, paired_pred_t,
                                                         unp_true_t, unp_pred_t, j)
            nuclei_metrics[name] = {"PQ": float(np.nanmean(scores)), "f1": float(f1),
                                    "precision": float(prec), "recall": float(rec)}

        # per-image table; repeated names (several folds) get a #n suffix
        seen_names: Dict[str, int] = {}
        image_metrics = {}
        for i, name in enumerate(img_names):
            if not name:
                name = f"img_{i}"
            n_prev = seen_names.get(name, 0)
            seen_names[name] = n_prev + 1
            key = name if n_prev == 0 else f"{name}#{n_prev}"
            image_metrics[key] = {"Dice": float(binary_dice[i]), "Jaccard": float(binary_jacc[i]),
                                  "bPQ": float(pq_arr[i])}

        results = {
            "dataset": dataset_metrics,
            "tissue_metrics": tissue_metrics,
            "image_metrics": image_metrics,
            "nuclei_metrics_pq": {k: v["PQ"] for k, v in nuclei_metrics.items()},
            "nuclei_metrics_d": {
                k: {"f1_cell": v["f1"], "prec_cell": v["precision"], "rec_cell": v["recall"]}
                for k, v in nuclei_metrics.items()
            },
        }
        out_path = self.run_dir / "inference_results.json"
        out_path.write_text(json.dumps(results, indent=2))
        self.logger.info(f"wrote {out_path}")
        self.logger.info(json.dumps(dataset_metrics, indent=2))
        return results


def main(argv: Optional[List[str]] = None) -> Dict:
    """CLI of the reference's `InferenceCellViTParser`
    (inference_cellvit_experiment_pannuke.py:1206-1243). Returns the results."""
    import argparse

    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description="CellViT PanNuke patch inference for a run directory",
    )
    parser.add_argument("--run_dir", type=str, required=True,
                        help="Logging directory of a training run")
    parser.add_argument("--checkpoint_name", type=str, default="latest_checkpoint",
                        help="Checkpoint name inside run_dir/checkpoints (.pth optional)")
    parser.add_argument("--gpu", type=int, default=0, help="CUDA device index (with --device cuda)")
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                        help="run on the GPU or on the CPU")
    parser.add_argument("--magnification", type=int, choices=(20, 40), default=40)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--family", type=str, choices=("hv", "stardist", "cpp"), default="hv",
                        help="Decoder family of the run")
    parser.add_argument("--reference-log", type=str, default=None,
                        help="Reference logs_paper results to diff against (not ported yet)")
    args = parser.parse_args(argv)
    if args.family != "hv":
        raise NotImplementedError(f"the {args.family} evaluator is not ported yet")
    if args.reference_log is not None:
        raise NotImplementedError("the golden-metric diff is not ported yet")
    device = torch.device(f"cuda:{args.gpu}" if args.device == "cuda" else "cpu")
    inf = InferenceCellViT(args.run_dir, checkpoint_name=args.checkpoint_name,
                           magnification=args.magnification, batch_size=args.batch_size,
                           device=device)
    if device.type == "cuda":
        with torch.cuda.device(device):
            return inf.run_patch_inference()
    return inf.run_patch_inference()


if __name__ == "__main__":
    main()
