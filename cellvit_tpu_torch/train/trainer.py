"""CellViT trainer for the HoVer-Net branch models (port of
`cellvit_tpu/train/trainer.py`).

One step is a train-mode forward (BatchNorm on batch statistics, dropout and
drop-path from the trainer's generator), the weighted multi-branch loss
(reference `trainer_cellvit.py:610-655`), a backward through autograd (the
flash attention's backward is B8 on the card) and an update by an optax-style
`train.optim` transform over the fp32 master weights. With the encoder frozen
(`unfreeze_epoch`, reference `trainer_cellvit.py:133-135`) the encoder runs
without autograd except its tissue head, as the JAX package differentiates
only the trainable subtree; frozen parameters still pass zero gradients
through the optimizer, whose step count is global, and their updates are
masked. Mixed precision is `torch.autocast(bfloat16)` around the forward.
Validation computes dice/jaccard/tissue accuracy on the device and bPQ
through the port's HV postprocessing (B2-B4 on the card) and the host PQ
pairing; with `log_images` it writes one example panel
(`utils/plotting.py`) under `log_dir/examples/`. `train_epoch` keeps, in
`loader_wait_s`, the seconds each step waited for its batch from the
loader (the host's augmentations and targets).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from cellvit_tpu_torch import resolve_device
from cellvit_tpu_torch.eval import metrics as M
from cellvit_tpu_torch.models.layers import use_generator
from cellvit_tpu_torch.ops.hv_postproc import instance_map_batch
from cellvit_tpu_torch.train.early_stopping import EarlyStopping
from cellvit_tpu_torch.train.losses import retrieve_loss_fn
from cellvit_tpu_torch.train.optim import Transform, masked, multi_steps
from cellvit_tpu_torch.utils.logger import AverageMeter, MetricLogger


def prepare_batch(batch: Dict, tissue_map: Dict[str, int]) -> Dict[str, np.ndarray]:
    """Loader batch → numeric dict (tissue strings → ids)."""
    out = {
        "image": batch["image"],
        "nuclei_binary_map": batch["masks/nuclei_binary_map"].astype(np.int32),
        "nuclei_type_map": batch["masks/nuclei_type_map"].astype(np.int32),
        "hv_map": batch["masks/hv_map"].astype(np.float32),
        "instance_map": batch["masks/instance_map"].astype(np.int32),
        "tissue_types": np.array([tissue_map[t] for t in batch["tissue_types"]], np.int32),
    }
    if "masks/regression_map" in batch:
        out["regression_map"] = batch["masks/regression_map"].astype(np.float32)
    return out


def default_loss_fn_dict(regression_loss: bool = False) -> Dict[str, Dict[str, Dict]]:
    """The per-branch weighted losses of the reference's default config
    (`experiment_cellvit_pannuke.py:282-413`, the JAX package's
    `ExperimentCellViT.get_loss_fn` with no loss settings)."""
    spec = {
        "nuclei_binary_map": {"bce": "xentropy_loss", "dice": "dice_loss"},
        "hv_map": {"mse": "mse_loss_maps", "msge": "msge_loss_maps"},
        "nuclei_type_map": {"bce": "xentropy_loss", "dice": "dice_loss"},
        "tissue_types": {"ce": "CrossEntropyLoss"},
    }
    if regression_loss:
        spec["regression_map"] = {"l1": "L1Loss"}
    return {branch: {name: {"loss_fn": retrieve_loss_fn(fn), "weight": 1}
                     for name, fn in losses.items()}
            for branch, losses in spec.items()}


def trainable_when_frozen(name: str) -> bool:
    """Parameters that train with the encoder frozen: all but the encoder's,
    whose tissue head stays trainable (reference `CellViT.freeze_encoder`)."""
    return not name.startswith("encoder.") or name.startswith("encoder.head.")


class CellViTTrainer:
    """Trainer for HoVer-Net-branch CellViT models. The model's parameters
    are the fp32 master weights; the trainer keeps the optimizer state
    (`opt_state`), the global step and the dropout generator. Runs on the
    card unless `device="cpu"`."""

    def __init__(
        self,
        model: torch.nn.Module,
        loss_fn_dict: Dict[str, Dict[str, Dict]],
        optimizer: Transform,
        num_classes: int,
        tissue_types: Dict[str, int],
        magnification: int = 40,
        accum_steps: int = 1,
        metric_logger: Optional[MetricLogger] = None,
        logger=None,
        device: Optional[Union[str, torch.device]] = None,
        mixed_precision: bool = False,
        log_dir: Optional[Path] = None,
        run_config: Optional[Dict] = None,
    ) -> None:
        self.device = resolve_device(device)
        self.log_dir = Path(log_dir) if log_dir is not None else None
        #: the flattened run config that checkpoints carry
        self.run_config = dict(run_config or {})
        self.loader_wait_s: List[float] = []
        self.model = model.to(device=self.device, dtype=torch.float32)
        self.loss_fn_dict = loss_fn_dict
        self.num_classes = num_classes
        self.tissue_types = tissue_types
        self.magnification = magnification
        self.metric_logger = metric_logger
        self.logger = logger
        self.mixed_precision = mixed_precision
        if accum_steps > 1:
            optimizer = multi_steps(optimizer, accum_steps)
        self.optimizer = optimizer
        named = list(self.model.named_parameters())
        self.param_names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.trainable_frozen = [trainable_when_frozen(n) for n in self.param_names]
        self.opt_state = optimizer.init([p.detach() for p in self.params])
        self.step = 0
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        use_generator(self.model, self.generator)

    # ------------------------------------------------------------- loss

    def unpack_predictions(self, out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """fp32 outputs, the NB/NT branches softmaxed (trainer_cellvit.py:498-516)."""
        preds = {k: v.float() for k, v in out.items()}
        preds["nuclei_binary_map"] = torch.softmax(preds["nuclei_binary_map"], dim=-1)
        preds["nuclei_type_map"] = torch.softmax(preds["nuclei_type_map"], dim=-1)
        return preds

    def assemble_gt(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        gt = {
            "nuclei_binary_map": F.one_hot(batch["nuclei_binary_map"].long(), 2).float(),
            "nuclei_type_map": F.one_hot(batch["nuclei_type_map"].long(), self.num_classes).float(),
            "hv_map": batch["hv_map"],
            "tissue_types": batch["tissue_types"],
        }
        if "regression_map" in batch:
            gt["regression_map"] = batch["regression_map"]
        return gt

    def calculate_loss(self, preds: Dict[str, torch.Tensor], gt: Dict[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        parts: Dict[str, torch.Tensor] = {}
        for branch, branch_losses in self.loss_fn_dict.items():
            if branch not in preds or branch not in gt:
                continue
            for loss_name, setting in branch_losses.items():
                fn, weight = setting["loss_fn"], setting["weight"]
                if loss_name == "msge":
                    value = fn(preds[branch], gt[branch], focus=gt["nuclei_binary_map"])
                else:
                    value = fn(preds[branch], gt[branch])
                parts[f"{branch}_{loss_name}"] = value
                total = total + weight * value
        return total, parts

    def _device_metrics(self, preds: Dict, batch: Dict) -> Dict[str, torch.Tensor]:
        """Binary dice/jaccard + tissue accuracy (trainer_cellvit.py:657-732)."""
        pred_bin = preds["nuclei_binary_map"].argmax(-1)
        gt_bin = batch["nuclei_binary_map"]
        inter = ((pred_bin == 1) & (gt_bin == 1)).sum().float()
        pred_n = (pred_bin == 1).sum().float()
        gt_n = (gt_bin == 1).sum().float()
        dice = (2.0 * inter + 1e-6) / (pred_n + gt_n + 1e-6)
        jacc = (inter + 1e-6) / (pred_n + gt_n - inter + 1e-6)
        acc = (preds["tissue_types"].argmax(-1) == batch["tissue_types"]).float().mean()
        return {"dice": dice, "jaccard": jacc, "tissue_acc": acc}

    # ------------------------------------------------------------- steps

    def to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """A `prepare_batch` dict as tensors on the trainer's device."""
        pin = self.device.type == "cuda"
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.ascontiguousarray(v))
            out[k] = (t.pin_memory() if pin else t).to(self.device, non_blocking=True)
        return out

    def _forward(self, image: torch.Tensor, freeze_encoder: bool = False) -> Dict[str, torch.Tensor]:
        with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.mixed_precision):
            return self.model(image, freeze_encoder=freeze_encoder)

    def loss_and_grads(self, batch: Dict[str, torch.Tensor], freeze_encoder: bool):
        """Train-mode forward and backward, no update: (total, parts, preds,
        grads), a gradient per parameter (zeros where autograd gave none)."""
        self.model.train()
        for p in self.params:
            p.grad = None
        preds = self.unpack_predictions(self._forward(batch["image"], freeze_encoder))
        total, parts = self.calculate_loss(preds, self.assemble_gt(batch))
        total.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        detach = lambda d: {k: v.detach() for k, v in d.items()}
        return total.detach(), detach(parts), detach(preds), grads

    def train_step(self, batch: Dict[str, torch.Tensor], freeze_encoder: bool
                   ) -> Dict[str, torch.Tensor]:
        """One optimizer step on a device batch; returns its metrics as 0-d
        device tensors."""
        total, parts, preds, grads = self.loss_and_grads(batch, freeze_encoder)
        with torch.no_grad():
            params = [p.detach() for p in self.params]
            updates, self.opt_state = self.optimizer.update(grads, self.opt_state, params)
            if freeze_encoder:
                updates = masked(updates, self.trainable_frozen)
            for p, u in zip(params, updates):
                p.add_(u)
            for p in self.params:
                p.grad = None
        self.step += 1
        return {"Total_Loss": total, **parts, **self._device_metrics(preds, batch)}

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor]) -> Tuple[Dict, Dict]:
        """Eval-mode forward and loss. Its numerics are the inference
        forward's: under mixed precision `layers.LayerNorm` returns bf16 in
        evaluation (its affine cast to bf16), where the training forward
        normalises in fp32, so validation losses of the same weights differ
        from training's by that rounding too."""
        self.model.eval()
        preds = self.unpack_predictions(self._forward(batch["image"]))
        total, parts = self.calculate_loss(preds, self.assemble_gt(batch))
        metrics = {"Total_Loss": total, **parts, **self._device_metrics(preds, batch)}
        return metrics, preds

    @staticmethod
    def _host(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One device → host copy for a dict of 0-d tensors."""
        values = torch.stack([v.float() for v in metrics.values()]).tolist()
        return dict(zip(metrics, values))

    # ------------------------------------------------------------- epochs

    def train_epoch(self, loader, epoch: int, unfreeze_epoch: int = 0) -> Dict[str, float]:
        freeze = epoch < unfreeze_epoch
        meters: Dict[str, AverageMeter] = {}
        self.loader_wait_s = []
        batches = iter(loader)
        while True:
            t0 = time.perf_counter()
            raw = next(batches, None)
            if raw is None:
                break
            self.loader_wait_s.append(time.perf_counter() - t0)
            batch = self.to_device(prepare_batch(raw, self.tissue_types))
            for k, v in self._host(self.train_step(batch, freeze)).items():
                meters.setdefault(k, AverageMeter(k)).update(v)
        scalars = {k: m.avg for k, m in meters.items()}
        if self.metric_logger:
            self.metric_logger.log({f"Train/{k}": v for k, v in scalars.items()}, step=epoch)
        return scalars

    def validation_epoch(self, loader, epoch: int, compute_pq: bool = True,
                         log_images: bool = False) -> Tuple[Dict[str, float], float]:
        meters: Dict[str, AverageMeter] = {}
        pq_scores: List[float] = []
        plotted = not log_images
        for raw in loader:
            batch = prepare_batch(raw, self.tissue_types)
            inst_gt = batch.pop("instance_map")
            metrics, preds = self.eval_step(self.to_device(batch))
            for k, v in self._host(metrics).items():
                meters.setdefault(k, AverageMeter(k)).update(v)
            if compute_pq:
                pq_scores.extend(self._batch_pq(preds, inst_gt))
            if not plotted and self.log_dir is not None:
                self._plot_examples(batch, preds, inst_gt, epoch)
                plotted = True
        scalars = {k: m.avg for k, m in meters.items()}
        mean_pq = float(np.mean(pq_scores)) if pq_scores else 0.0
        scalars["bPQ"] = mean_pq
        if self.metric_logger:
            self.metric_logger.log({f"Validation/{k}": v for k, v in scalars.items()}, step=epoch)
        return scalars, mean_pq

    def _plot_examples(self, batch: Dict, preds: Dict, inst_gt: np.ndarray, epoch: int) -> Path:
        """Write a validation example panel (reference
        trainer_cellvit.py:842-1029); returns its path."""
        from cellvit_tpu_torch.utils.plotting import generate_example_image

        ksize, object_size = (21, 10) if self.magnification == 40 else (11, 3)
        nb = preds["nuclei_binary_map"]
        inst_pred = instance_map_batch(nb[..., 1], preds["hv_map"], object_size=object_size,
                                       ksize=ksize).cpu().numpy()
        outfile = self.log_dir / "examples" / f"epoch_{epoch:03d}.png"
        generate_example_image(
            np.asarray(batch["image"]), inst_pred, np.asarray(inst_gt),
            nb.argmax(-1).cpu().numpy(), np.asarray(batch["nuclei_binary_map"]),
            hv_pred=preds["hv_map"].cpu().numpy(), hv_gt=np.asarray(batch["hv_map"]),
            outfile=outfile,
        )
        return outfile

    def _batch_pq(self, preds: Dict, inst_gt: np.ndarray) -> List[float]:
        """Binary PQ per image: device HV postproc → host pairing."""
        ksize, object_size = (21, 10) if self.magnification == 40 else (11, 3)
        inst_pred = instance_map_batch(preds["nuclei_binary_map"][..., 1], preds["hv_map"],
                                       object_size=object_size, ksize=ksize).cpu().numpy()
        out = []
        for i in range(inst_pred.shape[0]):
            true = M.remap_label(np.asarray(inst_gt[i]))
            pred = M.remap_label(inst_pred[i])
            [_, _, pq], _ = M.get_fast_pq(true, pred)
            out.append(pq)
        return out

    # ------------------------------------------------------------- fit

    def fit(
        self,
        epochs: int,
        train_loader,
        val_loader,
        *,
        unfreeze_epoch: int = 0,
        eval_every: int = 1,
        early_stopping: Optional[EarlyStopping] = None,
        monitor: str = "bPQ",
        checkpoint_dir: Optional[Path] = None,
        seed: int = 0,
        log_fn: Optional[Callable[[str], None]] = None,
        start_epoch: int = 0,
    ) -> None:
        """Train `epochs` epochs from `start_epoch`, validating every
        `eval_every`; checkpoints `latest_checkpoint.pth` (and
        `model_best.pth` on improvement) under `checkpoint_dir`. Every
        dropout draws from the trainer's generator, seeded with `seed`."""
        from cellvit_tpu_torch.train import checkpoint as ckpt

        log = log_fn or (self.logger.info if self.logger else print)
        self.generator.manual_seed(seed)
        ckpt_dir = Path(checkpoint_dir) if checkpoint_dir is not None else None
        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            train_scalars = self.train_epoch(train_loader, epoch, unfreeze_epoch=unfreeze_epoch)
            log(f"epoch {epoch + 1}/{epochs} "
                f"loss={train_scalars.get('Total_Loss', float('nan')):.4f} "
                f"dice={train_scalars.get('dice', float('nan')):.4f} ({time.time() - t0:.1f}s)")
            if (epoch + 1) % eval_every:
                if ckpt_dir is not None:
                    ckpt.save_checkpoint(ckpt_dir / "latest_checkpoint.pth", self, epoch)
                continue
            val_scalars, _ = self.validation_epoch(val_loader, epoch)
            log(f"  val loss={val_scalars.get('Total_Loss', float('nan')):.4f} "
                f"bPQ={val_scalars.get('bPQ', 0.0):.4f}")
            if ckpt_dir is not None:
                ckpt.save_checkpoint(ckpt_dir / "latest_checkpoint.pth", self, epoch)
            if early_stopping is not None:
                improved = early_stopping(val_scalars.get(monitor, 0.0), epoch)
                if improved and ckpt_dir is not None:
                    ckpt.save_checkpoint(ckpt_dir / "model_best.pth", self, epoch,
                                         early_stopping.best_metric, early_stopping.best_epoch)
                if early_stopping.early_stop:
                    log(f"early stopping at epoch {epoch + 1}")
                    break
