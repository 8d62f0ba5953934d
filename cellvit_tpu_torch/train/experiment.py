"""Experiment lifecycle: config → run directory → trained model (port of
`cellvit_tpu/train/experiment.py`; reference `base_ml/base_experiment.py:
39-403` + `experiments/experiment_cellvit_pannuke.py:69-848`).

Config resolution with the reference's defaults, seeding, datasets,
augmentations and the weighted sampler, the model (built on the resolved
device, its encoder optionally loaded from a DINO or SAM checkpoint), the
loss dict, the optimizer and schedule, `CellViTTrainer.fit` with early
stopping and checkpoints, and resuming from a checkpoint.

One card is one device: there is no mesh (data parallelism waits for its
own port). The run runs on the card unless the experiment is given
`device="cpu"`. `export_torch_checkpoint` needs no second writer here: the
trainer's checkpoints already are reference `.pth` files that carry the
flattened run config.

The config schema is the reference's `train_cellvit.yaml`; the dataset
directory holds `dataset_config.yaml` with the `tissue_types` and
`nuclei_types` name → id maps.
"""

from __future__ import annotations

import copy
import datetime
import random
import warnings
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from cellvit_tpu_torch import resolve_device
from cellvit_tpu_torch.data.datasets import select_dataset
from cellvit_tpu_torch.data.loader import DataLoader, SequentialSampler, get_sampler
from cellvit_tpu_torch.data.transforms import build_transforms
from cellvit_tpu_torch.models.cellvit import CellViT, CellViT256, CellViTSAM
from cellvit_tpu_torch.models.checkpoint_io import (load_dino_encoder, load_encoder_into,
                                                    load_sam_encoder, unflatten_dict)
from cellvit_tpu_torch.train import checkpoint as ckpt
from cellvit_tpu_torch.train.early_stopping import EarlyStopping
from cellvit_tpu_torch.train.losses import retrieve_loss_fn
from cellvit_tpu_torch.train.optim import make_lr_schedule, retrieve_optimizer
from cellvit_tpu_torch.train.trainer import CellViTTrainer
from cellvit_tpu_torch.utils import yaml_lite
from cellvit_tpu_torch.utils.logger import Logger, MetricLogger


def flatten_dict(d: Dict, sep: str = ".", prefix: str = "") -> Dict:
    out = {}
    for k, v in d.items():
        key = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, dict) and v:
            out.update(flatten_dict(v, sep, key))
        else:
            out[key] = v
    return out


class BaseExperiment:
    """Run-lifecycle owner (reference base_experiment.py:39-403)."""

    def __init__(self, default_conf: Dict, checkpoint: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        self.default_conf = copy.deepcopy(default_conf)
        self.checkpoint_path = checkpoint
        self.run_conf: Dict = copy.deepcopy(default_conf)
        self.device = device

    @staticmethod
    def seed_run(seed: int) -> torch.Generator:
        """Seed Python, numpy and torch; returns a generator seeded alike."""
        random.seed(seed)
        np.random.seed(seed)
        torch.manual_seed(seed)
        return torch.Generator().manual_seed(seed)

    @staticmethod
    def extract_sweep_arguments(config: Dict) -> Dict:
        """Flatten nested sweep `parameters` blocks
        (base_experiment.py:296-330)."""
        sweep = config.get("sweep", {})
        params = flatten_dict(config.get("parameters", {}))
        out = {"method": sweep.get("method"), "name": sweep.get("name")}
        out["parameters"] = {
            k: v for k, v in params.items() if k.endswith(("min", "max", "values", "value"))
        }
        return out

    def overwrite_sweep_values(self, run_conf: Dict, sweep_values: Dict) -> Dict:
        """Apply flattened sweep-selected values onto the run config."""
        flat = flatten_dict(run_conf)
        flat.update(sweep_values)
        return unflatten_dict(flat)


class ExperimentCellVitPanNuke(BaseExperiment):
    """PanNuke CellViT training experiment."""

    dataset_name = "pannuke"
    # reference experiment_cellvit_pannuke.py:782-840
    allowed_sampling_strategies = ("random", "cell", "tissue", "cell+tissue")

    def __init__(self, default_conf: Dict, checkpoint: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        super().__init__(default_conf, checkpoint, device)
        self.load_dataset_setup()

    def load_dataset_setup(self) -> None:
        path = Path(self.run_conf["data"]["dataset_path"]) / "dataset_config.yaml"
        self.dataset_config = yaml_lite.load(path.read_text())

    def num_tissue_classes(self) -> int:
        return len(self.dataset_config["tissue_types"])

    # ------------------------------------------------------------ pieces

    def get_loss_fn(self, loss_fn_settings: Dict) -> Dict:
        """Per-branch weighted loss dict with the reference defaults
        (experiment_cellvit_pannuke.py:282-413)."""
        defaults = {
            "nuclei_binary_map": {
                "bce": {"loss_fn": "xentropy_loss", "weight": 1},
                "dice": {"loss_fn": "dice_loss", "weight": 1},
            },
            "hv_map": {
                "mse": {"loss_fn": "mse_loss_maps", "weight": 1},
                "msge": {"loss_fn": "msge_loss_maps", "weight": 1},
            },
            "nuclei_type_map": {
                "bce": {"loss_fn": "xentropy_loss", "weight": 1},
                "dice": {"loss_fn": "dice_loss", "weight": 1},
            },
            "tissue_types": {
                "ce": {"loss_fn": "CrossEntropyLoss", "weight": 1},
            },
        }
        if self.run_conf["model"].get("regression_loss", False):
            defaults["regression_map"] = {
                "l1": {"loss_fn": "L1Loss", "weight": 1},
            }
        loss_fn_dict: Dict = {}
        branches = set(defaults) | set(loss_fn_settings or {})
        for branch in branches:
            settings = (loss_fn_settings or {}).get(branch, defaults.get(branch, {}))
            loss_fn_dict[branch] = {}
            for loss_name, sett in settings.items():
                loss_fn_dict[branch][loss_name] = {
                    "loss_fn": retrieve_loss_fn(sett["loss_fn"], **(sett.get("args") or {})),
                    "weight": sett.get("weight", 1),
                }
        return loss_fn_dict

    def get_train_model(self) -> CellViT:
        mcfg = self.run_conf["model"]
        tcfg = self.run_conf.get("training", {})
        data = self.run_conf["data"]
        backbone = str(mcfg.get("backbone", "default"))
        common = dict(
            num_nuclei_classes=data["num_nuclei_classes"],
            num_tissue_classes=self.num_tissue_classes(),
            regression_loss=mcfg.get("regression_loss", False),
            drop_rate=tcfg.get("drop_rate", 0.0),
        )
        if backbone.upper().startswith("SAM"):
            return CellViTSAM(vit_structure=backbone, **common)
        if backbone.lower() in ("vit256", "vit-256"):
            return CellViT256(
                attn_drop_rate=tcfg.get("attn_drop_rate", 0.0),
                drop_path_rate=tcfg.get("drop_path_rate", 0.0),
                **common,
            )
        return CellViT(
            embed_dim=mcfg["embed_dim"],
            depth=mcfg["depth"],
            num_heads=mcfg["num_heads"],
            extract_layers=tuple(mcfg["extract_layers"]),
            encoder_type="histo",
            attn_drop_rate=tcfg.get("attn_drop_rate", 0.0),
            drop_path_rate=tcfg.get("drop_path_rate", 0.0),
            **common,
        )

    def load_pretrained(self, model: CellViT) -> CellViT:
        """Load a pretrained encoder (DINO teacher / SAM) into the model
        (reference cellvit.py:483-493, 574-584)."""
        path = self.run_conf["model"].get("pretrained_encoder")
        if path:
            loader = load_sam_encoder if model.encoder_type == "sam" else load_dino_encoder
            load_encoder_into(model, loader(path))
        return model

    def get_datasets(self, train_transforms, val_transforms, native_png: bool = False) -> Tuple:
        data = dict(self.run_conf["data"])
        if data.get("val_split") and data.get("val_folds"):
            raise RuntimeError("provide either val_split or val_folds, not both")
        if not data.get("val_folds") and not data.get("val_split"):
            warnings.warn(
                "neither val_folds nor val_split configured — validation "
                "(and early stopping / model_best selection) will run on "
                "the TRAINING folds",
                stacklevel=2,
            )
        full_cfg = {
            "dataset_path": data["dataset_path"],
            "train_folds": data["train_folds"],
            "val_folds": data.get("val_folds", data["train_folds"]),
            "test_folds": data.get("test_folds", []),
        }
        kw = dict(regression=self.run_conf["model"].get("regression_loss", False),
                  native_png=native_png)
        train_ds = select_dataset(self.dataset_name, "train", full_cfg,
                                  transforms=train_transforms, **kw)
        if data.get("val_split"):
            # split one dataset by index (seeded)
            n = len(train_ds)
            rng = np.random.default_rng(self.run_conf.get("random_seed", 19))
            idx = rng.permutation(n)
            n_val = int(n * float(data["val_split"]))
            val_ds = select_dataset(self.dataset_name, "train", full_cfg,
                                    transforms=val_transforms, **kw)
            train_ds = _Subset(train_ds, idx[n_val:])
            val_ds = _Subset(val_ds, idx[:n_val])
        else:
            val_ds = select_dataset(self.dataset_name, "val", full_cfg,
                                    transforms=val_transforms, **kw)
        return train_ds, val_ds

    # ------------------------------------------------------------ run

    def run_experiment(self) -> Tuple[Path, CellViT, CellViTTrainer]:
        """Train; returns (run_dir, model, trainer)."""
        cfg = self.run_conf
        seed = cfg.get("random_seed", 19)
        self.seed_run(seed)
        device = resolve_device(self.device)

        log_cfg = cfg.get("logging", {})
        stamp = datetime.datetime.now().strftime("%Y-%m-%dT%H%M%S")
        comment = log_cfg.get("log_comment") or "cellvit"
        run_dir = Path(log_cfg.get("log_dir", "runs")) / f"{stamp}_{comment}"
        run_dir.mkdir(parents=True, exist_ok=True)
        (run_dir / "config.yaml").write_text(yaml_lite.dump(cfg))
        logger = Logger(level=log_cfg.get("level", "INFO") or "INFO", log_dir=run_dir).create_logger()
        flat_cfg = flatten_dict(cfg)
        # the reference rebuilds models from the config a checkpoint carries
        flat_cfg.setdefault("data.num_tissue_classes", self.num_tissue_classes())
        metric_logger = MetricLogger(
            run_dir,
            project=log_cfg.get("project"),
            run_name=f"{stamp}_{comment}",
            mode=log_cfg.get("mode", "offline") or "offline",
            config=flat_cfg,
        )

        tcfg = cfg["training"]
        model = self.load_pretrained(self.get_train_model().to(device))
        input_shape = cfg["data"].get("input_shape", 256)

        train_tf, val_tf = build_transforms(cfg.get("transformations", {}),
                                            input_shape=input_shape, seed=seed)
        train_ds, val_ds = self.get_datasets(train_tf, val_tf, native_png=device.type == "cuda")
        strategy = tcfg.get("sampling_strategy", "random") or "random"
        if strategy.lower() not in self.allowed_sampling_strategies:
            raise NotImplementedError(
                f"sampling strategy {strategy!r} not supported for "
                f"{self.dataset_name}; allowed: {self.allowed_sampling_strategies}"
            )
        sampler = get_sampler(train_ds, strategy=strategy,
                              gamma=tcfg.get("sampling_gamma", 1) or 1, seed=seed)
        batch_size = tcfg["batch_size"]
        train_loader = DataLoader(train_ds, batch_size=batch_size, sampler=sampler,
                                  num_workers=16, drop_last=True)
        val_loader = DataLoader(val_ds, batch_size=min(128, batch_size * 4),
                                sampler=SequentialSampler(len(val_ds)), num_workers=16)

        # the schedule counts optimizer EMIT steps: with gradient
        # accumulation the inner update runs every accum_steps micro-batches,
        # so per-epoch schedules count epochs in emit steps
        accum = max(1, int(tcfg.get("accum_steps", 1) or 1))
        steps_per_epoch = max(1, len(train_loader) // accum)
        sch_cfg = tcfg.get("scheduler") or {}
        schedule = make_lr_schedule(
            sch_cfg.get("scheduler_type", "none") or "none",
            base_lr=tcfg.get("optimizer_hyperparameter", {}).get("lr", 1e-4),
            epochs=tcfg["epochs"],
            steps_per_epoch=steps_per_epoch,
            gamma=sch_cfg.get("gamma", 0.95),
            eta_min=sch_cfg.get("eta_min", 1e-5),
        )
        tx = retrieve_optimizer(tcfg.get("optimizer", "AdamW"),
                                tcfg.get("optimizer_hyperparameter", {}), schedule)

        trainer = self.get_trainer()(
            model=model,
            loss_fn_dict=self.get_loss_fn(cfg.get("loss", {})),
            optimizer=tx,
            num_classes=cfg["data"]["num_nuclei_classes"],
            tissue_types=self.dataset_config["tissue_types"],
            magnification=cfg["data"].get("magnification", 40),
            accum_steps=accum,
            metric_logger=metric_logger,
            logger=logger,
            device=device,
            mixed_precision=bool(tcfg.get("mixed_precision", False)),
            log_dir=run_dir,
            run_config=flat_cfg,
        )

        start_epoch = 0
        if self.checkpoint_path:
            meta = ckpt.load_checkpoint(Path(self.checkpoint_path), trainer)
            start_epoch = int(meta.get("epoch", -1)) + 1
            logger.info(f"resumed from {self.checkpoint_path} at epoch {start_epoch}")

        es = None
        if tcfg.get("early_stopping_patience"):
            es = EarlyStopping(tcfg["early_stopping_patience"], "maximize")

        trainer.fit(
            epochs=tcfg["epochs"],
            train_loader=train_loader,
            val_loader=val_loader,
            unfreeze_epoch=tcfg.get("unfreeze_epoch", 0) or 0,
            eval_every=tcfg.get("eval_every", 1) or 1,
            early_stopping=es,
            monitor="bPQ",
            checkpoint_dir=run_dir / "checkpoints",
            seed=seed,
            start_epoch=start_epoch,
        )
        metric_logger.close()
        return run_dir, model, trainer

    def get_trainer(self):
        return CellViTTrainer


class ExperimentCellViTCoNic(ExperimentCellVitPanNuke):
    """CoNIC experiment (reference experiment_cellvit_conic.py).

    The delta vs PanNuke is tissue handling: CoNIC has no tissue labels, so
    the tissue CE loss branch is absent (conic.py:282 — branches are NB/HV/NT
    only), models are built with ``num_tissue_classes=1``
    (experiment_cellvit_conic.py:552,580,603), and only the "random"/"cell"
    sampling strategies exist (:771-798).
    """

    dataset_name = "conic"
    allowed_sampling_strategies = ("random", "cell")

    def num_tissue_classes(self) -> int:
        return 1

    def get_loss_fn(self, loss_fn_settings: Dict) -> Dict:
        settings = dict(loss_fn_settings or {})
        settings.pop("tissue_types", None)
        loss_fn_dict = super().get_loss_fn(settings)
        loss_fn_dict.pop("tissue_types", None)
        return loss_fn_dict


class _Subset:
    def __init__(self, dataset, indices) -> None:
        self.dataset = dataset
        self.indices = np.asarray(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.dataset[int(self.indices[i])]

    def __getattr__(self, name):
        return getattr(self.dataset, name)
