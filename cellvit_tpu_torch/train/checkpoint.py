"""Training checkpoints as torch `.pth` files in the reference schema (port
of `cellvit_tpu/train/checkpoint.py`; keys of the reference
`base_trainer.py:229-251` as `export_reference_checkpoint` writes them).

`model_state_dict` holds the reference key names, so
`models/checkpoint_io.load_checkpoint` rebuilds the model from the file;
`optimizer_state_dict` holds the optimizer state and the global step, so
`load_checkpoint` resumes training where it stopped.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from cellvit_tpu_torch.train.optim import tree_to

_SAM_BACKBONES = {768: "SAM-B", 1024: "SAM-L", 1280: "SAM-H"}


def model_config(model) -> Tuple[str, Dict[str, Any]]:
    """(arch, flat run config) of a CellViT, as `build_model_from_config`
    reads them."""
    config = {
        "data.num_nuclei_classes": model.num_nuclei_classes,
        "data.num_tissue_classes": model.num_tissue_classes,
        "model.regression_loss": model.regression_loss,
    }
    if model.encoder_type == "sam":
        config["model.backbone"] = _SAM_BACKBONES[model.embed_dim]
        return "CellViTSAM", config
    config.update({"model.embed_dim": model.embed_dim, "model.depth": model.depth,
                   "model.num_heads": model.num_heads,
                   "model.extract_layers": list(model.extract_layers)})
    vit256 = (model.embed_dim, model.depth, model.num_heads, model.extract_layers) == (
        384, 12, 6, (3, 6, 9, 12))
    return ("CellViT256" if vit256 else "CellViT"), config


def save_checkpoint(path: Path, trainer, epoch: int, best_metric: Optional[float] = None,
                    best_epoch: Optional[int] = None) -> None:
    """Write the trainer's model, optimizer state and step to `path`."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arch, config = model_config(trainer.model)
    cpu = torch.device("cpu")
    ckpt = {
        "arch": arch,
        "epoch": epoch,
        "model_state_dict": {k: v.detach().to(cpu) for k, v in trainer.model.state_dict().items()},
        "optimizer_state_dict": {"state": tree_to(trainer.opt_state, cpu), "step": trainer.step,
                                 "param_names": list(trainer.param_names)},
        "scheduler_state_dict": {"step": trainer.step},
        "config": config,
        "run_name": "cellvit_tpu_torch",
        "wandb_id": None,
        "logdir": str(path.parent),
        "best_metric": best_metric,
        "best_epoch": best_epoch,
    }
    torch.save(ckpt, str(path))


def load_checkpoint(path: Path, trainer) -> Dict[str, Any]:
    """Restore the model weights, the optimizer state and the step of
    `trainer` from `path`; returns the checkpoint's other entries (epoch,
    config, ...)."""
    ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    opt = ckpt["optimizer_state_dict"]
    if opt["param_names"] != list(trainer.param_names):
        raise ValueError("checkpoint parameters differ from the trainer's model")
    trainer.model.load_state_dict(ckpt["model_state_dict"])
    trainer.opt_state = tree_to(opt["state"], trainer.device)
    trainer.step = int(opt["step"])
    return {k: v for k, v in ckpt.items() if k not in ("model_state_dict", "optimizer_state_dict")}
