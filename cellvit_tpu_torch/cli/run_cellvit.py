"""Train a CellViT model (port of `cellvit_tpu/cli/run_cellvit.py`; the
reference `cell_segmentation/run_cellvit.py:30-103`).

Usage: python -m cellvit_tpu_torch.cli.run_cellvit --config train.yaml
       [--gpu N | --device cpu] [--checkpoint path | --sweep | --agent id]

Picks the experiment class by config["data"]["dataset"] (PanNuke/CoNIC),
trains and then runs the patch evaluation on the test folds. Runs on
`cuda:N` (N from `--gpu`, else the config's `gpu`), which is made the current
device around the run, unless `--device cpu` is given.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import List, Optional

import torch


def main(argv: Optional[List[str]] = None):
    """Run the CLI on `argv` (default: the command line). Returns the run
    directory, or the best sweep record for `--sweep` / `--agent`."""
    from cellvit_tpu_torch import resolve_device
    from cellvit_tpu_torch.cli.base_cli import ExperimentBaseParser, run_device
    from cellvit_tpu_torch.train.experiment import (ExperimentCellViTCoNic,
                                                    ExperimentCellVitPanNuke)

    config, args = ExperimentBaseParser().parse_arguments(argv)
    device = resolve_device(run_device(config, args))
    dataset = str(config["data"]["dataset"]).lower()
    if dataset == "pannuke":
        experiment_class = ExperimentCellVitPanNuke
    elif dataset == "conic":
        experiment_class = ExperimentCellViTCoNic
    else:
        raise NotImplementedError(f"unknown dataset {dataset}")
    experiment_class = functools.partial(experiment_class, device=device)
    # the ctypes kernels launch on the current device
    current = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()

    with current:
        if config.get("run_sweep"):
            from cellvit_tpu_torch.train.sweeper import run_sweep

            best, _ = run_sweep(config, experiment_class)
            print(f"sweep finished; best run: {best}")
            return best

        if config.get("agent"):
            # join an existing sweep as an extra agent (reference
            # run_cellvit.py:46-82 wandb.agent; local claim-file protocol)
            from cellvit_tpu_torch.train.sweeper import resolve_sweep_dir, run_agent

            sweep_dir = resolve_sweep_dir(config["agent"], config)
            best, _ = run_agent(sweep_dir, experiment_class, agent_name=f"agent-{os.getpid()}")
            print(f"agent finished; best run so far: {best}")
            return best

        experiment = experiment_class(config, checkpoint=config.get("checkpoint"))
        run_dir, _, _ = experiment.run_experiment()

        # post-training patch evaluation on the test folds (run_cellvit.py:85-102)
        if config["data"].get("test_folds"):
            from cellvit_tpu_torch.inference.eval_pannuke import InferenceCellViT

            inference = InferenceCellViT(
                run_dir=run_dir,
                checkpoint_name=config.get("eval_checkpoint", "latest_checkpoint"),
                magnification=config["data"].get("magnification", 40),
                device=device,
            )
            inference.run_patch_inference()
    return run_dir


if __name__ == "__main__":
    main()
