"""Experiment CLI parser (port of `cellvit_tpu/cli/base_cli.py`; reference
`base_ml/base_cli.py:39-120`).

Flags: --config (YAML), --device (cuda, the default, or cpu), --gpu (the
CUDA device index; the config's `gpu` otherwise), and the mutually
exclusive --sweep / --agent / --checkpoint. CLI values override the YAML
config. The JAX package's platform override has no counterpart: `--device`
chooses where the run goes.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from cellvit_tpu_torch.utils import yaml_lite


def run_device(config: Dict, args: argparse.Namespace) -> str:
    """The device a run goes to: `cpu` for `--device cpu`, else `cuda:N`
    with N from `--gpu`, or the config's `gpu`, or 0."""
    if args.device == "cpu":
        return "cpu"
    return f"cuda:{int(config.get('gpu') or 0)}"


class ExperimentBaseParser:
    def __init__(self) -> None:
        parser = argparse.ArgumentParser(
            formatter_class=argparse.ArgumentDefaultsHelpFormatter,
            description="Start an experiment with given configuration file.",
        )
        parser.add_argument("--config", type=str, help="Path to a config file", required=True)
        parser.add_argument("--gpu", type=int, help="CUDA device index (with --device cuda)")
        parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                            help="run on the GPU or on the CPU")
        group = parser.add_mutually_exclusive_group(required=False)
        group.add_argument("--sweep", action="store_true", help="Starting a sweep")
        group.add_argument("--agent", type=str,
                           help="Add a new agent to the sweep (entity/project/sweep_id)")
        group.add_argument("--checkpoint", type=str, help="Path to a checkpoint to resume")
        self.parser = parser

    def parse_arguments(self, argv: Optional[List[str]] = None) -> Tuple[Dict, argparse.Namespace]:
        args = self.parser.parse_args(argv)
        config_path = Path(args.config)
        if not config_path.exists():
            raise FileNotFoundError(f"config not found: {config_path}")
        config = yaml_lite.load(config_path.read_text())
        # CLI-only keys cannot come from the YAML (reference
        # base_cli.py:100-107) — a saved run config carries `checkpoint`,
        # and re-training from it must not silently resume
        for cli_only in ("run_sweep", "agent", "checkpoint"):
            config.pop(cli_only, None)
        if args.gpu is not None:
            config["gpu"] = args.gpu
        if args.checkpoint:
            config["checkpoint"] = args.checkpoint
        config["run_sweep"] = bool(args.sweep)
        config["agent"] = args.agent
        return config, args
