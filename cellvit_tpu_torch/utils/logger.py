"""Logging (port of `cellvit_tpu/utils/logger.py`): `Logger` builds a python
logger (stdout and an optional rotating file); `MetricLogger` writes JSON
lines to the run directory, and forwards to wandb when asked and wandb is
there; `AverageMeter` keeps a running mean."""

from __future__ import annotations

import json
import logging
import logging.handlers
import sys
import time
from pathlib import Path
from typing import Dict, Optional


class Logger:
    """Python logger factory (stdout + optional rotating file)."""

    def __init__(
        self,
        level: str = "INFO",
        log_dir: Optional[Path] = None,
        comment: str = "logs",
        use_timestamp: bool = False,
    ) -> None:
        self.level = getattr(logging, level.upper())
        self.log_dir = Path(log_dir) if log_dir else None
        self.comment = comment
        self.use_timestamp = use_timestamp

    def create_logger(self) -> logging.Logger:
        logger = logging.getLogger(f"cellvit_tpu_torch.{self.comment}")
        logger.setLevel(self.level)
        # close before clearing: a Logger per run on the same name must not
        # leak one file descriptor per run
        for h in logger.handlers:
            h.close()
        logger.handlers.clear()
        logger.propagate = False
        fmt = logging.Formatter("%(asctime)s [%(levelname)s] - %(message)s")
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if self.log_dir is not None:
            self.log_dir.mkdir(parents=True, exist_ok=True)
            name = self.comment
            if self.use_timestamp:
                name = f"{time.strftime('%Y-%m-%dT%H%M%S')}_{name}"
            fh = logging.handlers.RotatingFileHandler(
                self.log_dir / f"{name}.log", maxBytes=10_000_000, backupCount=8
            )
            fh.setFormatter(fmt)
            logger.addHandler(fh)
        return logger


class MetricLogger:
    """Scalar/series logging: JSON lines (`metrics.jsonl`) in `run_dir`, and
    wandb when `mode` is not "offline" and wandb imports and starts; else it
    warns and keeps the JSON lines alone."""

    def __init__(
        self,
        run_dir: Path,
        project: Optional[str] = None,
        run_name: Optional[str] = None,
        mode: str = "offline",
        config: Optional[Dict] = None,
        wandb_id: Optional[str] = None,
    ) -> None:
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.run_dir / "metrics.jsonl", "a")
        self.wandb_run = None
        self.wandb_id = wandb_id
        if mode != "offline":
            try:
                import wandb

                self.wandb_run = wandb.init(
                    project=project, name=run_name, mode=mode, config=config,
                    id=wandb_id, resume="must" if wandb_id else None,
                )
                self.wandb_id = self.wandb_run.id
            except Exception as e:  # noqa: BLE001 — wandb is optional
                # not just ImportError: an unauthenticated or offline wandb
                # raises at init; the JSON lines go on alone
                import warnings

                warnings.warn(f"wandb disabled ({type(e).__name__}: {e})")

    def log(self, metrics: Dict, step: Optional[int] = None) -> None:
        record = {"step": step, "ts": time.time(), **_to_plain(metrics)}
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()
        if self.wandb_run is not None:
            self.wandb_run.log(metrics, step=step)

    def summary(self, key: str, value) -> None:
        """Set `key` in the run's `summary.json` (and wandb's summary)."""
        path = self.run_dir / "summary.json"
        data = json.loads(path.read_text()) if path.exists() else {}
        data[key] = _to_plain(value)
        path.write_text(json.dumps(data, indent=2))
        if self.wandb_run is not None:
            self.wandb_run.summary[key] = value

    def close(self) -> None:
        self._f.close()
        if self.wandb_run is not None:
            self.wandb_run.finish()


def _to_plain(x):
    import numpy as np

    if isinstance(x, dict):
        return {k: _to_plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_plain(v) for v in x]
    if hasattr(x, "item") and getattr(x, "ndim", 1) == 0:
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


class AverageMeter:
    """Running average tracker (reference utils/tools.py AverageMeter)."""

    def __init__(self, name: str = "", fmt: str = ":f") -> None:
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val, n: int = 1) -> None:
        v = float(val)
        self.val = v
        self.sum += v * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
