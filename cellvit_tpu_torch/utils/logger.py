"""Experiment metric logging (the offline part of `cellvit_tpu/utils/logger.py`):
`MetricLogger` writes JSON lines to the run directory; `AverageMeter` keeps a
running mean."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional


class MetricLogger:
    """Scalar/series logging as JSON lines (`metrics.jsonl`) in `run_dir`."""

    def __init__(self, run_dir: Path) -> None:
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.run_dir / "metrics.jsonl", "a")

    def log(self, metrics: Dict, step: Optional[int] = None) -> None:
        record = {"step": step, "ts": time.time(), **_to_plain(metrics)}
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


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
