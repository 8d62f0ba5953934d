"""Small infra utilities: timers, profiling, dict tools (port of
`cellvit_tpu/utils/tools.py`).

`Timer` keeps per-stage wall-clock laps; `device_trace` records a
`torch.profiler` trace of the CPU and, where present, the CUDA device, and
exports it as a Chrome trace (`chrome://tracing`, Perfetto).
"""

from __future__ import annotations

import contextlib
import sys
import time
from pathlib import Path
from typing import Dict, Iterator, Optional


class Timer:
    """Wall-clock stage timer with named laps."""

    def __init__(self) -> None:
        self.laps: Dict[str, float] = {}
        self._starts: Dict[str, float] = {}

    def start(self, name: str) -> None:
        self._starts[name] = time.perf_counter()

    def stop(self, name: str) -> float:
        dt = time.perf_counter() - self._starts.pop(name)
        self.laps[name] = self.laps.get(name, 0.0) + dt
        return dt

    @contextlib.contextmanager
    def lap(self, name: str) -> Iterator[None]:
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    def summary(self) -> Dict[str, float]:
        return dict(self.laps)


def start_timer() -> float:
    return time.perf_counter()


def end_timer(start: float, label: str = "") -> float:
    dt = time.perf_counter() - start
    if label:
        print(f"{label}: {dt:.2f}s")
    return dt


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Record a torch.profiler trace (CPU, and CUDA when a GPU is present)
    and export it to `log_dir/trace.json` (Chrome trace format). No-op when
    log_dir is None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def get_size_of_dict(d: Dict) -> int:
    """Rough recursive payload size in bytes (reference get_size_of_dict)."""
    size = sys.getsizeof(d)
    for k, v in d.items():
        size += sys.getsizeof(k)
        if isinstance(v, dict):
            size += get_size_of_dict(v)
        else:
            size += sys.getsizeof(v)
    return size


def close_logger(logger) -> None:
    for handler in list(logger.handlers):
        handler.close()
        logger.removeHandler(handler)


def cropping_center(x, crop_shape, batch: bool = False):
    """Center-crop an array to crop_shape (reference tools.py:38-59);
    works on numpy arrays and torch tensors, HW[C] or BHW[C] with batch=True."""
    if not batch:
        h0 = int((x.shape[0] - crop_shape[0]) * 0.5)
        w0 = int((x.shape[1] - crop_shape[1]) * 0.5)
        return x[h0 : h0 + crop_shape[0], w0 : w0 + crop_shape[1], ...]
    h0 = int((x.shape[1] - crop_shape[0]) * 0.5)
    w0 = int((x.shape[2] - crop_shape[1]) * 0.5)
    return x[:, h0 : h0 + crop_shape[0], w0 : w0 + crop_shape[1], ...]
