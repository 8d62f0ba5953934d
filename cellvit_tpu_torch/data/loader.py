"""Host input pipeline: samplers + threaded prefetching batch loader (copy of
`cellvit_tpu/data/loader.py`).

Replaces the reference's torch DataLoader + (Weighted)RandomSampler usage
(`experiment_cellvit_pannuke.py:200-215, 782-840`) with numpy samplers, a
thread pool for decode/label-gen, and a bounded prefetch queue producing
NHWC numpy batches that the trainer copies to the device.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, List

import numpy as np


class RandomSampler:
    """Shuffled epoch permutation (torch RandomSampler semantics)."""

    def __init__(self, n: int, seed: int = 0) -> None:
        self.n = n
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[int]:
        return iter(self.rng.permutation(self.n).tolist())

    def __len__(self) -> int:
        return self.n


class WeightedRandomSampler:
    """Sampling with replacement proportional to weights (torch semantics:
    num_samples = len(dataset))."""

    def __init__(self, weights: np.ndarray, num_samples: int, seed: int = 0) -> None:
        w = np.asarray(weights, np.float64)
        self.p = w / w.sum()
        self.num_samples = num_samples
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[int]:
        return iter(
            self.rng.choice(len(self.p), size=self.num_samples, p=self.p).tolist()
        )

    def __len__(self) -> int:
        return self.num_samples


class SequentialSampler:
    def __init__(self, n: int) -> None:
        self.n = n

    def __iter__(self) -> Iterator[int]:
        return iter(range(self.n))

    def __len__(self) -> int:
        return self.n


def get_sampler(
    dataset, strategy: str = "random", gamma: float = 1.0, seed: int = 0
):
    """Sampler factory (reference experiment_cellvit_pannuke.py:782-840):
    strategies random | cell | tissue | cell+tissue."""
    if strategy.lower() == "random":
        return RandomSampler(len(dataset), seed=seed)
    if strategy.lower() == "cell":
        dataset.load_cell_count()
        weights = dataset.get_sampling_weights_cell(gamma)
    elif strategy.lower() == "tissue":
        weights = dataset.get_sampling_weights_tissue(gamma)
    elif strategy.lower() == "cell+tissue":
        dataset.load_cell_count()
        weights = dataset.get_sampling_weights_cell_tissue(gamma)
    else:
        raise NotImplementedError(f"unknown sampling strategy {strategy}")
    return WeightedRandomSampler(weights, len(dataset), seed=seed)


def default_collate(samples: List) -> Dict[str, np.ndarray]:
    """Stack (img, masks, tissue_type, name) tuples into a batch dict with
    NHWC image, stacked mask arrays, tissue-type strings and names."""
    imgs = np.stack([s[0] for s in samples]).astype(np.float32)
    masks: Dict[str, np.ndarray] = {}
    for key in samples[0][1]:
        masks[key] = np.stack([s[1][key] for s in samples])
    batch = {"image": imgs, **{f"masks/{k}": v for k, v in masks.items()}}
    batch["tissue_types"] = [s[2] for s in samples]
    batch["names"] = [s[3] for s in samples]
    return batch


class DataLoader:
    """Threaded prefetching loader.

    Each epoch materializes the sampler's index sequence, partitions it into
    batches, and `num_workers` threads call `dataset[i]` (PIL/numpy release
    the GIL for the heavy parts). A bounded queue keeps `prefetch` batches
    ready so the accelerator never waits on the host.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        sampler=None,
        num_workers: int = 8,
        drop_last: bool = False,
        collate_fn: Callable = default_collate,
        prefetch: int = 4,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler if sampler is not None else SequentialSampler(len(dataset))
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.prefetch = prefetch

    def __len__(self) -> int:
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> List[List[int]]:
        idx = list(iter(self.sampler))
        batches = [
            idx[i : i + self.batch_size]
            for i in range(0, len(idx), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self):
        batches = self._batches()
        task_q: "queue.Queue" = queue.Queue()
        results: Dict[int, object] = {}
        results_cv = threading.Condition()
        # workers may run at most `prefetch + num_workers` batches ahead of
        # the consumer; the consumer releases one permit per batch consumed
        budget = threading.Semaphore(self.prefetch + self.num_workers)
        for bi, batch in enumerate(batches):
            task_q.put((bi, batch))
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                if not budget.acquire(timeout=0.1):
                    continue
                try:
                    bi, batch = task_q.get_nowait()
                except queue.Empty:
                    budget.release()
                    return
                try:
                    collated = self.collate_fn([self.dataset[i] for i in batch])
                except Exception as e:  # propagate to consumer
                    collated = e
                with results_cv:
                    results[bi] = collated
                    results_cv.notify_all()

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(self.num_workers)
        ]
        for t in threads:
            t.start()

        try:
            for bi in range(len(batches)):
                with results_cv:
                    while bi not in results:
                        if not any(t.is_alive() for t in threads):
                            raise RuntimeError("loader workers died")
                        results_cv.wait(timeout=0.1)
                    item = results.pop(bi)
                budget.release()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
