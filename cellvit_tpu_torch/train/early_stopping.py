"""Early stopping (reference `base_ml/base_early_stopping.py:16-83`; copy of
`cellvit_tpu/train/early_stopping.py`)."""

from __future__ import annotations


class EarlyStopping:
    """Patience counter on a validation metric.

    Args:
        patience: epochs without improvement before stopping.
        strategy: "minimize" or "maximize".
    """

    def __init__(self, patience: int, strategy: str = "minimize") -> None:
        assert strategy.lower() in ("minimize", "maximize")
        self.patience = patience
        self.strategy = strategy.lower()
        self.counter = 0
        self.best_metric = None
        self.best_epoch = None
        self.early_stop = False

    def _improved(self, metric: float) -> bool:
        if self.best_metric is None:
            return True
        if self.strategy == "minimize":
            return metric < self.best_metric
        return metric > self.best_metric

    def __call__(self, metric: float, epoch: int) -> bool:
        """Returns True if the metric improved this epoch."""
        if self._improved(metric):
            self.best_metric = metric
            self.best_epoch = epoch
            self.counter = 0
            return True
        self.counter += 1
        if self.counter >= self.patience:
            self.early_stop = True
        return False

    def state_dict(self) -> dict:
        return {
            "counter": self.counter,
            "best_metric": self.best_metric,
            "best_epoch": self.best_epoch,
            "early_stop": self.early_stop,
        }

    def load_state_dict(self, state: dict) -> None:
        self.__dict__.update(state)
