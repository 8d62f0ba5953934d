"""Sweep-configuration schema validation (copy of
`cellvit_tpu/train/validator.py`; reference `base_ml/base_validator.py:10-18`,
without the `schema` package)."""

from __future__ import annotations

from typing import Dict


class SchemaError(ValueError):
    pass


def validate_sweep_config(config: Dict) -> Dict:
    """Validate a wandb sweep block: method ∈ {grid, random, bayes},
    optional name/metric/run_cap with the reference's shapes."""
    if not isinstance(config, dict):
        raise SchemaError("sweep config must be a mapping")
    method = config.get("method")
    if method not in ("grid", "random", "bayes"):
        raise SchemaError(
            f"sweep.method must be one of grid/random/bayes, got {method!r}"
        )
    if "name" in config and not isinstance(config["name"], str):
        raise SchemaError("sweep.name must be a string")
    if "metric" in config:
        metric = config["metric"]
        if not isinstance(metric, dict):
            raise SchemaError("sweep.metric must be a mapping")
        if "name" in metric and not isinstance(metric["name"], str):
            raise SchemaError("sweep.metric.name must be a string")
        if "goal" in metric and metric["goal"] not in ("maximize", "minimize"):
            raise SchemaError("sweep.metric.goal must be maximize|minimize")
    if "run_cap" in config and not isinstance(config["run_cap"], int):
        raise SchemaError("sweep.run_cap must be an integer")
    return config
