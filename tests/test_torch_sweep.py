"""The port's sweeps (`train/sweeper.py`, `train/tpe.py`, copies of the JAX
package's on the port's experiments) against the JAX package's: the grid,
random and bayes enumerations, TPE proposals, a 2-run local grid sweep run
by both from the same initial weights (its records and best run), and the
agent's claim-file protocol."""

import json
import random as pyrandom
import shutil

import jax
import numpy as np
import pytest
import torch

from cellvit_tpu.train import experiment as jax_experiment
from cellvit_tpu.train import sweeper as jax_sweeper
from cellvit_tpu.train import tpe as jax_tpe
from cellvit_tpu_torch.cli import run_cellvit
from cellvit_tpu_torch.models.checkpoint_io import load_state_dict_into, state_dict_from_flax
from cellvit_tpu_torch.train import experiment, sweeper, tpe
from cellvit_tpu_torch.utils import yaml_lite
from test_torch_experiment import make_config
from tests.synth import make_pannuke_dataset

# one intra-op thread each: the suite runs as parallel pytest workers
torch.set_num_threads(1)

SPACES = [
    ({"method": "grid", "run_cap": 10},
     {"training": {"optimizer_hyperparameter": {"lr": {"values": [1e-3, 1e-4]}}},
      "training.batch_size": {"values": [4, 8]}}),
    ({"method": "random", "run_cap": 5}, {"training.sampling_gamma": {"min": 0.0, "max": 1.0},
                                          "training.batch_size": {"values": [4, 8, 16]}}),
    ({"method": "bayes", "run_cap": 3}, {"a.b": {"min": 0.0, "max": 1.0}}),
]


@pytest.mark.parametrize("i", range(len(SPACES)))
def test_enumeration_matches_jax(i):
    sweep, params = SPACES[i]
    for seed in (0, 1):
        assert sweeper.enumerate_configs(sweep, params, seed) == \
            jax_sweeper.enumerate_configs(sweep, params, seed)


def test_tpe_proposals_match_jax():
    space = {"lr": {"min": 1e-5, "max": 1e-2, "distribution": "log_uniform"},
             "gamma": {"min": 0.5, "max": 1.0}, "bs": {"values": [4, 8, 16]},
             "k": {"min": 1, "max": 9}, "c": {"value": 3}}
    rng = pyrandom.Random(0)
    obs = []
    for i in range(30):
        a = tpe.propose(space, obs, pyrandom.Random(i))
        assert a == jax_tpe.propose(space, obs, pyrandom.Random(i)), i
        obs.append((a, (np.log10(a["lr"]) + 3.5) ** 2 + (a["gamma"] - 0.8) ** 2 + rng.random()))
    assert tpe.random_assignment(space, pyrandom.Random(5)) == \
        jax_tpe.random_assignment(space, pyrandom.Random(5))


def test_local_sweep_matches_jax(tmp_path, monkeypatch):
    """A 2-run grid over lr at 1 epoch, JAX's and the port's, each run from
    JAX's initial weights: the same assignments, the same validation bPQ and
    the same best run; then the CLI's `--sweep` writes its 2 results. Each
    sweep's run directories (≈0.5 GB of checkpoints a run) go once read."""
    root = make_pannuke_dataset(tmp_path / "data", folds=(0, 1, 2), n_images=4)

    def sweep_config(log_dir):
        config = make_config(root, log_dir)
        config["training"]["epochs"] = 1
        config["sweep"] = {"method": "grid", "name": "lr", "metric": {"name": "bPQ",
                                                                     "goal": "maximize"}}
        config["parameters"] = {"training.optimizer_hyperparameter.lr": {"values": [3e-6, 1e-6]}}
        return config

    captured = {}
    jax_load = jax_experiment.ExperimentCellVitPanNuke.load_pretrained

    def capture(self, model, variables):
        captured.setdefault("variables", jax.tree_util.tree_map(np.array, variables))
        return jax_load(self, model, variables)

    monkeypatch.setattr(jax_experiment.ExperimentCellVitPanNuke, "load_pretrained", capture)
    want_best, want = jax_sweeper.run_sweep(sweep_config(tmp_path / "jax"),
                                            jax_experiment.ExperimentCellVitPanNuke)
    shutil.rmtree(tmp_path / "jax")
    v = captured["variables"]
    state = state_dict_from_flax(v["params"], v["batch_stats"])
    monkeypatch.setattr(experiment.ExperimentCellVitPanNuke, "load_pretrained",
                        lambda self, model: load_state_dict_into(model, state) or model)
    cls = lambda cfg, **kw: experiment.ExperimentCellVitPanNuke(cfg, device="cpu", **kw)
    got_best, got = sweeper.run_sweep(sweep_config(tmp_path / "port"), cls)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["assignment"] == w["assignment"] and "error" not in g
        np.testing.assert_allclose(g["bPQ"], w["bPQ"], atol=1e-4)
    assert got_best["run"] == want_best["run"]
    results = json.loads((tmp_path / "port" / "sweep_results.json").read_text())
    assert [r["run"] for r in results["runs"]] == [0, 1] and results["orphaned"] == []
    shutil.rmtree(tmp_path / "port")

    # the CLI: --sweep on the card by default, here --device cpu
    config = sweep_config(tmp_path / "cli")
    path = tmp_path / "sweep.yaml"
    path.write_text(yaml_lite.dump(config))
    best = run_cellvit.main(["--config", str(path), "--device", "cpu", "--sweep"])
    results = json.loads((tmp_path / "cli" / "sweep_results.json").read_text())
    assert len(results["runs"]) == 2 and best["run"] in (0, 1)
    assert all(r["bPQ"] is not None and "error" not in r for r in results["runs"])
    shutil.rmtree(tmp_path / "cli")


def test_agent_claims_each_run_once(tmp_path):
    """`--agent`: a second agent joins a sweep and runs only what no claim
    covers; a stale claim is reported orphaned, and reclaimed on request."""
    import os
    import time

    config = {
        "logging": {"log_dir": str(tmp_path / "runs"), "log_comment": "x"},
        "sweep": {"method": "grid", "name": "claims", "metric": {"name": "bPQ", "goal": "maximize"}},
        "parameters": {"training.lr": {"values": [1, 2, 3]}},
    }
    sweep_dir = sweeper.create_sweep(config)
    assert sweeper.resolve_sweep_dir("claims", config) == sweep_dir
    stale = sweep_dir / "runs" / "run0.claim"
    stale.write_text("dead-agent")
    old = time.time() - 3600
    os.utime(stale, (old, old))
    ran = []

    class Fake:
        def __init__(self, cfg):
            self.cfg = cfg

        def run_experiment(self):
            lr = self.cfg["training"]["lr"]
            ran.append(lr)
            d = tmp_path / f"run_lr{lr}"
            d.mkdir(exist_ok=True)
            (d / "metrics.jsonl").write_text(json.dumps({"Validation/bPQ": lr / 10}) + "\n")
            return d, None, None

    best, records = sweeper.run_agent(sweep_dir, Fake, "agent-a")
    assert ran == [2, 3] and best["run"] == 2
    results = json.loads((tmp_path / "runs" / "sweep_results.json").read_text())
    assert results["orphaned"] == [0]
    best, records = sweeper.run_agent(sweep_dir, Fake, "agent-b", reclaim_after=60.0)
    assert ran == [2, 3, 1] and sorted(r["run"] for r in records) == [0, 1, 2]
