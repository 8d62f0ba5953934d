"""Port's training CLI against the JAX package on the same data and
weights: the experiment (config → datasets → trainer.fit → checkpoints) and
the CLI's resume (the evaluation: `tests/test_torch_eval_pannuke.py`).

Tolerance: per-epoch `metrics.jsonl` scalars within the trainer test's 1e-4
relative (`tests/test_torch_train.py`; at lr 3e-6 for the reason given
there).
"""

import json
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cellvit_tpu.train import experiment as jax_experiment
from cellvit_tpu_torch.cli import run_cellvit
from cellvit_tpu_torch.models.checkpoint_io import load_checkpoint, state_dict_from_flax
from cellvit_tpu_torch.models.checkpoint_io import load_state_dict_into
from cellvit_tpu_torch.train import experiment
from cellvit_tpu_torch.utils import yaml_lite
from tests.synth import make_pannuke_dataset

# one intra-op thread each: the suite runs as parallel pytest workers
torch.set_num_threads(1)

LR = 3e-6


def make_config(dataset_path: Path, log_dir: Path) -> dict:
    """A tiny CellViT (embed 64, depth 4) on 64² folds 0/1/2, 2 epochs with
    the encoder frozen in the first, cell+tissue sampling, normalize only."""
    return {
        "logging": {"mode": "offline", "log_dir": str(log_dir), "log_comment": "e2e",
                    "level": "INFO"},
        "random_seed": 19,
        "gpu": 0,
        "data": {"dataset": "PanNuke", "dataset_path": str(dataset_path), "train_folds": [0],
                 "val_folds": [1], "test_folds": [2], "num_nuclei_classes": 6,
                 "input_shape": 64, "magnification": 40},
        "model": {"backbone": "default", "embed_dim": 64, "depth": 4, "num_heads": 2,
                  "extract_layers": [1, 2, 3, 4]},
        "loss": {},
        "training": {"batch_size": 4, "epochs": 2, "unfreeze_epoch": 1, "optimizer": "AdamW",
                     "optimizer_hyperparameter": {"lr": LR, "betas": [0.85, 0.95],
                                                  "weight_decay": 1e-4},
                     "early_stopping_patience": 10,
                     "scheduler": {"scheduler_type": "exponential", "gamma": 0.85},
                     "sampling_strategy": "cell+tissue", "sampling_gamma": 0.85,
                     "eval_every": 1},
        "transformations": {"normalize": {"mean": [0.5, 0.5, 0.5], "std": [0.5, 0.5, 0.5]}},
        "eval_checkpoint": "latest_checkpoint",
    }


def _metric_lines(run_dir: Path):
    return [json.loads(line) for line in (Path(run_dir) / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX experiment, then the port's from JAX's initial weights. The
    run directories go when the module is done: each run's checkpoints take
    ≈0.5 GB (the decoder towers and the optimizer state)."""
    root = make_pannuke_dataset(tmp_path_factory.mktemp("pannuke"), folds=(0, 1, 2), n_images=8)
    base = tmp_path_factory.mktemp("runs")
    captured = {}
    jax_load = jax_experiment.ExperimentCellVitPanNuke.load_pretrained

    def capture(self, model, variables):
        # host copies: the JAX trainer donates its state's buffers
        captured["variables"] = jax.tree_util.tree_map(np.array, variables)
        return jax_load(self, model, variables)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_experiment.ExperimentCellVitPanNuke, "load_pretrained", capture)
    jax_run, _, _, _ = jax_experiment.ExperimentCellVitPanNuke(
        make_config(root, base / "jax")).run_experiment()
    v = captured["variables"]
    state = state_dict_from_flax(v["params"], v["batch_stats"])

    def from_jax(self, model):
        load_state_dict_into(model, state)
        return model

    mp.setattr(experiment.ExperimentCellVitPanNuke, "load_pretrained", from_jax)
    config = make_config(root, base / "port")
    port_run, model, trainer = experiment.ExperimentCellVitPanNuke(
        config, device="cpu").run_experiment()
    mp.undo()
    yield dict(root=root, base=base, config=config, jax_run=jax_run, port_run=port_run,
               trainer=trainer)
    shutil.rmtree(base, ignore_errors=True)


def test_run_directory_holds_the_artifacts(runs):
    run_dir = runs["port_run"]
    for name in ("config.yaml", "metrics.jsonl", "checkpoints/latest_checkpoint.pth",
                 "checkpoints/model_best.pth"):
        assert (run_dir / name).is_file(), name
    conf = yaml_lite.load((run_dir / "config.yaml").read_text())
    assert conf == runs["config"]
    lines = _metric_lines(run_dir)
    assert [(line["step"], next(iter(k for k in line if "/" in k)).split("/")[0]) for line in lines] \
        == [(0, "Train"), (0, "Validation"), (1, "Train"), (1, "Validation")]
    # the checkpoint carries the flattened run config and rebuilds the model
    model, _, run_conf = load_checkpoint(run_dir / "checkpoints" / "latest_checkpoint.pth")
    assert run_conf["training"]["sampling_strategy"] == "cell+tissue"
    tissues = yaml_lite.load((runs["root"] / "dataset_config.yaml").read_text())["tissue_types"]
    assert run_conf["data"]["num_tissue_classes"] == len(tissues) and model.embed_dim == 64


def test_epoch_scalars_match_jax(runs):
    jax_lines, port_lines = _metric_lines(runs["jax_run"]), _metric_lines(runs["port_run"])
    assert len(jax_lines) == len(port_lines) == 4
    for want, got in zip(jax_lines, port_lines):
        keys = {k for k in want if "/" in k}
        assert keys == {k for k in got if "/" in k}
        for k in sorted(keys):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {want['step']} {k}")


def test_cli_resumes_at_the_next_epoch(runs, tmp_path):
    """`--checkpoint` resumes after the checkpoint's epoch: a 3-epoch config
    from the 2-epoch run's checkpoint trains epoch 2 alone, then evaluates."""
    config = json.loads(json.dumps(runs["config"]))
    config["training"]["epochs"] = 3
    config["logging"]["log_dir"] = str(tmp_path)
    path = tmp_path / "train.yaml"
    path.write_text(yaml_lite.dump(config))
    ckpt = runs["port_run"] / "checkpoints" / "latest_checkpoint.pth"
    run_dir = run_cellvit.main(["--config", str(path), "--device", "cpu", "--checkpoint", str(ckpt)])
    assert [line["step"] for line in _metric_lines(run_dir)] == [2, 2]
    assert (run_dir / "inference_results.json").is_file()
    step = torch.load(str(run_dir / "checkpoints" / "latest_checkpoint.pth"),
                      weights_only=True)["optimizer_state_dict"]["step"]
    assert step == 3 * runs["trainer"].step // 2
    shutil.rmtree(run_dir)


@pytest.mark.parametrize("mode", ["offline", "online"])
def test_metric_logger_matches_jax(tmp_path, monkeypatch, mode):
    """`MetricLogger` writes JAX's JSON lines and `summary.json`; a run that
    asks for wandb where wandb does not import warns and keeps the files."""
    from cellvit_tpu.utils.logger import MetricLogger as JaxMetricLogger
    from cellvit_tpu_torch.utils.logger import MetricLogger

    monkeypatch.setitem(sys.modules, "wandb", None)
    records = [({"Train/loss": np.float32(0.25), "Train/lr": 3e-4}, 0),
               ({"Validation/bPQ": np.float64(0.5), "Validation/per_class": [1, 2]}, 1)]
    outputs = []
    for cls, name in ((JaxMetricLogger, "jax"), (MetricLogger, "port")):
        run_dir = tmp_path / name
        if mode == "online":
            with pytest.warns(UserWarning, match="wandb disabled"):
                logger = cls(run_dir, project="p", run_name="r", mode=mode, config={"a": 1})
        else:
            logger = cls(run_dir, project="p", run_name="r", mode=mode, config={"a": 1})
        assert logger.wandb_run is None
        for metrics, step in records:
            logger.log(metrics, step=step)
        logger.summary("best_bPQ", np.float32(0.5))
        logger.summary("epochs", 2)
        logger.close()
        lines = [{k: v for k, v in line.items() if k != "ts"} for line in _metric_lines(run_dir)]
        outputs.append((lines, json.loads((run_dir / "summary.json").read_text())))
    assert outputs[0] == outputs[1]
    assert outputs[1][1] == {"best_bPQ": 0.5, "epochs": 2}
