"""The port's test-fold evaluation (`inference/eval_pannuke.py`) against the
JAX package's evaluator run on the same port run directory (JAX reads the
`.pth`), and the CLI's device flags.

Tolerance: `inference_results.json` metrics within 1e-4.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from cellvit_tpu_torch.cli import base_cli, run_cellvit
from cellvit_tpu_torch.inference.eval_pannuke import InferenceCellViT
from cellvit_tpu_torch.models.checkpoint_io import load_checkpoint
from cellvit_tpu_torch.train import experiment
from cellvit_tpu_torch.utils import yaml_lite
from test_torch_experiment import make_config
from tests.synth import make_pannuke_dataset

# one intra-op thread each: the suite runs as parallel pytest workers
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A one-epoch port run of the experiment test's config (its ≈0.5 GB of
    checkpoints go when the module is done)."""
    root = make_pannuke_dataset(tmp_path_factory.mktemp("pannuke"), folds=(0, 1, 2), n_images=8)
    config = make_config(root, tmp_path_factory.mktemp("runs"))
    config["training"]["epochs"] = 1
    run_dir, _, _ = experiment.ExperimentCellVitPanNuke(config, device="cpu").run_experiment()
    yield run_dir
    shutil.rmtree(run_dir, ignore_errors=True)


def test_evaluation_matches_jax_on_the_same_run(port_run):
    """The port's evaluator and JAX's on the port's run directory (JAX reads
    the `.pth`): the same dataset, tissue and nucleus metrics within 1e-4."""
    from cellvit_tpu.inference.eval_pannuke import InferenceCellViT as JaxInference

    run_dir = port_run
    got = InferenceCellViT(run_dir, "latest_checkpoint", device="cpu").run_patch_inference()
    want = JaxInference(run_dir, "latest_checkpoint.pth").run_patch_inference()
    assert set(got) == set(want)
    for section in ("dataset", "tissue_metrics", "nuclei_metrics_pq"):
        flat_got = experiment.flatten_dict(got[section])
        flat_want = experiment.flatten_dict(want[section])
        assert flat_got.keys() == flat_want.keys()
        for k, v in flat_want.items():
            np.testing.assert_allclose(flat_got[k], v, atol=1e-4, err_msg=f"{section} {k}")
    results = json.loads((run_dir / "inference_results.json").read_text())
    assert all(np.isfinite(results["dataset"][k]) for k in ("bPQ", "bDQ", "bSQ", "f1_detection"))


def test_evaluation_of_probe_weights_matches_jax(port_run):
    """The same on a checkpoint whose maps follow the synthetic nuclei (the
    probe weights of `synthetic.set_probe_weights`), so that both evaluators
    find and pair instances: every metric within 1e-4, and bPQ above 0.5."""
    from cellvit_tpu.inference.eval_pannuke import InferenceCellViT as JaxInference
    from cellvit_tpu_torch.synthetic import set_probe_weights

    ckpt_dir = port_run / "checkpoints"
    ckpt = torch.load(str(ckpt_dir / "latest_checkpoint.pth"), weights_only=True)
    model, _, _ = load_checkpoint(ckpt_dir / "latest_checkpoint.pth")
    with torch.no_grad():
        set_probe_weights(model)
    ckpt["model_state_dict"] = model.state_dict()
    torch.save(ckpt, str(ckpt_dir / "probe.pth"))
    got = InferenceCellViT(port_run, "probe", device="cpu").run_patch_inference()
    want = JaxInference(port_run, "probe.pth").run_patch_inference()
    for section in ("dataset", "tissue_metrics", "nuclei_metrics_pq", "nuclei_metrics_d",
                    "image_metrics"):
        flat_got = experiment.flatten_dict(got[section])
        flat_want = experiment.flatten_dict(want[section])
        assert flat_got.keys() == flat_want.keys()
        for k, v in flat_want.items():
            np.testing.assert_allclose(flat_got[k], v, atol=1e-4, err_msg=f"{section} {k}")
    assert got["dataset"]["bPQ"] > 0.5, got["dataset"]


def test_checkpoint_name_with_or_without_suffix(port_run):
    a = InferenceCellViT(port_run, "model_best", device="cpu")
    b = InferenceCellViT(port_run, "model_best.pth", device="cpu")
    for (k, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), k


def test_cli_device_flags(tmp_path, monkeypatch):
    path = tmp_path / "train.yaml"
    path.write_text(yaml_lite.dump({"gpu": 0, "data": {"dataset": "PanNuke"}}))
    parser = base_cli.ExperimentBaseParser()
    for argv, want in ((["--device", "cpu"], "cpu"), ([], "cuda:0"), (["--gpu", "1"], "cuda:1"),
                       (["--gpu", "1", "--device", "cpu"], "cpu")):
        config, args = parser.parse_arguments(["--config", str(path), *argv])
        assert base_cli.run_device(config, args) == want, argv
    # on the card by default: without one, the CLI refuses rather than fall back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_cellvit.main(["--config", str(path)])
