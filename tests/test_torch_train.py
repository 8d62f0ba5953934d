"""Port's training slice against the JAX package on the same inputs: the
losses, the optimizers and schedules, the model in train mode, the trainer's
loss trajectory and validation, and the plumbing around them (dropout
generators, the flash route in training, checkpoints, the copied modules,
the import guard).

Tolerances: losses and their gradients within 1e-5; optimizer trajectories
within 1e-5 relative (1e-4 for the adaptive optimizers whose bias
corrections the two frameworks round differently in fp32); the train-mode
model and its BatchNorm statistics within 2e-4 (docs/PARITY.md); the
trainer's losses within 1e-4 relative over 5 steps.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellvit_tpu.data import labels as jax_labels
from cellvit_tpu.eval import metrics as jax_metrics
from cellvit_tpu.models import CellViT as JaxCellViT
from cellvit_tpu.parallel import make_mesh
from cellvit_tpu.train import losses as jax_losses
from cellvit_tpu.train import optim as jax_optim
from cellvit_tpu.train.trainer import CellViTTrainer as JaxTrainer
from cellvit_tpu_torch import _build
from cellvit_tpu_torch.data import labels
from cellvit_tpu_torch.eval import metrics
from cellvit_tpu_torch.models import vit as torch_vit
from cellvit_tpu_torch.models.cellvit import CellViT
from cellvit_tpu_torch.models.checkpoint_io import load_checkpoint as load_model
from cellvit_tpu_torch.models.checkpoint_io import load_state_dict_into, state_dict_from_flax
from cellvit_tpu_torch.models.layers import drop_path, use_generator
from cellvit_tpu_torch.synthetic import TISSUE_TYPES, training_batch
from cellvit_tpu_torch.train import checkpoint, losses, optim
from cellvit_tpu_torch.train.trainer import CellViTTrainer, default_loss_fn_dict, prepare_batch
from test_torch_models import _random_variables

# one intra-op thread each: the suite runs as parallel pytest workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
KW = dict(num_nuclei_classes=6, num_tissue_classes=19, embed_dim=64, depth=4, num_heads=2,
          extract_layers=(1, 2, 3, 4))


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- losses


def _loss_inputs(name, rng):
    """(inputs, kwargs) of one registry loss; the first input is the one
    the gradient is taken in."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    probs = lambda *s: (lambda e: e / e.sum(-1, keepdims=True))(np.exp(f(*s)))
    onehot = lambda *s: np.eye(s[-1], dtype=np.float32)[rng.integers(0, s[-1], s[:-1])]
    labels_ = lambda n, *s: rng.integers(0, n, s).astype(np.int32)
    pm1 = lambda *s: np.where(rng.random(s) < 0.5, -1.0, 1.0).astype(np.float32)
    table = {
        "xentropy_loss": ((probs(2, 8, 8, 3), onehot(2, 8, 8, 3)), {}),
        "dice_loss": ((probs(2, 8, 8, 3), onehot(2, 8, 8, 3)), {}),
        "mse_loss_maps": ((f(2, 8, 8, 2), f(2, 8, 8, 2)), {}),
        "msge_loss_maps": ((f(2, 12, 12, 2), f(2, 12, 12, 2)), {"focus": onehot(2, 12, 12, 2)}),
        "FocalTverskyLoss": ((f(2, 8, 8, 2), labels_(2, 2, 8, 8)), {}),
        "MCFocalTverskyLoss": ((f(2, 8, 8, 3), labels_(3, 2, 8, 8)),
                               {"num_classes": 3, "class_weights": [0.5, 1.0, 2.0]}),
        "CrossEntropyLoss": ((f(4, 5), labels_(5, 4)), {"class_weights": [1, 2, 1, 1, 3]}),
        "L1Loss": ((f(3, 4), f(3, 4)), {}),
        "MSELoss": ((f(3, 4), f(3, 4)), {}),
        "NLLLoss": ((np.log(probs(4, 5)), labels_(5, 4)), {}),
        "PoissonNLLLoss": ((f(3, 4), np.abs(f(3, 4))), {}),
        "GaussianNLLLoss": ((f(3, 4), f(3, 4)), {"var": np.abs(f(3, 4)) + 0.1}),
        "KLDivLoss": ((np.log(probs(3, 4)), probs(3, 4)), {}),
        "BCELoss": ((probs(3, 2)[..., 0], (rng.random(3) < 0.5).astype(np.float32)), {}),
        "BCEWithLogitsLoss": ((f(3, 4), (rng.random((3, 4)) < 0.5).astype(np.float32)), {}),
        "MarginRankingLoss": ((f(6), f(6), pm1(6)), {"margin": 0.1}),
        "HingeEmbeddingLoss": ((f(6), pm1(6)), {}),
        "HuberLoss": ((2 * f(3, 4), f(3, 4)), {}),
        "SmoothL1Loss": ((2 * f(3, 4), f(3, 4)), {"beta": 0.5}),
        "SoftMarginLoss": ((f(3, 4), pm1(3, 4)), {}),
        "MultiLabelSoftMarginLoss": ((f(3, 4), (rng.random((3, 4)) < 0.5).astype(np.float32)), {}),
        "CosineEmbeddingLoss": ((f(5, 4), f(5, 4), pm1(5)), {"margin": 0.1}),
        "TripletMarginLoss": ((f(5, 4), f(5, 4), f(5, 4)), {}),
        "MultiMarginLoss": ((f(4, 5), labels_(5, 4)), {"p": 2, "margin": 0.5}),
        "MultiLabelMarginLoss": ((f(3, 5), np.array([[3, 0, -1, 1, 1], [1, 2, 4, -1, 0],
                                                     [0, 1, 2, 3, 4]], np.int32)), {}),
        "TripletMarginWithDistanceLoss": ((f(5, 4), f(5, 4), f(5, 4)), {"swap": True}),
    }
    return table[name]


HOVER = ["xentropy_loss", "dice_loss", "mse_loss_maps", "msge_loss_maps", "FocalTverskyLoss",
         "MCFocalTverskyLoss", "CrossEntropyLoss"]
TORCH_NAMED = ["L1Loss", "MSELoss", "NLLLoss", "PoissonNLLLoss", "GaussianNLLLoss", "KLDivLoss",
               "BCELoss", "BCEWithLogitsLoss", "MarginRankingLoss", "HingeEmbeddingLoss",
               "HuberLoss", "SmoothL1Loss", "SoftMarginLoss", "MultiLabelSoftMarginLoss",
               "CosineEmbeddingLoss", "TripletMarginLoss", "MultiMarginLoss",
               "MultiLabelMarginLoss", "TripletMarginWithDistanceLoss"]


@pytest.mark.parametrize("name", HOVER + TORCH_NAMED)
def test_loss_and_gradient_match_jax(name):
    inputs, kw = _loss_inputs(name, np.random.default_rng(len(name)))
    want_fn = jax_losses.retrieve_loss_fn(name)
    got_fn = losses.retrieve_loss_fn(name)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    tkw = {k: _t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    want, want_grad = jax.value_and_grad(
        lambda x: want_fn(x, *(jnp.asarray(a) for a in inputs[1:]), **jkw))(jnp.asarray(inputs[0]))
    x = _t(inputs[0]).requires_grad_()
    got = got_fn(x, *(_t(a) for a in inputs[1:]), **tkw)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["MAEWeighted", "MSEWeighted", "BCEWeighted", "CEWeighted",
                                  "L1LossWeighted", "CTCLoss"])
def test_stardist_losses_wait_for_their_slice(name):
    with pytest.raises(NotImplementedError, match="A8"):
        losses.retrieve_loss_fn(name)


# ------------------------------------------------------- optimizers


X0 = [np.array([1.5, -2.0, 0.3, 4.0], np.float32), np.array([[0.5, -0.7], [2.0, 0.1]], np.float32)]


def _grad(params):
    """Gradient of Σ (p − 1)² + 0.1·p⁴ over every tensor, in numpy."""
    return [2 * (p - 1.0) + 0.4 * p**3 for p in params]


def _jax_traj(name, hp, schedule, steps, frozen=()):
    tx = jax_optim.retrieve_optimizer(name, dict(hp), schedule)
    params = [jnp.asarray(p) for p in X0]
    state = tx.init(params)
    for i in range(steps):
        g = [jnp.zeros_like(p) if i in frozen and j == 0 else jnp.asarray(gg)
             for j, (p, gg) in enumerate(zip(params, _grad([np.asarray(p) for p in params])))]
        upd, state = tx.update(g, state, params)
        if i in frozen:  # the trainer's masking of frozen updates
            upd = [jnp.zeros_like(upd[0])] + list(upd[1:])
        params = [p + u for p, u in zip(params, upd)]
    return [np.asarray(p) for p in params]


def _torch_traj(name, hp, schedule, steps, frozen=()):
    tx = optim.retrieve_optimizer(name, dict(hp), schedule)
    params = [torch.from_numpy(p.copy()) for p in X0]
    state = tx.init(params)
    for i in range(steps):
        g = [torch.from_numpy(gg) for gg in _grad([p.numpy() for p in params])]
        if i in frozen:
            g[0] = torch.zeros_like(g[0])
        upd, state = tx.update(g, state, params)
        if i in frozen:
            upd = optim.masked(upd, [False] + [True] * (len(upd) - 1))
        params = [p + u for p, u in zip(params, upd)]
    return [p.numpy() for p in params]


OPTIMIZERS = [
    ("Adam", {"lr": 0.01}), ("Adam", {"lr": 0.01, "weight_decay": 0.1}),
    ("AdamW", {"lr": 0.01, "betas": (0.85, 0.95), "weight_decay": 1e-2}),
    ("Adamax", {"lr": 0.01, "weight_decay": 0.1}), ("RAdam", {"lr": 0.01}),
    ("RMSprop", {"lr": 0.01, "momentum": 0.9, "weight_decay": 0.1}),
    ("SGD", {"lr": 0.05}), ("SGD", {"lr": 0.05, "momentum": 0.9, "nesterov": True,
                                    "weight_decay": 0.1}),
    ("Adagrad", {"lr": 0.05, "weight_decay": 0.1}), ("Adadelta", {"lr": 0.5}),
    ("SparseAdam", {"lr": 0.01}), ("ASGD", {"lr": 0.05, "lambd": 1e-2, "alpha": 0.75}),
    ("Rprop", {"lr": 0.01}), ("LBFGS", {"lr": 0.1, "history_size": 3}),
]


@pytest.mark.parametrize("name,hp", OPTIMIZERS, ids=[f"{n}-{i}" for i, (n, _) in enumerate(OPTIMIZERS)])
def test_optimizer_trajectory_matches_optax(name, hp):
    steps = 8 if name == "RAdam" else 5  # RAdam rectifies from step 6 on
    sched_j = jax_optim.make_lr_schedule("exponential", hp["lr"], 10, 2, gamma=0.85)
    sched_t = optim.make_lr_schedule("exponential", hp["lr"], 10, 2, gamma=0.85)
    want = _jax_traj(name, hp, sched_j, steps)
    got = _torch_traj(name, hp, sched_t, steps)
    for a, w in zip(got, want):
        assert not np.allclose(w, X0[0] if w.shape == X0[0].shape else X0[1])
        np.testing.assert_allclose(a, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["constant", "exponential", "cosine", "none"])
def test_lr_schedules_match_jax(kind):
    want = jax_optim.make_lr_schedule(kind, 3e-4, 100, 7, gamma=0.85, eta_min=1e-5)
    got = optim.make_lr_schedule(kind, 3e-4, 100, 7, gamma=0.85, eta_min=1e-5)
    for step in (0, 6, 7, 100, 180, 360, 530, 699, 1000):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)


def test_adamw_counts_steps_globally_across_unfreezing():
    """Steps 0-2 with the first tensor frozen (zero gradient, masked update),
    then unfrozen: the port follows optax, whose bias correction counts
    every step, and not torch.optim.AdamW, which skips frozen parameters and
    so restarts their bias correction at unfreezing."""
    hp = {"lr": 0.01, "betas": (0.85, 0.95), "weight_decay": 1e-2}
    sched = lambda step: 0.01
    want = _jax_traj("AdamW", hp, sched, 6, frozen=(0, 1, 2))
    got = _torch_traj("AdamW", hp, sched, 6, frozen=(0, 1, 2))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a, w, rtol=1e-5, atol=1e-6)
    p = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in X0]
    opt = torch.optim.AdamW(p, lr=0.01, betas=(0.85, 0.95), weight_decay=1e-2)
    for i in range(6):
        for t, g in zip(p, _grad([t.detach().numpy() for t in p])):
            t.grad = None if (i < 3 and t is p[0]) else torch.from_numpy(g)
        opt.step()
    # the first unfrozen update of the frozen tensor differs by ≈ 1/(1 − β₁)
    # in m̂ between the two counts
    assert np.abs(p[0].detach().numpy() - want[0]).max() > 1e-3
    np.testing.assert_allclose(p[1].detach().numpy(), want[1], rtol=1e-4)


def test_multi_steps_matches_optax():
    import optax

    hp = {"lr": 0.01}
    sched = lambda step: 0.01
    jtx = optax.MultiSteps(jax_optim.retrieve_optimizer("Adam", hp, sched), every_k_schedule=3)
    ttx = optim.multi_steps(optim.retrieve_optimizer("Adam", hp, sched), 3)
    jp, tp = [jnp.asarray(x) for x in X0], [torch.from_numpy(x.copy()) for x in X0]
    js, ts = jtx.init(jp), ttx.init(tp)
    for i in range(7):
        scale = 1.0 + 0.3 * i  # a different gradient per micro-step
        ju, js = jtx.update([jnp.asarray(g * scale) for g in _grad([np.asarray(p) for p in jp])], js, jp)
        tu, ts = ttx.update([torch.from_numpy(g * scale) for g in _grad([p.numpy() for p in tp])], ts, tp)
        jp = [p + u for p, u in zip(jp, ju)]
        tp = [p + u for p, u in zip(tp, tu)]
        for a, w in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------ model in train mode


def test_train_mode_forward_and_batch_stats_match_jax(monkeypatch):
    """Train-mode forward (BatchNorm on batch statistics, the flash route
    through `FLASH_MIN_TOKENS` = 16 at 64²) and the updated running
    statistics, flax's biased batch variance, against
    `apply(train=True, mutable=["batch_stats"])`."""
    calls = []
    real = torch_vit.flash_attention
    monkeypatch.setattr(torch_vit, "FLASH_MIN_TOKENS", 16)
    monkeypatch.setattr(torch_vit, "flash_attention",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    jm = JaxCellViT(encoder_type="histo", **KW)
    variables = _random_variables(jm, (1, 64, 64, 3), 2, train=False)
    tm = CellViT(**KW).train()
    load_state_dict_into(tm, state_dict_from_flax(variables["params"], variables["batch_stats"]))
    x = np.random.default_rng(4).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    want, mutated = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    got = tm(torch.from_numpy(x))
    assert calls == [(2, 17, 2, 32)] * 4
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), atol=2e-4, err_msg=k)
    new_sd = state_dict_from_flax(variables["params"], mutated["batch_stats"])
    state = tm.state_dict()
    stats = [k for k in new_sd if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 35  # 2 + 3 + 2 + 1 skip-decoder and 3 × 9 tower BatchNorms
    for k in stats:
        np.testing.assert_allclose(state[k].numpy(), new_sd[k].numpy(), atol=2e-4, rtol=2e-4,
                                   err_msg=k)


def test_dropout_and_drop_path_follow_the_generator():
    torch.manual_seed(0)
    model = CellViT(**KW, drop_rate=0.2, drop_path_rate=0.3).train()
    x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32))
    gen = torch.Generator()
    use_generator(model, gen)
    runs = []
    for seed in (3, 3, 4):
        gen.manual_seed(seed)
        runs.append(model(x)["hv_map"].detach())
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    y = torch.ones((8, 3, 5))
    out = drop_path(y, 0.5, True, torch.Generator().manual_seed(0))
    kept = out[:, 0, 0] != 0
    assert torch.equal(out[kept], torch.full_like(out[kept], 2.0)) and 0 < kept.sum() < 8
    assert torch.equal(drop_path(y, 0.5, False), y)


@pytest.mark.parametrize("train,attn_drop,flash", [(True, 0.1, False), (True, 0.0, True),
                                                   (False, 0.1, True)])
def test_attention_dropout_never_reaches_the_flash_route(monkeypatch, train, attn_drop, flash):
    calls = []
    real = torch_vit.flash_attention
    monkeypatch.setattr(torch_vit, "FLASH_MIN_TOKENS", 16)
    monkeypatch.setattr(torch_vit, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model = CellViT(**KW, attn_drop_rate=attn_drop).train(train)
    model(torch.zeros((1, 64, 64, 3)))
    assert bool(calls) == flash


# ---------------------------------------------------------------- trainer


def _jax_losses():
    spec = {"nuclei_binary_map": {"bce": "xentropy_loss", "dice": "dice_loss"},
            "hv_map": {"mse": "mse_loss_maps", "msge": "msge_loss_maps"},
            "nuclei_type_map": {"bce": "xentropy_loss", "dice": "dice_loss"},
            "tissue_types": {"ce": "CrossEntropyLoss"}}
    return {b: {n: {"loss_fn": jax_losses.retrieve_loss_fn(f), "weight": 1} for n, f in d.items()}
            for b, d in spec.items()}


@pytest.fixture(scope="module")
def trainer_pair():
    jm = JaxCellViT(encoder_type="histo", **KW)
    variables = _random_variables(jm, (1, 64, 64, 3), 5, train=False)
    # AdamW's first updates are lr·sign(g): coordinates whose gradient is
    # rounding noise (the conv biases ahead of BatchNorm, zero in exact
    # arithmetic) move by ±lr in either framework, which carries fp32
    # rounding into the trajectory in proportion to lr. At 3e-6 the two
    # trajectories stay within a few 1e-6 over 5 steps; at the config's 3e-4
    # they part by ≈1e-4 after one step.
    hp = {"lr": 3e-6, "betas": (0.85, 0.95), "weight_decay": 1e-4}
    jtx = jax_optim.retrieve_optimizer(
        "AdamW", hp, jax_optim.make_lr_schedule("exponential", 3e-6, 10, 2, gamma=0.85))
    jt = JaxTrainer(jm, _jax_losses(), jtx, num_classes=6, tissue_types=TISSUE_TYPES,
                    mesh=make_mesh())
    tm = CellViT(**KW)
    load_state_dict_into(tm, state_dict_from_flax(variables["params"], variables["batch_stats"]))
    ttx = optim.retrieve_optimizer(
        "AdamW", hp, optim.make_lr_schedule("exponential", 3e-6, 10, 2, gamma=0.85))
    tt = CellViTTrainer(tm, default_loss_fn_dict(), ttx, num_classes=6, tissue_types=TISSUE_TYPES,
                        device="cpu")
    batches = [training_batch(2, 64, seed) for seed in range(3)]
    return jt, jt.create_state(variables), tt, batches


def test_trainer_loss_trajectory_matches_jax(trainer_pair, monkeypatch):
    """5 steps on 3 seeded batches in fp32, the encoder frozen for the first
    two (unfreezing exercises the global bias-correction count), with the
    port's attention on the flash route (B1 and the B8 backward's plain
    twins on the CPU): every loss part within 1e-4 relative, the argmax
    metrics equal; then the validation epoch's losses and bPQ."""
    monkeypatch.setattr(torch_vit, "FLASH_MIN_TOKENS", 16)
    jt, state, tt, batches = trainer_pair
    for i in range(5):
        raw = batches[i % 3]
        frozen = i < 2
        state, want = jt.train_step(state, prepare_batch(raw, TISSUE_TYPES),
                                    jax.random.PRNGKey(i), frozen)
        got = tt._host(tt.train_step(tt.to_device(prepare_batch(raw, TISSUE_TYPES)), frozen))
        want = jax.device_get(want)
        assert set(got) == set(want)
        for k in got:
            if k in ("dice", "jaccard", "tissue_acc"):  # argmax counts: equal
                assert got[k] == pytest.approx(float(want[k]), rel=1e-6), (i, k)
            else:
                np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-4, err_msg=f"{i} {k}")
    want_scalars, want_pq = jt.validation_epoch(state, batches[:2], epoch=0)
    got_scalars, got_pq = tt.validation_epoch(batches[:2], epoch=0)
    assert got_pq == pytest.approx(want_pq, abs=1e-6)
    for k, v in want_scalars.items():
        np.testing.assert_allclose(got_scalars[k], v, rtol=1e-4, atol=1e-6, err_msg=k)


def test_frozen_step_trains_only_decoders_and_head():
    torch.manual_seed(1)
    tt = CellViTTrainer(CellViT(**KW), default_loss_fn_dict(),
                        optim.retrieve_optimizer("AdamW", {"lr": 1e-3}, lambda s: 1e-3), 6,
                        TISSUE_TYPES, device="cpu")
    before = {n: p.detach().clone() for n, p in zip(tt.param_names, tt.params)}
    tt.train_step(tt.to_device(prepare_batch(training_batch(2, 64, 7), TISSUE_TYPES)), True)
    for n, p in zip(tt.param_names, tt.params):
        changed = not torch.equal(p.detach(), before[n])
        if n.startswith("encoder.") and not n.startswith("encoder.head."):
            assert not changed, n
    assert not torch.equal(tt.params[tt.param_names.index("encoder.head.weight")],
                           before["encoder.head.weight"])
    assert tt.step == 1 and tt.opt_state["parts"][0]["parts"][0]["count"] == 1


def test_checkpoint_round_trip(tmp_path):
    torch.manual_seed(2)
    make = lambda: CellViTTrainer(
        CellViT(**KW), default_loss_fn_dict(),
        optim.retrieve_optimizer("AdamW", {"lr": 1e-3}, lambda s: 1e-3), 6, TISSUE_TYPES,
        device="cpu")
    tt = make()
    loader = [training_batch(2, 64, 8)]
    tt.train_epoch(loader, 0)
    path = tmp_path / "latest_checkpoint.pth"
    checkpoint.save_checkpoint(path, tt, epoch=3)
    fresh = make()
    meta = checkpoint.load_checkpoint(path, fresh)
    assert meta["epoch"] == 3 and meta["arch"] == "CellViT" and fresh.step == tt.step == 1
    for a, b in zip(tt.params, fresh.params):
        assert torch.equal(a, b)
    model, _, run_conf = load_model(path)  # the inference loader reads it back
    assert run_conf["model"]["depth"] == 4
    for k, v in model.state_dict().items():
        assert torch.equal(v, tt.model.state_dict()[k]), k
    mu_a = tt.opt_state["parts"][0]["parts"][0]["mu"]
    mu_b = fresh.opt_state["parts"][0]["parts"][0]["mu"]
    assert all(torch.equal(a, b) for a, b in zip(mu_a, mu_b))
    # the next step of both is the same step
    batch = tt.to_device(prepare_batch(loader[0], TISSUE_TYPES))
    for t in (tt, fresh):
        t.generator.manual_seed(0)
    assert tt._host(tt.train_step(batch, False)) == fresh._host(fresh.train_step(batch, False))


def test_fit_runs_epochs_with_checkpoints_and_early_stopping(tmp_path):
    from cellvit_tpu_torch.train.early_stopping import EarlyStopping

    torch.manual_seed(3)
    tt = CellViTTrainer(CellViT(**KW, drop_path_rate=0.1), default_loss_fn_dict(),
                        optim.retrieve_optimizer("AdamW", {"lr": 1e-3}, lambda s: 1e-3), 6,
                        TISSUE_TYPES, device="cpu")
    loader = [training_batch(2, 64, 9)]
    stop = EarlyStopping(patience=1, strategy="minimize")
    logs = []
    tt.fit(4, loader, loader, unfreeze_epoch=1, early_stopping=stop, monitor="Total_Loss",
           checkpoint_dir=tmp_path, seed=5, log_fn=logs.append)
    assert (tmp_path / "latest_checkpoint.pth").exists() and (tmp_path / "model_best.pth").exists()
    assert any(line.startswith("epoch 1/4") for line in logs)
    assert tt.step == sum(1 for line in logs if line.startswith("epoch"))


# -------------------------------------------------------- copied modules


def test_copied_label_and_metric_modules_match_jax():
    raw = training_batch(1, 96, 4)
    inst = raw["masks/instance_map"][0]
    np.testing.assert_array_equal(labels.gen_instance_hv_map(inst),
                                  jax_labels.gen_instance_hv_map(inst))
    np.testing.assert_array_equal(raw["masks/hv_map"][0], jax_labels.gen_instance_hv_map(inst))
    pred = np.roll(inst, 2, axis=1)
    a = metrics.get_fast_pq(metrics.remap_label(inst), metrics.remap_label(pred))
    b = jax_metrics.get_fast_pq(jax_metrics.remap_label(inst), jax_metrics.remap_label(pred))
    assert a[0] == b[0]


def test_port_and_smoke_script_import_no_jax():
    """No file of the port, and not `chip_smoke.py`, imports jax, flax,
    optax or the JAX package."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|cellvit_tpu)(\.|\s|$)",
                         re.MULTILINE)
    files = sorted((ROOT / "cellvit_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 25
    assert [f.name for f in files if pattern.search(f.read_text())] == []
    assert _build.LAUNCHES  # the counts exist without a card
