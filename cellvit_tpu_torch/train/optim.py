"""Optimizer registry and LR schedules (port of `cellvit_tpu/train/optim.py`).

The JAX package builds its 12 optimizers as optax gradient transforms and
trains on their trajectory, so this module reproduces optax's arithmetic
rather than wrapping `torch.optim`: each optimizer is a `Transform`, a pair
`init(params) -> state` and `update(updates, state, params) ->
(updates, state)` over a list of tensors, chained as optax chains them and
applied by the caller as `p += update`. Two optax behaviours matter to the
trainer and differ from `torch.optim`:

- one global step count per transform (Adam's bias correction, the
  schedule), advanced on every update whether or not a parameter is frozen:
  frozen parameters receive zero gradients and the caller masks their
  updates, so unfreezing does not restart their bias correction;
- the schedule is read at the count before the update (step 0 first).

`MultiSteps` is `optax.MultiSteps` with the gradient mean. Counts are Python
ints, moments fp32 tensors on the parameters' device; a state is a dict that
`torch.save` takes as it is.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Sequence, Tuple

import torch

Tensors = List[torch.Tensor]
State = Dict


class Transform(NamedTuple):
    init: Callable[[Tensors], State]
    update: Callable[[Tensors, State, Tensors], Tuple[Tensors, State]]


def _zeros(params: Tensors) -> Tensors:
    return [torch.zeros_like(p) for p in params]


def _bias_correction(moment: Tensors, decay: float, count: int) -> Tensors:
    """moment / (1 − decay**count), the power in fp32 as optax takes it."""
    bc = 1.0 - torch.tensor(decay, dtype=torch.float32) ** count
    return [m / bc.to(m.device) for m in moment]


def _vdot(a: Tensors, b: Tensors) -> torch.Tensor:
    return sum((x * y).sum() for x, y in zip(a, b))


def identity() -> Transform:
    return Transform(lambda params: {}, lambda u, s, p=None: (u, s))


def chain(*parts: Transform) -> Transform:
    def init(params):
        return {"parts": [t.init(params) for t in parts]}

    def update(updates, state, params=None):
        new = []
        for t, s in zip(parts, state["parts"]):
            updates, s = t.update(updates, s, params)
            new.append(s)
        return updates, {"parts": new}

    return Transform(init, update)


def scale(factor: float) -> Transform:
    return Transform(lambda params: {}, lambda u, s, p=None: ([g * factor for g in u], s))


def scale_by_schedule(step_size_fn: Callable[[int], float]) -> Transform:
    def update(updates, state, params=None):
        step = float(step_size_fn(state["count"]))
        return [g * step for g in updates], {"count": state["count"] + 1}

    return Transform(lambda params: {"count": 0}, update)


def scale_by_learning_rate(schedule: Callable[[int], float]) -> Transform:
    return scale_by_schedule(lambda count: -1.0 * schedule(count))


def add_decayed_weights(weight_decay: float) -> Transform:
    def update(updates, state, params):
        return [g + weight_decay * p for g, p in zip(updates, params)], state

    return Transform(lambda params: {}, update)


def trace(decay: float, nesterov: bool = False) -> Transform:
    def update(updates, state, params=None):
        new = [g + decay * t for g, t in zip(updates, state["trace"])]
        out = [g + decay * t for g, t in zip(updates, new)] if nesterov else new
        return out, {"trace": new}

    return Transform(lambda params: {"trace": _zeros(params)}, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Transform:
    def init(params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update(updates, state, params=None):
        mu = [(1 - b1) * g + b1 * m for g, m in zip(updates, state["mu"])]
        nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(updates, state["nu"])]
        count = state["count"] + 1
        mu_hat, nu_hat = _bias_correction(mu, b1, count), _bias_correction(nu, b2, count)
        out = [m / (torch.sqrt(v) + eps) for m, v in zip(mu_hat, nu_hat)]
        return out, {"count": count, "mu": mu, "nu": nu}

    return Transform(init, update)


def scale_by_rms(decay: float = 0.9, eps: float = 1e-8) -> Transform:
    def update(updates, state, params=None):
        nu = [(1 - decay) * (g * g) + decay * v for g, v in zip(updates, state["nu"])]
        return [torch.rsqrt(v + eps) * g for g, v in zip(updates, nu)], {"nu": nu}

    return Transform(lambda params: {"nu": _zeros(params)}, update)


def scale_by_radam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   threshold: float = 5.0) -> Transform:
    ro_inf = 2.0 / (1.0 - b2) - 1.0

    def init(params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update(updates, state, params=None):
        mu = [(1 - b1) * g + b1 * m for g, m in zip(updates, state["mu"])]
        nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(updates, state["nu"])]
        count = state["count"] + 1
        b2t = torch.tensor(b2, dtype=torch.float32) ** count
        ro = ro_inf - 2 * count * b2t / (1 - b2t)
        mu_hat, nu_hat = _bias_correction(mu, b1, count), _bias_correction(nu, b2, count)
        if ro >= threshold:
            r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
            out = [r.to(m.device) * m / (torch.sqrt(v) + eps) for m, v in zip(mu_hat, nu_hat)]
        else:
            out = mu_hat
        return out, {"count": count, "mu": mu, "nu": nu}

    return Transform(init, update)


def scale_by_rss(initial_accumulator_value: float = 0.1, eps: float = 1e-7) -> Transform:
    def init(params):
        return {"sum_of_squares": [torch.full_like(p, initial_accumulator_value) for p in params]}

    def update(updates, state, params=None):
        sos = [g * g + t for g, t in zip(updates, state["sum_of_squares"])]
        out = [torch.where(t > 0, torch.rsqrt(t + eps), torch.zeros_like(t)) * g
               for g, t in zip(updates, sos)]
        return out, {"sum_of_squares": sos}

    return Transform(init, update)


def scale_by_adadelta(rho: float = 0.9, eps: float = 1e-6) -> Transform:
    def init(params):
        return {"e_g": _zeros(params), "e_x": _zeros(params)}

    def update(updates, state, params=None):
        e_g = [(1 - rho) * (g * g) + rho * e for g, e in zip(updates, state["e_g"])]
        out = [torch.sqrt(ex + eps) / torch.sqrt(eg + eps) * g
               for g, eg, ex in zip(updates, e_g, state["e_x"])]
        e_x = [(1 - rho) * (u * u) + rho * e for u, e in zip(out, state["e_x"])]
        return out, {"e_g": e_g, "e_x": e_x}

    return Transform(init, update)


def scale_by_adamax(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Transform:
    def init(params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update(updates, state, params=None):
        count = state["count"] + 1
        mu = [(1 - b1) * g + b1 * m for g, m in zip(updates, state["mu"])]
        nu = [torch.maximum(g.abs() + eps, b2 * v) for g, v in zip(updates, state["nu"])]
        out = [m / v for m, v in zip(_bias_correction(mu, b1, count), nu)]
        return out, {"count": count, "mu": mu, "nu": nu}

    return Transform(init, update)


def _l2(kw: Dict, inner: Transform) -> Transform:
    """torch-style coupled weight decay: L2 added to the gradient before the
    adaptive scaling (every torch optimizer but AdamW)."""
    wd = kw.get("weight_decay", 0.0)
    return chain(add_decayed_weights(wd), inner) if wd else inner


def _betas(kw: Dict) -> tuple:
    return tuple(kw.get("betas", (0.9, 0.999)))


def _adam(kw: Dict) -> Transform:
    b1, b2 = _betas(kw)
    return _l2(kw, scale_by_adam(b1, b2, kw.get("eps", 1e-8)))


def _adamw(kw: Dict) -> Transform:
    b1, b2 = _betas(kw)
    return chain(scale_by_adam(b1, b2, kw.get("eps", 1e-8)),
                 add_decayed_weights(kw.get("weight_decay", 1e-2)))


def _sgd(kw: Dict) -> Transform:
    parts = []
    if kw.get("weight_decay", 0.0):
        parts.append(add_decayed_weights(kw["weight_decay"]))
    if kw.get("momentum", 0.0):
        parts.append(trace(kw["momentum"], kw.get("nesterov", False)))
    return chain(*parts) if parts else identity()


def _rmsprop(kw: Dict) -> Transform:
    m = kw.get("momentum", 0.0)
    return _l2(kw, chain(scale_by_rms(kw.get("alpha", 0.99), kw.get("eps", 1e-8)),
                         trace(m) if m else identity()))


def _radam(kw: Dict) -> Transform:
    b1, b2 = _betas(kw)
    return _l2(kw, scale_by_radam(b1, b2, kw.get("eps", 1e-8)))


def _adagrad(kw: Dict) -> Transform:
    return _l2(kw, scale_by_rss(kw.get("initial_accumulator_value", 0.0), kw.get("eps", 1e-10)))


def _adadelta(kw: Dict) -> Transform:
    return _l2(kw, scale_by_adadelta(kw.get("rho", 0.9), kw.get("eps", 1e-6)))


def _adamax(kw: Dict) -> Transform:
    b1, b2 = _betas(kw)
    return _l2(kw, scale_by_adamax(b1, b2, kw.get("eps", 1e-8)))


def _sparse_adam(kw: Dict) -> Transform:
    """SparseAdam on dense gradients is Adam (it has no weight decay)."""
    return _adam({k: v for k, v in kw.items() if k != "weight_decay"})


def _asgd(kw: Dict) -> Transform:
    """torch.optim.ASGD's parameter trajectory: p ← p·(1 − λ·η_t) −
    η_t·(g + wd·p), η_t = lr/(1 + λ·lr·t)^α, emitted as
    (g + (wd + λ)·p)·(η_t/lr) for the chained −lr."""
    lambd, alpha = kw.get("lambd", 1e-4), kw.get("alpha", 0.75)
    lr0, wd = kw.get("_base_lr", 1e-2), kw.get("weight_decay", 0.0)

    def update(updates, state, params):
        t = state["t"]
        factor = 1.0 / (1.0 + lambd * lr0 * t) ** alpha
        return [(g + (wd + lambd) * p) * factor for g, p in zip(updates, params)], {"t": t + 1}

    return Transform(lambda params: {"t": 0}, update)


def _rprop(kw: Dict) -> Transform:
    """torch.optim.Rprop: sign-adaptive per-coordinate step sizes (etas
    0.5/1.2, bounds 1e-6/50, lr the initial step); a sign flip shrinks the
    step and skips that coordinate's update. Emits the full update."""
    eta_minus, eta_plus = kw.get("etas", (0.5, 1.2))
    step_min, step_max = kw.get("step_sizes", (1e-6, 50.0))
    lr = kw.get("_base_lr", 1e-2)

    def init(params):
        return {"prev_grad": _zeros(params), "step_size": [torch.full_like(p, lr) for p in params]}

    def update(updates, state, params=None):
        sign = [torch.sign(g * pg) for g, pg in zip(updates, state["prev_grad"])]
        ss = [torch.where(s > 0, st * eta_plus, torch.where(s < 0, st * eta_minus, st))
              .clamp(step_min, step_max) for s, st in zip(sign, state["step_size"])]
        g_eff = [torch.where(s < 0, torch.zeros_like(g), g) for s, g in zip(sign, updates)]
        out = [torch.sign(g) * st for g, st in zip(g_eff, ss)]
        return out, {"prev_grad": g_eff, "step_size": ss}

    return Transform(init, update)


def _lbfgs(kw: Dict) -> Transform:
    """optax.scale_by_lbfgs (scaled initial preconditioner): the L-BFGS
    two-loop direction over `history_size` past differences; the step size
    is the schedule's, where torch's LBFGS runs a line search."""
    m = kw.get("history_size", 10)

    def init(params):
        return {"count": 0, "params": _zeros(params), "updates": _zeros(params),
                "dw": [[torch.zeros_like(p) for p in params] for _ in range(m)],
                "du": [[torch.zeros_like(p) for p in params] for _ in range(m)],
                "rho": [torch.zeros((), device=params[0].device) for _ in range(m)]}

    def update(updates, state, params):
        count = state["count"]
        idx, prev = count % m, (count - 1) % m
        dw, du, rho = list(state["dw"]), list(state["du"]), list(state["rho"])
        if count > 0:
            d_w = [p - q for p, q in zip(params, state["params"])]
            d_u = [g - h for g, h in zip(updates, state["updates"])]
            vd = _vdot(d_u, d_w)
            weight = torch.where(vd == 0.0, torch.zeros_like(vd), 1.0 / vd)
            den = _vdot(d_u, d_u)
            gamma = torch.where(den > 0.0, vd / den, torch.ones_like(den))
        else:
            d_w, d_u = _zeros(params), _zeros(params)
            weight = torch.zeros((), device=params[0].device)
            norm = torch.sqrt(_vdot(updates, updates))
            gamma = torch.minimum(torch.ones_like(norm), 1.0 / norm)
        dw[prev], du[prev], rho[prev] = d_w, d_u, weight
        order = [(idx + i) % m for i in range(m)]
        vec, alphas = list(updates), {}
        for i in reversed(order):
            alphas[i] = rho[i] * _vdot(dw[i], vec)
            vec = [v - alphas[i] * u for v, u in zip(vec, du[i])]
        vec = [gamma * v for v in vec]
        for i in order:
            beta = rho[i] * _vdot(du[i], vec)
            vec = [v + (alphas[i] - beta) * w for v, w in zip(vec, dw[i])]
        new = {"count": count + 1, "params": [p.clone() for p in params],
               "updates": list(updates), "dw": dw, "du": du, "rho": rho}
        return vec, new

    return Transform(init, update)


OPTI_DICT: Dict[str, Callable[[Dict], Transform]] = {
    "Adadelta": _adadelta,
    "Adagrad": _adagrad,
    "Adam": _adam,
    "AdamW": _adamw,
    "Adamax": _adamax,
    "RAdam": _radam,
    "RMSprop": _rmsprop,
    "SGD": _sgd,
    "SparseAdam": _sparse_adam,
    "ASGD": _asgd,
    "Rprop": _rprop,
    "LBFGS": _lbfgs,
}


def constant_schedule_multiplier(epoch: int) -> float:
    """The reference's 'constant' schedule: ×1 for 25 epochs, ×0.1 for 25,
    ×1 for 25, then ×0.1 (experiment_cellvit_pannuke.py:442-452)."""
    return 1.0 if epoch < 25 else 0.1 if epoch < 50 else 1.0 if epoch < 75 else 0.1


def make_lr_schedule(scheduler_type: str, base_lr: float, epochs: int, steps_per_epoch: int,
                     gamma: float = 0.95, eta_min: float = 1e-5) -> Callable[[int], float]:
    """step → learning rate, a per-epoch multiplier with the epoch derived
    from the global step (the reference steps its scheduler per epoch)."""
    t = scheduler_type.lower()

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        if t == "exponential":
            return base_lr * gamma**epoch
        if t == "cosine":
            frac = min(epoch / max(epochs, 1), 1.0)
            return eta_min + 0.5 * (base_lr - eta_min) * (1 + math.cos(math.pi * frac))
        if t == "constant":
            return base_lr * constant_schedule_multiplier(epoch)
        return base_lr

    return schedule


def retrieve_optimizer(name: str, hyperparams: Dict, lr_schedule: Callable[[int], float]) -> Transform:
    """`-lr(step) · transform(grads)` for a named optimizer."""
    if name not in OPTI_DICT:
        raise KeyError(f"unknown optimizer {name}; options: {sorted(OPTI_DICT)}")
    kw = dict(hyperparams)
    base_lr = kw.pop("lr", None)
    if base_lr is not None:
        kw["_base_lr"] = base_lr
    if name == "Rprop":  # lr is only the initial step size
        return chain(OPTI_DICT[name](kw), scale(-1.0))
    if name != "ASGD":
        kw.pop("_base_lr", None)
    return chain(OPTI_DICT[name](kw), scale_by_learning_rate(lr_schedule))


def multi_steps(inner: Transform, every_k: int) -> Transform:
    """optax.MultiSteps with the gradient mean: accumulate `every_k`
    gradients, then update once with their mean; zero updates between."""

    def init(params):
        return {"mini_step": 0, "gradient_step": 0, "inner": inner.init(params),
                "acc": _zeros(params)}

    def update(updates, state, params):
        n = state["mini_step"]
        acc = [a + (g - a) / (n + 1) for g, a in zip(updates, state["acc"])]
        if n == every_k - 1:
            out, inner_state = inner.update(acc, state["inner"], params)
            return out, {"mini_step": 0, "gradient_step": state["gradient_step"] + 1,
                         "inner": inner_state, "acc": _zeros(acc)}
        return _zeros(acc), dict(state, mini_step=n + 1, acc=acc)

    return Transform(init, update)


def tree_to(state, device: torch.device):
    """A state (nested dicts and lists of tensors and ints) on `device`."""
    if isinstance(state, dict):
        return {k: tree_to(v, device) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [tree_to(v, device) for v in state]
    return state.to(device) if isinstance(state, torch.Tensor) else state


def masked(updates: Sequence[torch.Tensor], trainable: Sequence[bool]) -> Tensors:
    """Zero the updates of frozen parameters (decoupled weight decay must not
    touch them)."""
    return [u if keep else torch.zeros_like(u) for u, keep in zip(updates, trainable)]
