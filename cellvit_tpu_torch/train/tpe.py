"""Tree-structured Parzen Estimator for `method: bayes` sweeps (copy of
`cellvit_tpu/train/tpe.py`).

The reference delegates Bayesian sweeps to wandb's hosted optimizer
(`base_ml/base_experiment.py:296-352` + run_cellvit.py --sweep). wandb is
optional here, so this module provides a local sequential-model-based
optimizer with the same parameter schema the sweeper already validates:

- ``values: [...]``            → categorical
- ``min: a, max: b``           → uniform (int or float by the bound types)
- ``distribution: log_uniform``→ sample the min/max range in log space
- ``value: x``                 → constant

The algorithm is standard TPE (Bergstra et al., "Algorithms for
Hyper-Parameter Optimization", NeurIPS 2011): split the observed scores at
the γ-quantile into a *good* set and a *bad* set, fit a Parzen mixture
l(x) to the good set and g(x) to the bad set per parameter, draw
candidates from l and keep the one maximizing l(x)/g(x). Pure stdlib —
deterministic under a seeded ``random.Random``.
"""

from __future__ import annotations

import math
import random as pyrandom
from typing import Dict, List, Optional, Sequence, Tuple

Observation = Tuple[Dict[str, object], float]  # (assignment, loss — lower is better)

N_STARTUP = 5  # pure random until this many scored observations exist
N_CANDIDATES = 24
GAMMA = 0.25


def random_assignment(params: Dict[str, Dict], rng: pyrandom.Random) -> Dict[str, object]:
    """One uniform draw from the parameter space (also the startup sampler)."""
    out: Dict[str, object] = {}
    for path, spec in sorted(params.items()):
        if "values" in spec:
            out[path] = rng.choice(list(spec["values"]))
        elif "min" in spec and "max" in spec:
            lo, hi = spec["min"], spec["max"]
            if _is_log(spec):
                out[path] = math.exp(rng.uniform(math.log(lo), math.log(hi)))
            elif isinstance(lo, int) and isinstance(hi, int):
                out[path] = rng.randint(lo, hi)
            else:
                out[path] = rng.uniform(float(lo), float(hi))
        elif "value" in spec:
            out[path] = spec["value"]
    return out


def _is_log(spec: Dict) -> bool:
    return str(spec.get("distribution", "")).startswith("log_uniform")


def _to_internal(spec: Dict, v: float) -> float:
    return math.log(v) if _is_log(spec) else float(v)


def _from_internal(spec: Dict, v: float) -> object:
    x = math.exp(v) if _is_log(spec) else v
    lo, hi = spec["min"], spec["max"]
    x = min(max(x, float(lo)), float(hi))
    if isinstance(lo, int) and isinstance(hi, int) and not _is_log(spec):
        return min(max(int(round(x)), lo), hi)
    return x


class _ParzenMixture:
    """1-D mixture of Gaussians over observed values + a wide prior center.

    Bandwidths follow the hyperopt heuristic: each center's σ is the larger
    gap to its sorted neighbors, clipped to [range/min(100,n+2), range].
    """

    def __init__(self, values: Sequence[float], lo: float, hi: float):
        span = max(hi - lo, 1e-12)
        centers = sorted(values) + [(lo + hi) / 2.0]  # uniform-ish prior center
        centers.sort()
        n = len(centers)
        sigmas = []
        for i, c in enumerate(centers):
            left = centers[i] - centers[i - 1] if i > 0 else span
            right = centers[i + 1] - centers[i] if i < n - 1 else span
            sigmas.append(max(left, right))
        s_min = span / min(100.0, n + 2.0)
        self.centers = centers
        self.sigmas = [min(max(s, s_min), span) for s in sigmas]
        self.lo, self.hi = lo, hi

    def sample(self, rng: pyrandom.Random) -> float:
        i = rng.randrange(len(self.centers))
        for _ in range(10):  # soft truncation to the box
            x = rng.gauss(self.centers[i], self.sigmas[i])
            if self.lo <= x <= self.hi:
                return x
        return min(max(x, self.lo), self.hi)

    def logpdf(self, x: float) -> float:
        acc = 0.0
        for c, s in zip(self.centers, self.sigmas):
            z = (x - c) / s
            acc += math.exp(-0.5 * z * z) / (s * math.sqrt(2 * math.pi))
        return math.log(max(acc / len(self.centers), 1e-300))


class _CategoricalModel:
    """Laplace-smoothed category frequencies."""

    def __init__(self, values: Sequence[object], choices: Sequence[object]):
        # keys by repr: choices may be unhashable-equal (1 vs 1.0) in YAML
        self.choices = list(choices)
        counts = [1.0] * len(self.choices)  # +1 prior keeps every arm alive
        index = {repr(c): i for i, c in enumerate(self.choices)}
        for v in values:
            i = index.get(repr(v))
            if i is not None:
                counts[i] += 1.0
        total = sum(counts)
        self.probs = [c / total for c in counts]

    def sample(self, rng: pyrandom.Random) -> object:
        r = rng.random()
        acc = 0.0
        for c, p in zip(self.choices, self.probs):
            acc += p
            if r <= acc:
                return c
        return self.choices[-1]

    def logpdf(self, v: object) -> float:
        for c, p in zip(self.choices, self.probs):
            if repr(c) == repr(v):
                return math.log(p)
        return math.log(1e-12)


def propose(
    params: Dict[str, Dict],
    observations: List[Observation],
    rng: pyrandom.Random,
    n_candidates: int = N_CANDIDATES,
    gamma: float = GAMMA,
    n_startup: int = N_STARTUP,
) -> Dict[str, object]:
    """Next assignment to evaluate. ``observations`` carry losses (lower is
    better; the sweeper negates maximize-metrics before calling)."""
    scored = [(a, s) for a, s in observations if s is not None and math.isfinite(s)]
    if len(scored) < n_startup:
        return random_assignment(params, rng)

    scored.sort(key=lambda t: t[1])
    n_good = max(1, math.ceil(gamma * len(scored)))
    good = [a for a, _ in scored[:n_good]]
    bad = [a for a, _ in scored[n_good:]] or good

    best_assignment: Optional[Dict[str, object]] = None
    best_score = -math.inf
    models: Dict[str, Tuple[object, object, Dict]] = {}
    for path, spec in sorted(params.items()):
        if "values" in spec:
            choices = list(spec["values"])
            l_m = _CategoricalModel([a[path] for a in good if path in a], choices)
            g_m = _CategoricalModel([a[path] for a in bad if path in a], choices)
        elif "min" in spec and "max" in spec:
            lo = _to_internal(spec, spec["min"])
            hi = _to_internal(spec, spec["max"])
            l_m = _ParzenMixture(
                [_to_internal(spec, a[path]) for a in good if path in a], lo, hi
            )
            g_m = _ParzenMixture(
                [_to_internal(spec, a[path]) for a in bad if path in a], lo, hi
            )
        else:
            continue  # constant
        models[path] = (l_m, g_m, spec)

    for _ in range(n_candidates):
        assignment: Dict[str, object] = {}
        score = 0.0
        for path, spec in sorted(params.items()):
            if path not in models:
                if "value" in spec:
                    assignment[path] = spec["value"]
                continue
            l_m, g_m, spec = models[path]
            x = l_m.sample(rng)
            score += l_m.logpdf(x) - g_m.logpdf(x)
            assignment[path] = (
                x if "values" in spec else _from_internal(spec, x)
            )
        if score > best_score:
            best_score, best_assignment = score, assignment
    assert best_assignment is not None
    return best_assignment
