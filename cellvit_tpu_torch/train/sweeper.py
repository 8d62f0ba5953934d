"""Local hyperparameter sweeps (grid / random) with multi-agent support
(copy of `cellvit_tpu/train/sweeper.py`, on the port's experiments).

The reference delegates sweeps to wandb (`base_experiment.py:296-352` +
run_cellvit.py --sweep/--agent). wandb is optional here, so this module
provides a framework-owned executor with the same config schema: a `sweep`
block (method/name/metric/run_cap, validated by `train.validator`) and a
`parameters` block of dotted config paths with `values` lists (grid/random/
bayes) or `min`/`max` ranges (random/bayes). `method: bayes` runs a local
TPE optimizer (`train/tpe.py`) that proposes each run at claim time from
the results finished so far. Results land in <log_dir>/sweep_results.json
with the best run by the sweep metric.

Agent mode (reference run_cellvit.py:46-82 wandb.agent): `--sweep` creates a
sweep directory `<log_dir>/sweeps/<sweep_id>/` holding the frozen base config
plus the enumerated assignments, then runs as the first agent. `--agent
<sweep_dir-or-id>` joins that sweep from any process/host sharing the
filesystem: agents claim runs via atomic `O_EXCL` claim files, so each
assignment executes exactly once across all agents.
"""

from __future__ import annotations

import itertools
import json
import os
import random as pyrandom
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from cellvit_tpu_torch.train.experiment import flatten_dict, unflatten_dict
from cellvit_tpu_torch.train.validator import validate_sweep_config


def param_specs(parameters: Dict) -> Dict[str, Dict]:
    """Group trailing values/min/max/value/distribution leaves back onto
    their dotted parameter path."""
    params: Dict[str, Dict] = {}
    for key, val in flatten_dict(parameters).items():
        path, leaf = key.rsplit(".", 1)
        if leaf in ("values", "min", "max", "value", "distribution"):
            params.setdefault(path, {})[leaf] = val
    return params


def enumerate_configs(
    sweep_cfg: Dict, parameters: Dict, seed: int = 0
) -> List[Optional[Dict]]:
    """Sweep spec → list of flattened {param_path: value} assignments.

    For ``method: bayes`` the assignments are adaptive: this returns
    ``run_cap`` placeholders (``None``) and `run_agent` proposes each one at
    claim time with the TPE optimizer (`train/tpe.py`), conditioned on every
    result file present in the sweep at that moment."""
    method = sweep_cfg["method"]
    run_cap = sweep_cfg.get("run_cap")
    params = param_specs(parameters)

    rng = pyrandom.Random(seed)
    if method == "grid":
        names, options = [], []
        for path, spec in sorted(params.items()):
            if "values" in spec:
                names.append(path)
                options.append(list(spec["values"]))
            elif "value" in spec:
                names.append(path)
                options.append([spec["value"]])
            else:
                raise ValueError(f"grid sweep needs `values` for {path}")
        combos = [dict(zip(names, vals)) for vals in itertools.product(*options)]
        if run_cap:
            combos = combos[:run_cap]
        return combos

    if method == "bayes":
        return [None] * (run_cap or 10)  # proposed at claim time (TPE)

    n = run_cap or 10
    combos = []
    for _ in range(n):
        assignment = {}
        for path, spec in sorted(params.items()):
            if "values" in spec:
                assignment[path] = rng.choice(list(spec["values"]))
            elif "min" in spec and "max" in spec:
                lo, hi = spec["min"], spec["max"]
                if isinstance(lo, int) and isinstance(hi, int):
                    assignment[path] = rng.randint(lo, hi)
                else:
                    assignment[path] = rng.uniform(float(lo), float(hi))
            elif "value" in spec:
                assignment[path] = spec["value"]
        combos.append(assignment)
    return combos


def create_sweep(base_config: Dict, seed: int = 0) -> Path:
    """Materialize a sweep directory: frozen base config + assignments.

    Layout: ``<log_dir>/sweeps/<sweep_name>/sweep.json`` plus a ``runs/``
    subdirectory agents claim work from. Returns the sweep directory.
    """
    sweep_cfg = validate_sweep_config(base_config.get("sweep", {}))
    assignments = enumerate_configs(
        sweep_cfg, base_config.get("parameters", {}), seed=seed
    )
    log_dir = Path(base_config.get("logging", {}).get("log_dir", "runs"))
    name = sweep_cfg.get("name") or "sweep"
    # atomic creation: os.mkdir (no exist_ok) claims the name; concurrent
    # creators racing on the same name each settle on a distinct suffix
    (log_dir / "sweeps").mkdir(parents=True, exist_ok=True)
    i = 0
    while True:
        sweep_dir = log_dir / "sweeps" / (name if i == 0 else f"{name}_{i}")
        try:
            os.mkdir(sweep_dir)
            break
        except FileExistsError:
            i += 1
    (sweep_dir / "runs").mkdir(exist_ok=True)
    (sweep_dir / "sweep.json").write_text(
        json.dumps(
            {
                "sweep": sweep_cfg,
                "base_config": base_config,
                "assignments": assignments,
            },
            indent=2,
        )
    )
    return sweep_dir


def resolve_sweep_dir(agent_id: str, base_config: Optional[Dict] = None) -> Path:
    """--agent value → sweep directory. Accepts a filesystem path or a bare
    sweep id looked up under <log_dir>/sweeps/ (reference takes
    entity/project/sweep_id; locally the last component is the id).

    Name collisions get numeric suffixes at creation (`name`, `name_1`, …);
    a bare id resolves to the NEWEST such sweep, so an agent launched after
    a re-created sweep joins the live one, not the exhausted old one.
    """
    cand = Path(agent_id)
    if (cand / "sweep.json").exists():
        return cand
    sweep_id = agent_id.rstrip("/").rsplit("/", 1)[-1]
    if base_config:
        log_dir = Path(base_config.get("logging", {}).get("log_dir", "runs"))
        best: Optional[Tuple[int, Path]] = None
        for d in (log_dir / "sweeps").glob(f"{sweep_id}*"):
            if not (d / "sweep.json").exists():
                continue
            if d.name == sweep_id:
                n = 0
            elif d.name.startswith(sweep_id + "_"):
                suffix = d.name[len(sweep_id) + 1 :]
                if not suffix.isdigit():
                    continue
                n = int(suffix)
            else:
                continue
            if best is None or n > best[0]:
                best = (n, d)
        if best is not None:
            return best[1]
    raise FileNotFoundError(f"no sweep found for agent id {agent_id!r}")


def _propose_bayes(spec: Dict, runs_dir: Path, i: int) -> Dict:
    """TPE proposal for run ``i``: condition on every finished result file,
    persist the choice to ``run{i}.assignment.json`` so a reclaimed run
    re-executes the same point instead of silently moving the search."""
    from cellvit_tpu_torch.train import tpe

    persisted = runs_dir / f"run{i}.assignment.json"
    if persisted.exists():
        return json.loads(persisted.read_text())

    metric_cfg = spec["sweep"].get("metric", {"name": "bPQ", "goal": "maximize"})
    metric_name = metric_cfg.get("name", "bPQ")
    sign = -1.0 if metric_cfg.get("goal", "maximize") == "maximize" else 1.0
    observations = []
    for f in sorted(runs_dir.glob("run*.result.json")):
        rec = json.loads(f.read_text())
        val = rec.get(metric_name)
        if rec.get("assignment") is not None and val is not None:
            observations.append((rec["assignment"], sign * float(val)))
    params = param_specs(spec["base_config"].get("parameters", {}))
    # seed by (run index, evidence size): deterministic per sweep state, and
    # concurrent agents proposing without evidence don't all draw one point
    rng = pyrandom.Random(7919 * (i + 1) + len(observations))
    assignment = tpe.propose(params, observations, rng)
    persisted.write_text(json.dumps(assignment))
    return assignment


def run_agent(
    sweep_dir: Path,
    experiment_class,
    agent_name: str = "agent",
    reclaim_after: Optional[float] = None,
) -> Tuple[Dict, List[Dict]]:
    """Join a sweep: claim and execute unclaimed runs until none remain,
    then aggregate all finished results. Returns (best record, records).

    A hard-killed agent (OOM/SIGKILL) leaves a claim file with no matching
    result file; such runs are reported as ``orphaned`` in
    sweep_results.json. Pass ``reclaim_after`` (seconds) to delete claims
    older than that with no result before claiming, so a later agent re-runs
    them instead of the assignment silently disappearing."""
    sweep_dir = Path(sweep_dir)
    spec = json.loads((sweep_dir / "sweep.json").read_text())
    base_config = spec["base_config"]
    assignments = spec["assignments"]
    metric_cfg = spec["sweep"].get("metric", {"name": "bPQ", "goal": "maximize"})
    metric_name = metric_cfg.get("name", "bPQ")
    maximize = metric_cfg.get("goal", "maximize") == "maximize"
    runs_dir = sweep_dir / "runs"

    if reclaim_after is not None:
        now = time.time()
        for i in range(len(assignments)):
            claim = runs_dir / f"run{i}.claim"
            result = runs_dir / f"run{i}.result.json"
            try:
                stale = claim.exists() and not result.exists() and (
                    now - claim.stat().st_mtime > reclaim_after
                )
            except FileNotFoundError:
                continue  # claim vanished between exists() and stat()
            if stale:
                claim.unlink(missing_ok=True)

    for i, assignment in enumerate(assignments):
        claim = runs_dir / f"run{i}.claim"
        try:
            fd = os.open(claim, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            continue  # another agent owns this run
        with os.fdopen(fd, "w") as f:
            f.write(agent_name)
        if assignment is None:  # bayes: propose at claim time from results so far
            assignment = _propose_bayes(spec, runs_dir, i)
        cfg = unflatten_dict({**flatten_dict(base_config), **assignment})
        cfg.pop("sweep", None)
        cfg.pop("parameters", None)
        log_cfg = cfg.setdefault("logging", {})
        log_cfg["log_comment"] = f"{log_cfg.get('log_comment', 'sweep')}_run{i}"
        # a crashed run must still produce a result file: otherwise the
        # claim blocks every agent forever and the sweep silently shrinks
        # (wandb.agent likewise records crashed runs and moves on)
        record = {
            "run": i,
            "assignment": assignment,
            "agent": agent_name,
            metric_name: None,
        }
        try:
            experiment = experiment_class(cfg)
            run_dir, _, _ = experiment.run_experiment()
            record["run_dir"] = str(run_dir)
            # last validation metrics from the metrics log
            metrics_file = Path(run_dir) / "metrics.jsonl"
            if metrics_file.exists():
                for line in metrics_file.read_text().strip().splitlines():
                    rec = json.loads(line)
                    if f"Validation/{metric_name}" in rec:
                        record[metric_name] = rec[f"Validation/{metric_name}"]
        except Exception as e:  # noqa: BLE001 — survive and record any run failure
            record["error"] = f"{type(e).__name__}: {e}"
        (runs_dir / f"run{i}.result.json").write_text(json.dumps(record))

    records: List[Dict] = []
    for f in sorted(runs_dir.glob("run*.result.json")):
        records.append(json.loads(f.read_text()))
    # claims with no result = agent died hard mid-run (OOM/SIGKILL) —
    # surface them so the sweep doesn't silently shrink
    done = {r["run"] for r in records}
    orphaned = [
        i
        for i in range(len(assignments))
        if i not in done and (runs_dir / f"run{i}.claim").exists()
    ]
    scored = [r for r in records if r.get(metric_name) is not None]
    best = (
        max(scored, key=lambda r: r[metric_name])
        if maximize
        else min(scored, key=lambda r: r[metric_name])
    ) if scored else {}
    out_dir = Path(base_config.get("logging", {}).get("log_dir", "runs"))
    out_dir.mkdir(parents=True, exist_ok=True)
    # atomic snapshot of the result files present at write time; with
    # concurrent agents the last finisher writes the complete aggregate
    tmp = out_dir / f".sweep_results.{agent_name}.tmp"
    tmp.write_text(
        json.dumps({"best": best, "runs": records, "orphaned": orphaned}, indent=2)
    )
    os.replace(tmp, out_dir / "sweep_results.json")
    return best, records


def run_sweep(
    base_config: Dict,
    experiment_class,
    seed: int = 0,
) -> Tuple[Dict, List[Dict]]:
    """Create a sweep and run as its first agent (reference --sweep mode)."""
    sweep_dir = create_sweep(base_config, seed=seed)
    # surface the (possibly collision-renamed) directory so extra agents
    # know what to join
    print(f"sweep directory: {sweep_dir} (join with --agent {sweep_dir.name})")
    return run_agent(sweep_dir, experiment_class, agent_name="agent0")
