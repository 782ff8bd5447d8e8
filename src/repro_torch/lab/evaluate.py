"""Catalog evaluation: tuned vs default vs best-static, per scenario.

The port of the reference's ``repro/lab/evaluate.py``.  Every scenario
runs as ``|Θ| + 1`` batch elements: one frozen element per static
configuration (the Lustre default ``(256, 8)`` is element
``SPACE.index_of(DEFAULT)``) plus one DIAL-tuned element.  The static
sweep is the "best static" oracle of the paper's Table II; the DIAL
element is tuned by the fleet machinery restricted to its own columns.

With ``ragged`` (the default) the whole catalog pools its arms into a
handful of padded shape buckets, one :func:`~repro_torch.lab.batch.
run_batch` each, on the fused path and (unlike the reference, which
pools only there) on the host path too; rows are identical either way.

Output is a JSON report plus a markdown table (Table II / Fig. 3
analogs over the catalog), written by :func:`write_report` and the
``python -m repro_torch.lab evaluate`` CLI.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.config_space import DEFAULT, SPACE
from repro_torch.core.model import DIALModel
from repro_torch.core.tuner import TunerParams
from repro_torch.lab.batch import bucket_scenarios, run_batch, stack_scenarios
from repro_torch.lab.scenarios import (SCENARIOS, ScenarioSpec, build,
                                       get_scenario)


@dataclasses.dataclass
class ScenarioResult:
    """One scenario's policy comparison (MB/s aggregated over the run)."""

    scenario: str
    tags: tuple
    n_clients: int
    n_osts: int
    default_mbs: float
    initial_mbs: float                # static θ₀ (what DIAL started from)
    best_static_mbs: float
    best_static_theta: tuple
    dial_mbs: float
    dial_vs_default: float
    dial_vs_initial: float            # the recovery story
    dial_frac_of_best_static: float
    changes: int                      # knob changes DIAL applied

    def row(self) -> dict:
        d = dataclasses.asdict(self)
        d["tags"] = list(self.tags)
        d["best_static_theta"] = list(self.best_static_theta)
        return d


def _checked_device(model: DIALModel, device):
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"evaluate on {dev}: model on {model.device}")
    return dev


def evaluate_scenario(spec: ScenarioSpec, model: DIALModel,
                      seconds: float = 10.0, interval: float = 0.5,
                      tuner_params: TunerParams | None = None,
                      fused: bool = True, mesh=None, graph: bool | None = None,
                      device=None) -> ScenarioResult:
    """One scenario under every static θ plus DIAL, in one batch on
    ``device`` (``None``: the CUDA card; the model must be there).

    ``fused=True`` (default) runs the comparison on the device, each
    interval one CUDA-graph replay on the card (``graph=False``: eager);
    ``fused=False`` keeps the per-interval host loop.  ``mesh`` splits
    the |Θ|+1 arms over its devices (fused only; ``run_batch``'s).
    """
    dev = _checked_device(model, device)
    configs = SPACE.configs()
    m = len(configs)
    built = [build(dataclasses.replace(spec, initial_theta=tuple(theta)))
             for theta in configs + [spec.initial_theta]]
    batch = stack_scenarios(built, device=dev)
    n = batch.n_osc
    dial_cols = m * n + np.arange(n)       # the last element is the tuned one
    fleet = run_batch(batch, model=model, seconds=seconds,
                      interval=interval, tuner_params=tuner_params,
                      tune_cols=dial_cols, fused=fused, mesh=mesh,
                      graph=graph)
    tput = batch.throughput(seconds)["total_mbs"]
    changes = sum(int(r.decisions.changed.sum()) for r in fleet.decisions)
    return _make_result(spec, tput, changes, configs)


def _make_result(spec: ScenarioSpec, tput, changes: int,
                 configs) -> ScenarioResult:
    """Assemble one scenario's result from its |Θ|+1 arm throughputs
    (shared by the per-scenario and the ragged catalog paths)."""
    m = len(configs)
    static = tput[:m]
    best = int(np.argmax(static))
    default_mbs = float(static[SPACE.index_of(DEFAULT)])
    theta0 = (int(spec.initial_theta[0]), int(spec.initial_theta[1]))
    initial_mbs = (float(static[SPACE.index_of(theta0)])
                   if theta0 in configs else default_mbs)
    dial_mbs = float(tput[m])
    return ScenarioResult(
        scenario=spec.name,
        tags=spec.tags,
        n_clients=spec.n_clients,
        n_osts=spec.n_osts,
        default_mbs=default_mbs,
        initial_mbs=initial_mbs,
        best_static_mbs=float(static[best]),
        best_static_theta=configs[best],
        dial_mbs=dial_mbs,
        dial_vs_default=dial_mbs / max(default_mbs, 1e-9),
        dial_vs_initial=dial_mbs / max(initial_mbs, 1e-9),
        dial_frac_of_best_static=dial_mbs / max(float(static[best]), 1e-9),
        changes=changes,
    )


def catalog_arms(specs) -> tuple:
    """Every spec's |Θ|+1 arms as built scenarios (one per static θ of
    Θ, in order, then DIAL's from the spec's initial θ) and each arm's
    ``(spec index, arm index)``."""
    configs = SPACE.configs()
    built, owners = [], []
    for si, spec in enumerate(specs):
        for ai, theta in enumerate(configs + [spec.initial_theta]):
            built.append(build(dataclasses.replace(
                spec, initial_theta=tuple(theta))))
            owners.append((si, ai))
    return built, owners


def _evaluate_catalog_ragged(specs, model: DIALModel, seconds: float,
                             interval: float, fused: bool,
                             graph: bool | None, device, mesh=None,
                             tuner_params: TunerParams | None = None):
    """The whole heterogeneous catalog in one ``run_batch`` per bucket.

    Every spec contributes its |Θ|+1 arms to one pool, grouped by padded
    shape class (:func:`~repro_torch.lab.batch.bucket_scenarios`); each
    bucket runs ragged in one ``run_batch``.  Per-arm figures are
    bit-equal to the per-scenario path (padding neutrality, ordered
    real-column sums), so the rows are identical.

    Returns ``(results_in_spec_order, n_buckets, n_dispatches)``.
    """
    configs = SPACE.configs()
    m = len(configs)
    built, owners = catalog_arms(specs)
    buckets = bucket_scenarios(built, device=device)
    tputs = {}
    changes = dict.fromkeys(range(len(specs)), 0)
    n_dispatches = 0
    for idxs, batch in buckets:
        n = batch.n_osc
        dial_elems = [e for e, gi in enumerate(idxs) if owners[gi][1] == m]
        tune_cols = np.concatenate(
            [e * n + batch.element_cols(e) for e in dial_elems])
        res = run_batch(batch, model=model, seconds=seconds,
                        interval=interval, tuner_params=tuner_params,
                        tune_cols=tune_cols, fused=fused, mesh=mesh,
                        graph=graph)
        n_dispatches += 1
        tp = batch.throughput(seconds)["total_mbs"]
        for e, gi in enumerate(idxs):
            tputs[owners[gi]] = float(tp[e])
        for r in res.decisions:
            elems = np.asarray(r.oscs) // n
            ch = np.asarray(r.decisions.changed)
            for e in np.unique(elems):
                si = owners[idxs[int(e)]][0]
                changes[si] += int(ch[elems == e].sum())
    results = []
    for si, spec in enumerate(specs):
        tput = np.array([tputs[(si, ai)] for ai in range(m + 1)])
        results.append(_make_result(spec, tput, changes[si], configs))
    return results, len(buckets), n_dispatches


def evaluate(names=None, model: DIALModel | None = None,
             seconds: float = 10.0, interval: float = 0.5,
             fused: bool = True, mesh=None, ragged: bool = True,
             graph: bool | None = None, device=None) -> dict:
    """Run the catalog (default: every registered scenario) on ``device``
    (``None``: the CUDA card) and return the report dict (rows +
    summary).

    ``ragged=True`` (default) pools every scenario's arms and runs the
    mixed catalog in one ``run_batch`` per padded shape bucket, on
    either path; the summary gains ``n_buckets`` / ``n_dispatches``.
    ``ragged=False`` runs one batch per scenario; rows are identical
    either way.  ``graph=False`` keeps the fused path's eager interval;
    ``mesh`` (fused only) splits each batch over its devices.
    """
    dev = resolve_device(device)
    if model is None:
        model = default_model(device=dev)
    _checked_device(model, dev)
    names = list(names) if names else list(SCENARIOS)
    stats = None
    if ragged and len(names) > 1:
        specs = [get_scenario(n) for n in names]
        results, n_buckets, n_dispatches = _evaluate_catalog_ragged(
            specs, model, seconds, interval, fused, graph, dev, mesh)
        rows = [r.row() for r in results]
        stats = {"n_buckets": n_buckets, "n_dispatches": n_dispatches}
    else:
        rows = [evaluate_scenario(get_scenario(name), model,
                                  seconds=seconds, interval=interval,
                                  fused=fused, mesh=mesh, graph=graph,
                                  device=dev).row()
                for name in names]
    speedups = [r["dial_vs_default"] for r in rows]
    fracs = [r["dial_frac_of_best_static"] for r in rows]
    report = {
        "seconds": seconds,
        "interval": interval,
        "scenarios": rows,
        "summary": {
            "n_scenarios": len(rows),
            "mean_dial_vs_default": float(np.mean(speedups)),
            "min_dial_vs_default": float(np.min(speedups)),
            "mean_dial_frac_of_best_static": float(np.mean(fracs)),
            "min_dial_frac_of_best_static": float(np.min(fracs)),
        },
    }
    if stats is not None:
        report["summary"].update(stats)
    return report


def render_markdown(report: dict) -> str:
    """The report as a markdown table (Table II analog over the catalog)."""
    lines = [
        "# Scenario Lab report",
        "",
        f"{report['summary']['n_scenarios']} scenarios, "
        f"{report['seconds']:.0f} s each, tuning every "
        f"{report['interval']} s.",
        "",
        "| scenario | default MB/s | θ₀ MB/s | best static MB/s (θ) | "
        "DIAL MB/s | DIAL/default | DIAL/θ₀ | DIAL/best | changes |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in report["scenarios"]:
        th = "×".join(str(int(x)) for x in r["best_static_theta"])
        lines.append(
            f"| {r['scenario']} | {r['default_mbs']:.1f} | "
            f"{r['initial_mbs']:.1f} | "
            f"{r['best_static_mbs']:.1f} ({th}) | {r['dial_mbs']:.1f} | "
            f"{r['dial_vs_default']:.2f}x | {r['dial_vs_initial']:.2f}x | "
            f"{100 * r['dial_frac_of_best_static']:.1f}% | "
            f"{r['changes']} |")
    s = report["summary"]
    lines += [
        "",
        f"Mean DIAL vs default: **{s['mean_dial_vs_default']:.2f}x** "
        f"(min {s['min_dial_vs_default']:.2f}x); mean fraction of best "
        f"static: **{100 * s['mean_dial_frac_of_best_static']:.1f}%** "
        f"(min {100 * s['min_dial_frac_of_best_static']:.1f}%).",
        "",
    ]
    return "\n".join(lines)


def write_report(report: dict, out_dir: str) -> tuple[str, str]:
    os.makedirs(out_dir, exist_ok=True)
    jpath = os.path.join(out_dir, "report.json")
    mpath = os.path.join(out_dir, "report.md")
    with open(jpath, "w") as f:
        json.dump(report, f, indent=2)
    with open(mpath, "w") as f:
        f.write(render_markdown(report))
    return jpath, mpath


def default_model(smoke: bool = False, root: str = "models/lab",
                  device=None) -> DIALModel:
    """Best available model on ``device``: campaign artifact under
    ``root`` -> trained ``models/dial`` prefix -> a fresh campaign (which
    also leaves a versioned artifact behind).

    A non-smoke caller never silently inherits a smoke-grade campaign
    artifact: versions whose manifest carries ``smoke: true`` are only
    eligible when ``smoke`` is requested.
    """
    from repro_torch.lab.campaign import (CampaignConfig, latest_version,
                                          load_versioned, run_campaign,
                                          smoke_campaign)
    dev = resolve_device(device)
    v = latest_version(root)
    if v is not None:
        try:
            with open(os.path.join(root, v, "manifest.json")) as f:
                is_smoke = bool(json.load(f).get("smoke", False))
        except (OSError, ValueError):
            is_smoke = False
        if smoke or not is_smoke:
            return load_versioned(root, version=v, device=dev)
    try:
        return DIALModel.load("models/dial", device=dev)
    except FileNotFoundError:
        pass
    if smoke:
        cfg, gbdt = smoke_campaign()
    else:
        cfg, gbdt = CampaignConfig(reps=2), None
    _, model, _ = run_campaign(cfg, out_root=root, gbdt_params=gbdt,
                               smoke=smoke, device=dev)
    return model
