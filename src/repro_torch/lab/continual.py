"""Continual in-lab retraining: a scenario that refits its model mid-run.

The port of the reference's ``repro/lab/continual.py``.  The evaluate
path tunes every scenario with a frozen offline model, so scenarios
whose storage drifts mid-run (``degraded_ost``, ``failing_ost``) are
scored by a model that never saw the post-drift regime.  Here:

* every interval, the agent's applied θ is labeled one interval later
  with the paper's improvement criterion (``tput_{t+1}/tput_t > 1 +
  eps``) and pushed into per-op
  :class:`~repro_torch.learn.online.ReplayBuffer` rings;
* an epsilon-greedy sprinkle of random θ keeps the on-policy stream
  from collapsing onto one configuration;
* :class:`~repro_torch.learn.online.OnlineTrainer` watches the fleet's
  throughput for drift and refits the forests (one
  :func:`~repro_torch.learn.boost.fit_forest_batch` on the model's
  device), swapping them into the live model between intervals.

Each interval is one :class:`~repro_torch.lab.batch.BatchEngine`
interval, then one :class:`~repro_torch.core.fleet.FleetAgent` tick, on
the batch's device.  What decides a refit or an exploration draw stays
on the host, as the reference computes it: the throughput series, the
labels and the θ checksums are numpy float64 over volumes copied off
the device, and the exploration stream is numpy's ``default_rng(seed)``
drawing exactly the reference's draws per decided interval.

``run_comparison`` drives one scenario twice (frozen model vs online
refit) and reports pre/post-failure throughput for both;
``run_hard_case_curriculum`` replays a fuzz report's triaged losers as
a weighted curriculum and re-races them.  CLI: ``python -m
repro_torch.lab continual [--hard-from REPORT]``.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.config_space import SPACE
from repro_torch.core.dataset import EPS_IMPROVE
from repro_torch.core.fleet import FleetAgent
from repro_torch.core.gbdt import GBDTParams
from repro_torch.core.metrics import (feature_dim, fleet_feature_matrix,
                                      snapshot_all)
from repro_torch.core.model import DIALModel
from repro_torch.core.tuner import TunerParams
from repro_torch.lab.batch import BatchEngine, BatchPort, stack_scenarios
from repro_torch.lab.scenarios import ScenarioSpec, build, get_scenario
from repro_torch.learn.online import OnlinePolicy, OnlineTrainer
from repro_torch.pfs.state import READ, WRITE


@dataclasses.dataclass
class ContinualResult:
    """One policy's run of one drifting scenario."""

    scenario: str
    online: bool
    seconds: float
    interval: float
    t_fail: float                 # first disturbance onset (inf if none)
    tput_mbs: list                # per-interval fleet MB/s
    theta_trace: list             # per-interval checksum of applied θ
    refits: list                  # OnlineTrainer refit records
    samples: dict                 # labeled rows collected per op
    pre_fail_mbs: float
    post_fail_mbs: float          # mean over every post-onset interval
    post_tail_mbs: float          # mean over the later post-onset half
    changes: int

    def row(self) -> dict:
        return dataclasses.asdict(self)


def _first_onset(spec: ScenarioSpec) -> float:
    starts = [ev.start for ev in spec.events]
    return min(starts) if starts else math.inf


def run_continual(spec: ScenarioSpec, model: DIALModel, *,
                  online: bool = True, seconds: float = 30.0,
                  interval: float = 0.5,
                  policy: OnlinePolicy | None = None,
                  gbdt_params: GBDTParams | None = None,
                  seed_data: dict | None = None,
                  tuner_params: TunerParams | None = None,
                  seed: int = 0, device=None) -> ContinualResult:
    """Drive one scenario with DIAL tuning and (optionally) online refit,
    on ``device`` (``None``: the CUDA card; the model must be there).

    The labeling loop mirrors the campaign's explore/label recipe, but
    on-policy: each interval's *applied* θ (the agent's decision, or an
    epsilon-greedy random θ) becomes a pending sample labeled by the
    next interval's throughput ratio.
    """
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"run_continual on {dev}: model on {model.device}")
    rng = np.random.default_rng(seed)
    policy = policy if policy is not None else OnlinePolicy()
    tuner_params = tuner_params if tuner_params is not None else TunerParams()
    batch = stack_scenarios([build(spec)], device=dev)
    port = BatchPort(batch)
    fleet = FleetAgent(port, model, tuner_params=tuner_params, device=dev)
    trainer = None
    if online:
        trainer = OnlineTrainer(model, gbdt_params, policy=policy)
        if seed_data is not None:
            trainer.seed(seed_data)

    steps = max(int(round(interval / batch.params.tick)), 1)
    n_intervals = int(round(seconds / interval))
    engine = BatchEngine(batch.params, batch.fleet, steps)
    theta_feats = torch.as_tensor(SPACE.as_features(), device=dev)
    configs = SPACE.configs()
    m = len(configs)
    width = max(feature_dim(READ, fleet.k), feature_dim(WRITE, fleet.k))
    host = lambda t: t.cpu().numpy()  # noqa: E731

    prev = port.probe_all()
    hist: collections.deque = collections.deque(maxlen=fleet.k + 1)
    pending = None       # (rows, ops, feats, tput) awaiting next label
    series: list[float] = []
    theta_trace: list[float] = []
    n_samples = {READ: 0, WRITE: 0}

    for _ in range(n_intervals):
        t0 = float(batch.state.now)
        sched = batch.schedule(int(round(t0 / batch.params.tick)),
                               steps).to(dev)
        batch.state, batch.wstate = engine.run_interval(
            batch.table, batch.state, batch.wstate, sched)

        cur = port.probe_all()
        snap = snapshot_all(prev, cur)
        prev = cur
        hist.append(snap)
        # the series drives the drift detector: the reference's numpy
        # float64 sum, over volumes copied to the host (and the per-op
        # throughputs the labels compare)
        read_vol, write_vol = host(snap.read_volume), host(snap.write_volume)
        read_tput, write_tput = host(snap.read[:, 0]), host(snap.write[:, 0])
        series.append(float((read_vol + write_vol).sum() / snap.dt / 1e6))

        # label the previous interval's applied configurations
        if pending is not None and trainer is not None:
            rows, ops_p, feats, tput0 = pending
            op_tput = np.where(ops_p == READ, read_tput[rows],
                               write_tput[rows])
            vol = np.where(ops_p == READ, read_vol[rows], write_vol[rows])
            ok = (tput0 > 0) & (vol >= fleet.min_volume)
            for op in (READ, WRITE):
                sel = ok & (ops_p == op)
                if sel.any():
                    labels = (op_tput[sel] / tput0[sel]
                              > 1.0 + EPS_IMPROVE).astype(float)
                    trainer.observe(op, feats[sel], labels)
                    n_samples[op] += int(sel.sum())
        pending = None

        # the agent's tuning tick (probes the same state again)
        result = fleet.tick()

        if len(result):
            rows = result.oscs.numpy().copy()       # cols == osc ids here
            ops_r = result.ops.numpy().copy()
            theta = result.decisions.theta.numpy().copy()
            # epsilon-greedy: some rows explore a random θ instead.  The
            # frozen arm draws the identical schedule (same rng stream),
            # so frozen vs online isolates the refits
            explore = rng.random(len(rows)) < policy.explore_eps
            if explore.any():
                j = rng.integers(m, size=int(explore.sum()))
                theta[explore] = np.asarray([configs[x] for x in j])
                # the agent reads the applied θ from its next probe, so
                # this out-of-band flip is seen by construction
                port.set_knobs_many(rows[explore], theta[explore, 0],
                                    theta[explore, 1])
            # position-weighted checksum of the applied (row, θ) block:
            # frozen and online traces agree until the first refit
            w = np.arange(theta.size, dtype=np.float64) + 1.0
            theta_trace.append(float(theta.ravel() @ w + float(rows.sum())))
        else:
            theta_trace.append(0.0)

        if trainer is not None and len(result):
            # feature rows of the *applied* θ, for next-interval labeling:
            # picked on the device, float32 as the model reads them
            hist_list = list(hist)
            feats = np.zeros((len(rows), width), dtype=np.float32)
            fdims = {}
            for op in (READ, WRITE):
                sel = ops_r == op
                if not sel.any():
                    continue
                F = fleet_feature_matrix(
                    hist_list, op, torch.as_tensor(rows[sel], device=dev),
                    theta_feats)
                js = torch.as_tensor([SPACE.index_of(tuple(t))
                                      for t in theta[sel]], device=dev)
                picked = F[torch.arange(int(sel.sum()), device=dev) * m
                           + js]
                fdims[op] = picked.shape[1]
                feats[sel, :picked.shape[1]] = host(picked)
            tput0 = np.where(ops_r == READ, read_tput[rows],
                             write_tput[rows])
            pending = (rows, ops_r, _RowView(feats, fdims, ops_r), tput0)

        if trainer is not None:
            trainer.step(series[-1])

    t_fail = _first_onset(spec)
    ts = (np.arange(n_intervals) + 1) * interval
    arr = np.asarray(series)
    pre = arr[ts <= t_fail]
    post = arr[ts > t_fail]
    tail = post[len(post) // 2:]
    changes = sum(int(r.decisions.changed.sum()) for r in fleet.decisions)
    return ContinualResult(
        scenario=spec.name,
        online=online,
        seconds=seconds,
        interval=interval,
        t_fail=t_fail,
        tput_mbs=[float(x) for x in series],
        theta_trace=theta_trace,
        refits=list(trainer.refits) if trainer else [],
        samples={"read": n_samples[READ], "write": n_samples[WRITE]},
        pre_fail_mbs=float(pre.mean()) if len(pre) else 0.0,
        post_fail_mbs=float(post.mean()) if len(post) else float(arr.mean()),
        post_tail_mbs=float(tail.mean()) if len(tail) else float(arr.mean()),
        changes=changes,
    )


class _RowView:
    """Op-sliced view over the mixed-op pending feature block: indexing
    with a boolean row mask returns rows trimmed to that op's dim."""

    def __init__(self, feats: np.ndarray, fdims: dict, ops: np.ndarray):
        self._feats = feats
        self._fdims = fdims
        self._ops = ops

    def __getitem__(self, sel):
        op = int(self._ops[np.nonzero(sel)[0][0]])
        return self._feats[sel, :self._fdims[op]]


def run_comparison(name: str = "failing_ost", model: DIALModel | None = None,
                   seconds: float = 45.0, interval: float = 0.5,
                   policy: OnlinePolicy | None = None,
                   gbdt_params: GBDTParams | None = None,
                   seed_data: dict | None = None, smoke: bool = False,
                   device=None) -> dict:
    """Frozen-model vs online-refit on one drifting scenario, on
    ``device`` (``None``: the CUDA card).

    Both runs start from the *same* forests (the online run swaps its
    own in by reference and never writes into the shared tensors),
    identical engine state and the identical epsilon-greedy schedule, so
    the throughput difference is the refits'.  Defaults are the
    reference's calibrated failing_ost configuration (10-interval refit
    cadence, 10% exploration, 40x5 refit forests).
    """
    from repro_torch.lab.evaluate import default_model

    dev = resolve_device(device)
    spec = get_scenario(name)
    if model is None:
        model = default_model(smoke=smoke, device=dev)
    policy = policy or OnlinePolicy(refit_every=10, min_samples=32,
                                    cooldown=6, explore_eps=0.10)
    gbdt_params = gbdt_params or GBDTParams(n_trees=40, max_depth=5)

    def fresh():
        return DIALModel(read_forest=model.read_forest,
                         write_forest=model.write_forest,
                         space=model.space, k=model.k)

    # the frozen arm gets the same policy: only explore_eps is read when
    # online=False, so both arms draw the identical exploration schedule
    frozen = run_continual(spec, fresh(), online=False, seconds=seconds,
                           interval=interval, policy=policy, device=dev)
    online = run_continual(spec, fresh(), online=True, seconds=seconds,
                           interval=interval, policy=policy,
                           gbdt_params=gbdt_params, seed_data=seed_data,
                           device=dev)
    gain = online.post_fail_mbs / max(frozen.post_fail_mbs, 1e-9)
    tail_gain = online.post_tail_mbs / max(frozen.post_tail_mbs, 1e-9)
    return {
        "scenario": name,
        "seconds": seconds,
        "interval": interval,
        "t_fail": frozen.t_fail if math.isfinite(frozen.t_fail) else None,
        "frozen": frozen.row(),
        "online": online.row(),
        "post_fail_gain": gain,
        "post_tail_gain": tail_gain,
        "refits": len(online.refits),
    }


def write_report(report: dict, out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "continual.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    return path


# ---------------------------------------------------------------------- #
# the hard-case replay curriculum: fuzz triage -> refits -> re-race
# ---------------------------------------------------------------------- #
CURRICULUM_SCHEMA = "dial-curriculum-v1"

#: curriculum replays per diagnosed cause.  Model-attributed losses
#: (the forests ranked wrong, converged late, or cleared no candidate)
#: are replayed hardest -- each replay collects on-policy labels and
#: feeds the online refits.  Gate-attributed losses get one pass (the
#: model is not at fault; their evidence rows are surfaced as
#: gate-threshold evidence instead).  ``inherent`` and ``none`` losses
#: carry no signal a refit could use.
CAUSE_WEIGHTS = {
    "model_misranked": 3,
    "reaction_lag": 2,
    "candidate_missing": 2,
    "gate_blocked": 1,
    "undiagnosed": 1,
    "inherent": 0,
    "none": 0,
}


def _race_cases(cases: list[dict], model: DIALModel, seconds: float,
                interval: float, device) -> list[dict]:
    """DIAL vs each loser's recorded best-static θ, under the sweep's
    own run length -- the before/after measurement both ends share.  The
    mixed loser set races ragged (one fused run per padded shape bucket,
    each result the per-case race's)."""
    from repro_torch.obs.diagnose import DiagnoseConfig, race_many

    cfg = DiagnoseConfig(seconds=seconds, interval=interval)
    return race_many([(c["spec"], c["row"]["best_static_theta"])
                      for c in cases], model, cfg, device=device)


def run_hard_case_curriculum(report_path: str, model: DIALModel, *,
                             seconds: float = 12.0, interval: float = 0.5,
                             policy: OnlinePolicy | None = None,
                             gbdt_params: GBDTParams | None = None,
                             max_cases: int | None = None,
                             seed: int = 0, device=None) -> dict:
    """Close the triage loop: replay a fuzz report's losers as a
    continual-learning curriculum and measure the loss-rate delta, on
    ``device`` (``None``: the CUDA card).

    Every triaged loser is (1) re-raced against its recorded best-static
    θ with the incoming model (*before*), (2) replayed
    ``CAUSE_WEIGHTS[cause]`` times through :func:`run_continual` with
    online refits swapping ``model``'s forests in place -- losers the
    diagnosis blames on the *model* are replayed hardest, gate-attributed
    losers contribute their evidence rows to ``gate_evidence`` -- then
    (3) re-raced with the refit model (*after*).  Each refit bumps the
    model's version, so the after races capture their fused loops anew
    (the lab's loop cache keys on the version) and never replay a graph
    of the old forests.  ``seconds`` / ``interval`` set the replays; the
    races reuse the sweep's own run length, so "losing" means what it
    meant at triage time.
    """
    from repro_torch.lab.fuzz import spec_from_dict

    dev = resolve_device(device)
    with open(report_path) as f:
        fuzz_report = json.load(f)
    losses = fuzz_report["triage"]["losses"]
    if max_cases is not None:
        losses = losses[:max_cases]
    loss_x = float(fuzz_report["triage"]["loss_threshold"])
    min_mbs = float(fuzz_report["config"].get("min_best_static_mbs", 0.0))
    race_seconds = float(fuzz_report["config"]["seconds"])
    race_interval = float(fuzz_report["config"]["interval"])
    policy = policy if policy is not None else OnlinePolicy(
        refit_every=4, min_samples=16, cooldown=2, explore_eps=0.15)
    gbdt_params = gbdt_params or GBDTParams(n_trees=40, max_depth=5)

    def losing(race: dict) -> bool:
        return (race["best_static_mbs"] >= min_mbs
                and race["dial_mbs"] < (1.0 - loss_x)
                * race["best_static_mbs"])

    cases, gate_evidence = [], []
    for r in losses:
        spec = spec_from_dict(r["spec"], name=r["name"])
        cause = r.get("diagnosis", {}).get("cause", "undiagnosed")
        if cause == "gate_blocked":
            gate_evidence.append({
                "name": r["name"], "fingerprint": r["fingerprint"],
                "evidence": r["diagnosis"]["evidence"],
                "n_evidence_total": r["diagnosis"]["n_evidence_total"],
            })
        cases.append({"spec": spec, "row": r, "cause": cause,
                      "weight": CAUSE_WEIGHTS.get(cause, 1)})

    # (1) before: every case, with the incoming forests (ragged)
    for c, race in zip(cases, _race_cases(cases, model, race_seconds,
                                          race_interval, dev)):
        c["before"] = race

    # (2) the curriculum: weighted replays with in-place online refits
    n_replays = n_refits = 0
    for i, c in enumerate(cases):
        for rep in range(c["weight"]):
            res = run_continual(c["spec"], model, online=True,
                                seconds=seconds, interval=interval,
                                policy=policy, gbdt_params=gbdt_params,
                                seed=seed + 1000 * i + rep, device=dev)
            n_replays += 1
            n_refits += len(res.refits)

    # (3) after: the same races, with the curriculum-refit forests
    for c, race in zip(cases, _race_cases(cases, model, race_seconds,
                                          race_interval, dev)):
        c["after"] = race

    buckets: dict = {}
    for c in cases:
        b = buckets.setdefault(c["cause"], {"n": 0, "before_losses": 0,
                                            "after_losses": 0})
        b["n"] += 1
        b["before_losses"] += int(losing(c["before"]))
        b["after_losses"] += int(losing(c["after"]))
    for b in buckets.values():
        b["before_loss_rate"] = b["before_losses"] / b["n"]
        b["after_loss_rate"] = b["after_losses"] / b["n"]
        b["delta"] = b["after_loss_rate"] - b["before_loss_rate"]
    n = len(cases)
    before = sum(b["before_losses"] for b in buckets.values())
    after = sum(b["after_losses"] for b in buckets.values())

    return {
        "schema": CURRICULUM_SCHEMA,
        "source": os.path.basename(report_path),
        "n_losers": n,
        "n_replays": n_replays,
        "n_refits": n_refits,
        "replay_seconds": seconds,
        "replay_interval": interval,
        "race_seconds": race_seconds,
        "loss_threshold": loss_x,
        "cause_weights": dict(sorted(CAUSE_WEIGHTS.items())),
        "cases": [{
            "name": c["row"]["name"],
            "fingerprint": c["row"]["fingerprint"],
            "cause": c["cause"],
            "weight": c["weight"],
            "before": {**c["before"], "losing": losing(c["before"])},
            "after": {**c["after"], "losing": losing(c["after"])},
        } for c in cases],
        "buckets": dict(sorted(buckets.items())),
        "overall": {
            "before_loss_rate": before / n if n else 0.0,
            "after_loss_rate": after / n if n else 0.0,
            "delta": (after - before) / n if n else 0.0,
        },
        "gate_evidence": gate_evidence,
    }


def write_curriculum_report(report: dict, out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "curriculum.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")
    return path
