"""Scenario fuzzing: seeded property-based generation + triaged sweeps.

The port of the reference's ``repro/lab/fuzz.py``.  Generation, spec
serialization, fingerprints, the report's layout and the hard-case feed
are copies (numpy on the host), so a fingerprint or a spec dict is the
same in both packages and a loser triaged in one replays in the other.
The sweep runs on the port's ``run_batch(fused=True)``: each chunk of a
shape bucket is one block-diagonal fleet on the device, each interval a
CUDA-graph replay on the card (``graph=False``: eager).  The port has
one segment-sum route, so :class:`FuzzConfig` has no ``seg_backend``
and a port report's ``config`` lacks that key.

Scenarios -- topology sizes, workload mixes (vpic / bdcats / dlio /
random / sequential rows), disturbance compositions over the full event
vocabulary including the Lustre-grounded fault kinds (``ost_fail`` /
``ost_failover`` / ``client_evict``) -- are generated **fully
deterministically from one seed**, then swept:

1. :func:`generate_spec` draws one :class:`~repro_torch.lab.scenarios.
   ScenarioSpec` per ``(seed, index)`` pair via an independent
   ``SeedSequence`` stream, so any scenario of a sweep can be
   regenerated in isolation;
2. :func:`run_sweep` groups the generated specs by padded shape class
   (:func:`~repro_torch.lab.batch.pad_class`) and races each bucket's
   static-θ arms plus a DIAL-tuned arm per scenario (the best static arm
   is the per-scenario oracle DIAL is judged against); padding is an
   exact arithmetic identity, so rows match the per-structure sweep bit
   for bit (``ragged=False`` restores the per-structure grouping);
3. auto-triage: every scenario where DIAL loses to best-static by more
   than ``loss_threshold`` lands in the report's ``triage`` section,
   deduplicated by spec fingerprint, with the full spec serialized so it
   can be replayed (:func:`load_hard_specs`, ``trace``, ``diagnose``).

Reports are byte-identical across invocations with the same seed and
model (no timestamps, sorted keys): ``python -m repro_torch.lab fuzz
--smoke`` twice must produce the same ``reports/fuzz/report.json``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.config_space import SPACE
from repro_torch.lab.batch import (pad_class, run_batch, stack_scenarios,
                                   structure_key)
from repro_torch.lab.scenarios import DisturbanceEvent, ScenarioSpec, build
from repro_torch.pfs.state import READ, WRITE
from repro_torch.pfs.workloads import (Workload, bdcats_read, dlio_reader,
                                       random_stream, sequential_stream,
                                       vpic_write)


# ---------------------------------------------------------------------- #
# configuration
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class FuzzConfig:
    """One sweep's generation + execution + triage parameters.

    ``thetas`` are the static arms each scenario is raced against
    (empty tuple -> the full 24-point Θ grid, as ``lab evaluate`` uses);
    ``topologies`` bounds the structural diversity (every extra
    (clients, osts) pair is at least one more shape bucket, and on the
    card one more captured graph);
    ``loss_threshold`` is the triage X: DIAL "loses" a scenario when its
    throughput is below ``(1 - X) * best_static``.
    """

    seed: int = 0
    n_scenarios: int = 512
    seconds: float = 6.0
    interval: float = 0.5
    loss_threshold: float = 0.05
    min_best_static_mbs: float = 1.0   # skip triage of all-dead scenarios
    thetas: tuple = ()                 # () -> full SPACE
    topologies: tuple = ((2, 1), (4, 2), (4, 4), (6, 2))
    event_kinds: tuple = ("ost_slow", "bg_burst", "nic_slow",
                          "ost_fail", "ost_failover", "client_evict")
    min_events: int = 0
    max_events: int = 3
    stripe_all_prob: float = 0.5       # row stripes over all OSTs vs one
    max_batch_elems: int = 256         # chunk buckets beyond this


#: CI-sized sweep: 64 scenarios, 3 s each, a 6-point static grid, two
#: topologies (one fused loop per structure bucket), every
#: scenario carrying at least one event so the fault vocabulary is
#: always exercised.
SMOKE = FuzzConfig(
    n_scenarios=64, seconds=3.0,
    thetas=((16, 1), (64, 2), (256, 8), (1024, 4), (1024, 16), (1024, 32)),
    topologies=((4, 2), (2, 1)),
    min_events=1, max_events=2,
    max_batch_elems=224,
)


# ---------------------------------------------------------------------- #
# seeded generation
# ---------------------------------------------------------------------- #
def _draw_workload(rng, client: int, n_osts: int,
                   stripe_all_prob: float) -> Workload:
    """One workload row for ``client``: preset family + jittered params."""
    all_osts = tuple(range(n_osts))
    one_ost = (int(rng.integers(n_osts)),)
    stripe = all_osts if rng.random() < stripe_all_prob else one_ost
    family = int(rng.integers(6))
    if family == 0:
        w = vpic_write(client, dims=int(rng.integers(1, 4)), osts=stripe)
    elif family == 1:
        mode = ("partial", "strided", "full")[int(rng.integers(3))]
        w = bdcats_read(client, mode, osts=stripe)
    elif family == 2:
        w = dlio_reader(client, "bert", n_threads=int(rng.integers(1, 5)),
                        osts=stripe)
    elif family == 3:
        w = dlio_reader(client, "megatron",
                        n_threads=int(rng.integers(1, 5)), osts=stripe)
    elif family == 4:
        op = READ if rng.random() < 0.5 else WRITE
        w = sequential_stream(client, op,
                              float(2.0 ** rng.integers(17, 25)),
                              ost=one_ost[0],
                              n_threads=int(rng.integers(1, 4)))
    else:
        op = READ if rng.random() < 0.5 else WRITE
        w = random_stream(client, op, float(2.0 ** rng.integers(13, 21)),
                          ost=one_ost[0], n_threads=int(rng.integers(1, 4)))
    # continuous jitter on top of the preset (same knobs variants() turns)
    return dataclasses.replace(
        w,
        req_size=float(w.req_size) * 2.0 ** rng.uniform(-0.7, 0.7),
        thread_rate=float(w.thread_rate) * rng.uniform(0.7, 1.3),
        randomness=float(np.clip(w.randomness + rng.uniform(-0.1, 0.1),
                                 0.0, 1.0)),
        period=float(w.period) * rng.uniform(0.8, 1.25),
    )


def _draw_targets(rng, n: int, k_max: int | None = None) -> tuple:
    k = int(rng.integers(1, (k_max or n) + 1))
    return tuple(int(x) for x in sorted(rng.choice(n, size=k,
                                                   replace=False)))


def _draw_event(rng, kind: str, n_clients: int, n_osts: int,
                horizon: float) -> DisturbanceEvent:
    """One valid event of ``kind`` whose window intersects the run."""
    start = float(rng.uniform(0.0, 0.55 * horizon))
    if kind == "ost_slow":
        end = (math.inf if rng.random() < 0.5
               else start + float(rng.uniform(0.2, 0.8) * horizon))
        periodic = rng.random() < 0.4
        return DisturbanceEvent(
            kind, targets=_draw_targets(rng, n_osts),
            magnitude=float(rng.uniform(0.05, 0.7)), start=start, end=end,
            period=float(rng.uniform(0.5, 2.0)) if periodic else 0.0,
            duty=float(rng.uniform(0.2, 0.9)) if periodic else 1.0)
    if kind == "bg_burst":
        end = (math.inf if rng.random() < 0.5
               else start + float(rng.uniform(0.2, 0.8) * horizon))
        periodic = rng.random() < 0.6
        return DisturbanceEvent(
            kind, targets=_draw_targets(rng, n_osts),
            magnitude=float(rng.uniform(100e6, 600e6)), start=start,
            end=end,
            period=float(rng.uniform(0.5, 3.0)) if periodic else 0.0,
            duty=float(rng.uniform(0.2, 0.8)) if periodic else 1.0)
    if kind == "nic_slow":
        return DisturbanceEvent(
            kind, targets=_draw_targets(rng, n_clients,
                                        k_max=max(1, n_clients - 1)),
            magnitude=float(rng.uniform(0.05, 0.6)), start=start)
    if kind == "ost_fail":
        end = start + float(rng.uniform(0.15, 0.5) * horizon)
        flapping = rng.random() < 0.3
        return DisturbanceEvent(
            kind, targets=_draw_targets(rng, n_osts,
                                        k_max=max(1, n_osts - 1) if n_osts > 1
                                        else 1),
            magnitude=float(rng.choice((0.0, 0.1))), start=start, end=end,
            period=float(rng.uniform(0.4, 1.5)) if flapping else 0.0,
            duty=float(rng.uniform(0.3, 0.7)) if flapping else 1.0)
    if kind == "ost_failover":
        start = float(rng.uniform(0.15, 0.35) * horizon)
        end = start + float(rng.uniform(0.15, 0.3) * horizon)
        return DisturbanceEvent(
            kind, targets=_draw_targets(rng, n_osts,
                                        k_max=max(1, n_osts - 1) if n_osts > 1
                                        else 1),
            magnitude=0.0, start=start, end=end,
            recovery=float(rng.uniform(0.2, 0.5) * horizon))
    if kind == "client_evict":
        end = start + float(rng.uniform(0.2, 0.6) * horizon)
        return DisturbanceEvent(
            kind, targets=_draw_targets(rng, n_clients,
                                        k_max=max(1, n_clients // 2)),
            magnitude=0.0, start=start, end=end)
    raise ValueError(f"unknown event kind {kind!r}")


def generate_spec(cfg: FuzzConfig, index: int) -> ScenarioSpec:
    """Scenario ``index`` of the sweep — a pure function of
    ``(cfg.seed, index)`` via an independent SeedSequence stream."""
    rng = np.random.default_rng(
        np.random.SeedSequence((int(cfg.seed), int(index))))
    n_clients, n_osts = cfg.topologies[int(rng.integers(len(cfg.topologies)))]
    workloads = tuple(_draw_workload(rng, c, n_osts, cfg.stripe_all_prob)
                      for c in range(n_clients))
    n_events = int(rng.integers(cfg.min_events, cfg.max_events + 1))
    events = tuple(
        _draw_event(rng,
                    cfg.event_kinds[int(rng.integers(len(cfg.event_kinds)))],
                    n_clients, n_osts, cfg.seconds)
        for _ in range(n_events))
    configs = SPACE.configs()
    theta = configs[int(rng.integers(len(configs)))]
    return ScenarioSpec(
        name=f"fuzz_{cfg.seed}_{index}",
        n_clients=n_clients, n_osts=n_osts,
        workloads=workloads, events=events,
        initial_theta=(int(theta[0]), int(theta[1])),
        seed=index,
        description=f"generated (seed={cfg.seed}, index={index})",
        tags=("fuzz",) + tuple(sorted({ev.kind for ev in events})),
    )


def generate_specs(cfg: FuzzConfig) -> list[ScenarioSpec]:
    return [generate_spec(cfg, i) for i in range(cfg.n_scenarios)]


# ---------------------------------------------------------------------- #
# spec serialization + fingerprinting
# ---------------------------------------------------------------------- #
def _event_dict(ev: DisturbanceEvent) -> dict:
    d = dataclasses.asdict(ev)
    d["targets"] = list(d["targets"])
    d["end"] = None if math.isinf(ev.end) else ev.end   # JSON-safe inf
    return d


def spec_to_dict(spec: ScenarioSpec) -> dict:
    """JSON-safe serialization of everything that defines the physics
    (name/description/tags excluded — they don't affect the run)."""
    return {
        "n_clients": spec.n_clients,
        "n_osts": spec.n_osts,
        "initial_theta": [int(x) for x in spec.initial_theta],
        "workloads": [
            {**dataclasses.asdict(w), "osts": list(w.osts)}
            for w in spec.workloads],
        "events": [_event_dict(ev) for ev in spec.events],
    }


def spec_from_dict(d: dict, name: str = "replayed") -> ScenarioSpec:
    """Inverse of :func:`spec_to_dict` (for replaying triaged specs)."""
    workloads = tuple(
        Workload(**{**w, "osts": tuple(w["osts"])}) for w in d["workloads"])
    events = tuple(
        DisturbanceEvent(**{**e, "targets": tuple(e["targets"]),
                            "end": math.inf if e["end"] is None else e["end"]})
        for e in d["events"])
    return ScenarioSpec(name=name, n_clients=d["n_clients"],
                        n_osts=d["n_osts"], workloads=workloads,
                        events=events,
                        initial_theta=tuple(d["initial_theta"]),
                        tags=("fuzz", "replayed"))


def fingerprint(spec: ScenarioSpec) -> str:
    """Stable content hash of the physics — the triage dedup key."""
    blob = json.dumps(spec_to_dict(spec), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


# ---------------------------------------------------------------------- #
# the sweep
# ---------------------------------------------------------------------- #
def _run_bucket(specs_ix, thetas, model, cfg: FuzzConfig, device,
                mesh=None, graph=None,
                stats: dict | None = None) -> list[dict]:
    """Race every scenario of one shape bucket: static arms + DIAL.

    ``specs_ix`` is ``[(index, spec), ...]``; buckets beyond
    ``max_batch_elems`` elements run as several equally-shaped chunks
    (chunking never changes a scenario's result: elements are
    independent fleet blocks).  Mixed structures inside a bucket stack
    ragged (pad-and-mask); ``stats``, when given, accumulates
    ``dispatches`` (fused runs) / ``real`` / ``phantom`` interface
    counts.
    """
    m = len(thetas)
    arms = m + 1
    per_chunk = max(1, cfg.max_batch_elems // arms)
    rows = []
    for lo in range(0, len(specs_ix), per_chunk):
        chunk = specs_ix[lo:lo + per_chunk]
        built = []
        for _, spec in chunk:
            for th in thetas:
                built.append(build(dataclasses.replace(
                    spec, initial_theta=(int(th[0]), int(th[1])))))
            built.append(build(spec))          # the DIAL arm
        batch = stack_scenarios(built, device=device)
        n = batch.n_osc
        dial_cols = np.concatenate(
            [(j * arms + m) * n + batch.element_cols(j * arms + m)
             for j in range(len(chunk))])
        result = run_batch(batch, model=model, seconds=cfg.seconds,
                           interval=cfg.interval, tune_cols=dial_cols,
                           fused=True, mesh=mesh, graph=graph)
        tput = batch.throughput(cfg.seconds)["total_mbs"]
        if stats is not None:
            ps = batch.pad_stats()
            stats["dispatches"] = stats.get("dispatches", 0) + 1
            stats["real"] = (stats.get("real", 0)
                             + ps["real_interfaces"])
            stats["phantom"] = (stats.get("phantom", 0)
                                + ps["phantom_interfaces"])
        changes = np.zeros(len(chunk), dtype=int)
        for r in result.decisions:
            if len(r):
                np.add.at(changes, r.oscs.numpy() // n // arms,
                          r.decisions.changed.numpy().astype(int))
        for j, (index, spec) in enumerate(chunk):
            static = tput[j * arms:j * arms + m]
            best = int(np.argmax(static))
            dial_mbs = float(tput[j * arms + m])
            best_mbs = float(static[best])
            rows.append({
                "index": index,
                "name": spec.name,
                "fingerprint": fingerprint(spec),
                "n_clients": spec.n_clients,
                "n_osts": spec.n_osts,
                "initial_theta": [int(x) for x in spec.initial_theta],
                "event_kinds": sorted({ev.kind for ev in spec.events}),
                "dial_mbs": dial_mbs,
                "best_static_mbs": best_mbs,
                "best_static_theta": [int(x) for x in thetas[best]],
                "dial_frac_of_best_static": dial_mbs / max(best_mbs, 1e-9),
                "changes": int(changes[j]),
            })
    return rows


def run_sweep(cfg: FuzzConfig, model, mesh=None, diagnose: bool = False,
              max_diagnoses: int | None = 32, ragged: bool = True,
              graph: bool | None = None, device=None) -> dict:
    """Generate, bucket, race, triage on ``device`` (``None``: the CUDA
    card; the model must be there).  Deterministic from ``cfg.seed`` and
    the model; the returned report dict serializes byte-identically
    across invocations.

    ``graph`` is ``run_batch``'s: ``None`` replays each interval as a
    CUDA graph on the card, ``False`` runs it eagerly.  Like the device
    it is an execution knob and stays out of the report, as ``mesh``
    does (``run_batch``'s: each chunk's batch split over the mesh's
    devices, rows bit-equal to the unsharded sweep's).  As in the
    reference, a ~1e-12 drift in a sum's order could flip a generated
    scenario that sits on the triage threshold; the port's sums are
    order-fixed on the card and the CPU alike.

    ``diagnose=True`` stamps a counterfactual diagnosis
    (:func:`repro_torch.obs.diagnose.diagnose_many`) into each triaged
    loss -- dominant cause + evidence rows, reusing the sweep's recorded
    race figures -- worst losers first, at most ``max_diagnoses`` of them
    (``None`` = all; the summary records diagnosed-of-total and the
    per-cause loss counts).

    ``ragged=True`` (default) buckets specs by padded shape class so
    mixed structures share fused runs; ``ragged=False`` restores the
    one-bucket-per-structure grouping.  Rows are bit-identical either
    way (padding neutrality)."""
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"run_sweep on {dev}: model on {model.device}")
    specs = generate_specs(cfg)
    thetas = [tuple(int(x) for x in t)
              for t in (cfg.thetas or SPACE.configs())]

    key_fn = pad_class if ragged else structure_key
    buckets: dict = {}
    for i, spec in enumerate(specs):
        key = key_fn(build(spec))
        buckets.setdefault(key, []).append((i, spec))

    rows, occupancy = [], []
    # params (key[0]) is shared; order buckets by the numeric signature
    for key in sorted(buckets, key=lambda k: tuple(k[1:])):
        stats: dict = {}
        rows.extend(_run_bucket(buckets[key], thetas, model, cfg, dev,
                                mesh=mesh, graph=graph, stats=stats))
        denom = max(stats.get("real", 0) + stats.get("phantom", 0), 1)
        occupancy.append({
            "shape": "x".join(str(int(x)) for x in key[1:]),
            "n_specs": len(buckets[key]),
            "dispatches": stats.get("dispatches", 0),
            "pad_waste": stats.get("phantom", 0) / denom,
        })
    rows.sort(key=lambda r: r["index"])
    n_dispatches = sum(b["dispatches"] for b in occupancy)

    losses, seen = [], set()
    for r in rows:
        losing = (r["best_static_mbs"] >= cfg.min_best_static_mbs
                  and r["dial_mbs"] < (1.0 - cfg.loss_threshold)
                  * r["best_static_mbs"])
        if losing and r["fingerprint"] not in seen:
            seen.add(r["fingerprint"])
            losses.append({**r, "spec": spec_to_dict(specs[r["index"]])})
    losses.sort(key=lambda r: (r["dial_frac_of_best_static"], r["index"]))

    diag_summary = {}
    if diagnose:
        from repro_torch.obs.diagnose import (DiagnoseConfig, cause_counts,
                                              diagnose_many)

        dcfg = DiagnoseConfig.from_fuzz(cfg)
        n_diag = (len(losses) if max_diagnoses is None
                  else min(len(losses), int(max_diagnoses)))
        # the reference diagnoses one loser at a time; here they replay
        # ragged, one traced run per padded bucket (the same dicts: each
        # element is its own fleet block), since on the card every run
        # of a new table costs a graph capture
        diags = diagnose_many(
            [(specs[r["index"]], {k: r[k] for k in (
                "dial_mbs", "best_static_mbs", "best_static_theta",
                "dial_frac_of_best_static")}) for r in losses[:n_diag]],
            model, dcfg, mesh=mesh, graph=graph, device=dev)
        for r, d in zip(losses, diags):
            # the loss row already carries name/fingerprint/spec
            r["diagnosis"] = {k: v for k, v in d.items()
                              if k not in ("name", "fingerprint")}
        diag_summary = {"n_diagnosed": n_diag,
                        "loss_causes": cause_counts(diags)}

    fracs = [r["dial_frac_of_best_static"] for r in rows]
    return {
        "config": {
            **{k: v for k, v in dataclasses.asdict(cfg).items()
               if k not in ("thetas", "topologies", "event_kinds")},
            "thetas": [list(t) for t in thetas],
            "topologies": [list(t) for t in cfg.topologies],
            "event_kinds": list(cfg.event_kinds),
        },
        "summary": {
            "n_scenarios": len(rows),
            "n_buckets": len(buckets),
            "n_dispatches": n_dispatches,
            "bucket_occupancy": occupancy,
            "n_unique_specs": len({r["fingerprint"] for r in rows}),
            "n_losses": len(losses),
            "mean_dial_frac_of_best_static": float(np.mean(fracs)),
            "min_dial_frac_of_best_static": float(np.min(fracs)),
            **diag_summary,
        },
        "scenarios": rows,
        "triage": {
            "loss_threshold": cfg.loss_threshold,
            "losses": losses,
        },
    }


# ---------------------------------------------------------------------- #
# report IO + hard-case feed
# ---------------------------------------------------------------------- #
def render_markdown(report: dict) -> str:
    s = report["summary"]
    cfg = report["config"]
    lines = [
        "# Fuzz sweep triage",
        "",
        f"{s['n_scenarios']} generated scenarios "
        f"({s['n_unique_specs']} unique, {s['n_buckets']} shape "
        f"buckets, {s.get('n_dispatches', '?')} fused dispatches), "
        f"seed {cfg['seed']}, {cfg['seconds']:.0f} s each, "
        f"{len(cfg['thetas'])} static arms.",
        "",
        f"DIAL fraction of best-static: mean "
        f"**{100 * s['mean_dial_frac_of_best_static']:.1f}%**, min "
        f"{100 * s['min_dial_frac_of_best_static']:.1f}%.  "
        f"**{s['n_losses']}** scenario(s) lose by more than "
        f"{100 * report['triage']['loss_threshold']:.0f}%.",
        "",
    ]
    occ = s.get("bucket_occupancy")
    if occ:
        lines += [
            "| bucket (padded shape) | specs | dispatches | pad waste |",
            "|---|---|---|---|",
        ]
        lines += [f"| `{b['shape']}` | {b['n_specs']} | "
                  f"{b['dispatches']} | {100 * b['pad_waste']:.1f}% |"
                  for b in occ]
        lines.append("")
    if report["triage"]["losses"]:
        diagnosed = any(r.get("diagnosis")
                        for r in report["triage"]["losses"])
        cause_col = " cause |" if diagnosed else ""
        lines += [
            "| scenario | topo | events | θ₀ | DIAL MB/s | "
            "best static MB/s (θ) | DIAL/best | fingerprint |" + cause_col,
            "|---|---|---|---|---|---|---|---|" + ("---|" if diagnosed
                                                   else ""),
        ]
        for r in report["triage"]["losses"]:
            th = "×".join(str(x) for x in r["best_static_theta"])
            t0 = "×".join(str(x) for x in r["initial_theta"])
            ev = ",".join(r["event_kinds"]) or "—"
            cause = (f" {r['diagnosis']['cause']} |"
                     if diagnosed and r.get("diagnosis") else
                     (" — |" if diagnosed else ""))
            lines.append(
                f"| {r['name']} | {r['n_clients']}c×{r['n_osts']}ost | "
                f"{ev} | {t0} | {r['dial_mbs']:.1f} | "
                f"{r['best_static_mbs']:.1f} ({th}) | "
                f"{100 * r['dial_frac_of_best_static']:.1f}% | "
                f"`{r['fingerprint']}` |" + cause)
        lines.append("")
        if report["triage"]["losses"][0].get("trace_recipe"):
            lines += [
                "Replay any loser with full decision provenance and "
                "per-OST timelines:",
                "",
                f"    {report['triage']['losses'][0]['trace_recipe']}",
                "",
                "(swap the fingerprint for any row above).",
                "",
            ]
    return "\n".join(lines)


def trace_recipe(report_path: str, fp: str) -> str:
    """The replay command for one triaged loss: rebuilds the exact spec
    from the serialized physics in the report and re-runs it traced."""
    return (f"python -m repro_torch.lab trace --from-report {report_path} "
            f"--fingerprint {fp}")


def write_fuzz_report(report: dict, out_dir: str) -> tuple[str, str]:
    os.makedirs(out_dir, exist_ok=True)
    jpath = os.path.join(out_dir, "report.json")
    mpath = os.path.join(out_dir, "report.md")
    # stamp each triaged loss with its replay recipe; paths are derived
    # from out_dir only, so reports stay byte-identical across
    # invocations into the same directory (the CI determinism check)
    report = {**report, "triage": {
        **report["triage"],
        "losses": [{**r, "trace_recipe": trace_recipe(jpath,
                                                      r["fingerprint"])}
                   for r in report["triage"]["losses"]]}}
    with open(jpath, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")
    with open(mpath, "w") as f:
        f.write(render_markdown(report))
    return jpath, mpath


def load_hard_specs(path: str) -> list[ScenarioSpec]:
    """Triaged losing scenarios from a report.json, rebuilt as specs --
    the hard-case feed for replays and the continual-learning loop."""
    with open(path) as f:
        report = json.load(f)
    return [spec_from_dict(r["spec"], name=r["name"])
            for r in report["triage"]["losses"]]
