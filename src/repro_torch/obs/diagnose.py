"""Counterfactual loss diagnosis: from "DIAL lost" to "here is why".

The port of the reference's ``repro/obs/diagnose.py``.  The races and
the replays run on the port's fused batch path (each bucket one
block-diagonal fleet on the device, each interval a CUDA-graph replay
on the card, ``graph=False`` eager); signals, attribution, evidence and
the report are copies (numpy), so a diagnosis made by either package
has the same keys and causes (the port's ``config`` has no
``seg_backend``: it has one segment-sum route).

A fuzz triage entry or a traced replay says *what* DIAL decided and by
how much it lost — not *why*.  This module turns any scenario (catalog
entry or triaged fuzz loser) into a machine-readable explanation by
re-running it through the fused loop under a small set of
**interventions** and diffing the outcomes against the factual run:

``factual``          the neutral intervention — bit-identical to the
                     unintervened run (arithmetic-identity masks);
``pin_best_static``  θ pinned to the best-static oracle every interval
                     (and started there) — reproduces the oracle arm
                     inside the replay program, calibrating the gap;
``gates_open``       the volume + steadiness gates forced open — what
                     DIAL would have done had the gates never blocked;
``freeze_theta``     decisions never applied — θ stays at the initial
                     configuration, isolating DIAL's knob churn
                     (the fused loop's analogue of "exploration
                     zeroed" — the only θ motion it has);
``model_swap``       optional: the same scenario tuned by a different
                     model artifact (is the *model version* the loss?).

Interventions are a run input of
:class:`~repro_torch.pfs.loop_torch.FusedLoop`
(:class:`~repro_torch.pfs.loop_torch.Intervention`) whose neutral value
is an arithmetic identity, and the reports are byte-deterministic like
the fuzz report (no timestamps, sorted keys).

The dominant-cause taxonomy (attribution cascade, in order):

``none``              the scenario is not a loss at the configured
                      threshold;
``inherent``          the loss does not reproduce under the pinned
                      oracle — best-static is no better in replay
                      (noise-floor or non-θ-attributable gap);
``gate_blocked``      warm intervals where the volume/steadiness gates
                      blocked decisions dominate, or forcing the gates
                      open recovers most of the gap;
``candidate_missing`` θ* is outside the tuner's candidate grid, or
                      decided intervals mostly had **zero** candidates
                      clear the confidence threshold τ;
``reaction_lag``      DIAL does converge to θ* but only in the second
                      half of the run — the loss is the transient;
``model_misranked``   the forests ranked some other configuration above
                      θ* while it was available (the residual cause).

Every diagnosis carries per-interval evidence rows supporting its
label, capped at ``max_evidence`` with the uncapped total recorded —
no silent truncation.  See ``docs/OBSERVABILITY.md`` (the reference's
documentation; the taxonomy is the same).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.config_space import SPACE

DIAGNOSIS_SCHEMA = "dial-diagnosis-v1"

#: attribution labels, in cascade order
CAUSES = ("none", "inherent", "gate_blocked", "candidate_missing",
          "reaction_lag", "model_misranked")

#: the counterfactual arms every diagnosis replays
ARMS = ("factual", "pin_best_static", "gates_open", "freeze_theta")


@dataclasses.dataclass(frozen=True)
class DiagnoseConfig:
    """One diagnosis run's execution + attribution parameters.

    ``thetas`` are the static arms of the (re-)race that defines the
    best-static oracle θ* (empty -> the full Θ grid, as fuzz uses);
    ``reproduce_frac`` is the inherent-loss floor: if pinning θ* beats
    the factual replay by less than this fraction of the pinned arm,
    the loss is not θ-attributable; ``recover_frac`` is the share of
    the pinned gap an intervention arm must recover to claim the cause.
    """

    seconds: float = 3.0
    interval: float = 0.5
    thetas: tuple = ()                 # () -> full SPACE
    loss_threshold: float = 0.05
    min_best_static_mbs: float = 1.0
    max_evidence: int = 8
    reproduce_frac: float = 0.02
    recover_frac: float = 0.5

    @classmethod
    def from_fuzz(cls, fuzz_cfg, max_evidence: int = 8) -> "DiagnoseConfig":
        """Mirror a sweep's execution knobs so the diagnosis replays a
        triaged loser under the exact conditions that triaged it."""
        return cls(seconds=fuzz_cfg.seconds, interval=fuzz_cfg.interval,
                   thetas=tuple(fuzz_cfg.thetas),
                   loss_threshold=fuzz_cfg.loss_threshold,
                   min_best_static_mbs=fuzz_cfg.min_best_static_mbs,
                   max_evidence=max_evidence)


# ---------------------------------------------------------------------- #
# phase A: the race (static arms + DIAL) — defines θ* and the loss
# ---------------------------------------------------------------------- #
def race_scenario(spec, model, cfg: DiagnoseConfig, mesh=None, graph=None,
                  device=None) -> dict:
    """Race ``spec`` DIAL-tuned against the static arms; the fuzz
    sweep's per-scenario measurement, for one scenario, on ``device``
    (``None``: the CUDA card).  ``mesh`` is ``run_batch``'s."""
    from repro_torch.lab.batch import run_batch, stack_scenarios
    from repro_torch.lab.scenarios import build

    thetas = [tuple(int(x) for x in t)
              for t in (cfg.thetas or SPACE.configs())]
    built = [build(dataclasses.replace(spec, initial_theta=th))
             for th in thetas]
    built.append(build(spec))                        # the DIAL arm
    batch = stack_scenarios(built, device=resolve_device(device))
    n, m = batch.n_osc, len(thetas)
    run_batch(batch, model=model, seconds=cfg.seconds,
              interval=cfg.interval, tune_cols=m * n + np.arange(n),
              fused=True, mesh=mesh, graph=graph)
    tput = batch.throughput(cfg.seconds)["total_mbs"]
    best = int(np.argmax(tput[:m]))
    dial_mbs, best_mbs = float(tput[m]), float(tput[best])
    return {
        "dial_mbs": dial_mbs,
        "best_static_mbs": best_mbs,
        "best_static_theta": [int(x) for x in thetas[best]],
        "dial_frac_of_best_static": dial_mbs / max(best_mbs, 1e-9),
    }


def race_many(cases, model, cfg: DiagnoseConfig, mesh=None, graph=None,
              device=None) -> list[dict]:
    """Ragged phase A for many scenarios, each against its *own* static
    oracle θ: one fused run per padded shape bucket.

    ``cases`` is ``[(spec, best_theta), ...]``; each case contributes a
    pinned-static arm plus a DIAL arm.  Elements are independent fleet
    blocks and padding is an exact identity, so the returned dicts are
    bit-identical to per-case ``race_scenario`` with
    ``thetas=(best_theta,)`` — the mixed set just shares runs.
    """
    from repro_torch.lab.batch import pad_class, run_batch, stack_scenarios
    from repro_torch.lab.scenarios import build

    dev = resolve_device(device)
    groups: dict = {}
    for i, (spec, _) in enumerate(cases):
        groups.setdefault(pad_class(build(spec)), []).append(i)
    out: list = [None] * len(cases)
    for key in sorted(groups, key=lambda k: tuple(k[1:])):
        idxs = groups[key]
        built = []
        for i in idxs:
            spec, theta = cases[i]
            built.append(build(dataclasses.replace(
                spec, initial_theta=tuple(int(x) for x in theta))))
            built.append(build(spec))                # the DIAL arm
        batch = stack_scenarios(built, device=dev)
        n = batch.n_osc
        tune_cols = np.concatenate(
            [(2 * j + 1) * n + batch.element_cols(2 * j + 1)
             for j in range(len(idxs))])
        run_batch(batch, model=model, seconds=cfg.seconds,
                  interval=cfg.interval, tune_cols=tune_cols, fused=True,
                  mesh=mesh, graph=graph)
        tput = batch.throughput(cfg.seconds)["total_mbs"]
        for j, i in enumerate(idxs):
            best_mbs = float(tput[2 * j])
            dial_mbs = float(tput[2 * j + 1])
            out[i] = {
                "dial_mbs": dial_mbs,
                "best_static_mbs": best_mbs,
                "best_static_theta": [int(x) for x in cases[i][1]],
                "dial_frac_of_best_static":
                    dial_mbs / max(best_mbs, 1e-9),
            }
    return out


# ---------------------------------------------------------------------- #
# phase B: the counterfactual arms — one traced intervened run
# ---------------------------------------------------------------------- #
def replay_arms(spec, model, cfg: DiagnoseConfig, theta_star, mesh=None,
                graph=None, device=None) -> tuple[dict, dict]:
    """One traced 4-element batch: factual + the three interventions.

    Element 0 carries the neutral intervention (bit-identical to the
    unintervened run); element 1 starts at θ* and pins it every
    interval; element 2 forces the volume/steadiness gates open;
    element 3 freezes θ at the scenario's initial configuration.
    Returns ``(arms MB/s by name, factual decision arrays (N, n, ...))``.
    """
    return replay_arms_many([(spec, theta_star)], model, cfg, mesh=mesh,
                            graph=graph, device=device)[0]


def replay_arms_many(cases, model, cfg: DiagnoseConfig, mesh=None,
                     graph=None, device=None) -> list[tuple[dict, dict]]:
    """Ragged phase B: every case's four intervention arms, grouped by
    padded shape class into one traced ``(B, n)`` intervened fused run
    per bucket.

    ``cases`` is ``[(spec, theta_star), ...]``.  Per case the batch
    carries factual / pin-θ* / gates-open / freeze-θ elements
    contiguously; interventions and the factual decision slice address
    only the case's real interface columns, so mixed-structure loser
    sets replay bit-identically to one-case-at-a-time ``replay_arms``.
    """
    from repro_torch.lab.batch import pad_class, run_batch, stack_scenarios
    from repro_torch.lab.scenarios import build
    from repro_torch.obs.schema import RunTrace, TraceConfig
    from repro_torch.pfs.loop_torch import Intervention

    dev = resolve_device(device)
    groups: dict = {}
    for i, (spec, _) in enumerate(cases):
        groups.setdefault(pad_class(build(spec)), []).append(i)
    out: list = [None] * len(cases)
    for key in sorted(groups, key=lambda k: tuple(k[1:])):
        idxs = groups[key]
        built, stars = [], []
        for i in idxs:
            spec, theta_star = cases[i]
            star = tuple(int(x) for x in theta_star)
            stars.append(star)
            built += [build(spec),
                      build(dataclasses.replace(spec, initial_theta=star)),
                      build(spec), build(spec)]
        batch = stack_scenarios(built, device=dev)
        n, b = batch.n_osc, 4 * len(idxs)

        pin_mask = np.zeros((b, n), dtype=bool)
        pin_theta = np.zeros((b, n, 2), dtype=np.int64)
        force_gates = np.zeros((b, n), dtype=bool)
        freeze = np.zeros((b, n), dtype=bool)
        for j, star in enumerate(stars):
            pin_mask[4 * j + 1] = True
            pin_theta[4 * j + 1] = np.asarray(star, dtype=np.int64)
            force_gates[4 * j + 2] = True
            freeze[4 * j + 3] = True
        iv = Intervention(pin_mask=pin_mask, pin_theta=pin_theta,
                          force_gates=force_gates, freeze=freeze)

        tcfg = TraceConfig(timeline=False)  # decision provenance suffices
        result = run_batch(batch, model=model, seconds=cfg.seconds,
                           interval=cfg.interval, fused=True, mesh=mesh,
                           trace=tcfg, intervene=iv, graph=graph)
        tput = batch.throughput(cfg.seconds)["total_mbs"]
        trace = RunTrace.from_fused(result, tcfg, batch.params.tick)
        for j, i in enumerate(idxs):
            # fleet columns are b * n + osc: the factual element's real
            # interface columns, in original order
            cols = 4 * j * n + batch.element_cols(4 * j)
            factual = {k: (np.asarray(v)[:, cols]
                           if np.asarray(v).ndim >= 2 else np.asarray(v))
                       for k, v in trace.decisions.items()}
            out[i] = ({"factual": float(tput[4 * j]),
                       "pin_best_static": float(tput[4 * j + 1]),
                       "gates_open": float(tput[4 * j + 2]),
                       "freeze_theta": float(tput[4 * j + 3])}, factual)
    return out


# ---------------------------------------------------------------------- #
# signals + attribution
# ---------------------------------------------------------------------- #
def _signals(factual: dict, theta_star) -> dict:
    """Structural evidence off the factual trace alone."""
    decided = factual["decided"]
    warm = factual["warm"]
    star = np.asarray(theta_star, dtype=np.int64)
    match = (factual["theta"] == star).all(axis=-1)      # (N, n)

    n_dec = int(decided.sum())
    blocked_share = float((warm & ~decided).sum() / max(int(warm.sum()), 1))
    nocand_share = float((decided & (factual["n_candidates"] == 0)).sum()
                         / max(n_dec, 1))
    mismatch_share = float((decided & ~match).sum() / max(n_dec, 1))

    frac_match = match.mean(axis=1) if match.size else np.zeros(0)
    ok = frac_match >= 0.5
    suffix_ok = (np.logical_and.accumulate(ok[::-1])[::-1] if len(ok)
                 else ok)
    idx = np.nonzero(suffix_ok)[0]
    converged_interval = int(idx[0]) if len(idx) else None

    grid = {tuple(int(x) for x in t) for t in SPACE.configs()}
    return {
        "blocked_share": blocked_share,
        "nocand_share": nocand_share,
        "mismatch_share": mismatch_share,
        "converged_interval": converged_interval,
        "theta_star_in_grid": tuple(int(x) for x in theta_star) in grid,
        "n_decided": n_dec,
        "frac_at_best_static": [round(float(x), 6) for x in frac_match],
    }


def attribute(losing: bool, arms: dict, signals: dict,
              cfg: DiagnoseConfig, n_intervals: int) -> str:
    """The deterministic attribution cascade (docs/OBSERVABILITY.md)."""
    if not losing:
        return "none"
    gap = arms["pin_best_static"] - arms["factual"]
    if gap <= cfg.reproduce_frac * max(arms["pin_best_static"], 1e-9):
        return "inherent"
    if (signals["blocked_share"] >= 0.5
            or (arms["gates_open"] - arms["factual"]) / gap
            >= cfg.recover_frac):
        return "gate_blocked"
    if not signals["theta_star_in_grid"] or signals["nocand_share"] >= 0.5:
        return "candidate_missing"
    ci = signals["converged_interval"]
    if ci is not None and ci > n_intervals // 2:
        return "reaction_lag"
    return "model_misranked"


def _evidence(cause: str, factual: dict, theta_star, arms: dict,
              max_evidence: int) -> tuple[list, int]:
    """Per-interval rows supporting ``cause`` (row-major order, capped
    at ``max_evidence``; the uncapped total rides the diagnosis)."""
    star = np.asarray(theta_star, dtype=np.int64)
    match = (factual["theta"] == star).all(axis=-1)
    decided = factual["decided"]
    star_idx = None
    grid = [tuple(int(x) for x in t) for t in SPACE.configs()]
    if tuple(int(x) for x in theta_star) in grid:
        star_idx = grid.index(tuple(int(x) for x in theta_star))

    def base(i, j):
        return {"interval": int(i), "osc": int(j),
                "t": round(float(factual["t"][i]), 9)}

    rows: list = []
    if cause == "gate_blocked":
        for i, j in zip(*np.nonzero(factual["warm"] & ~decided)):
            rows.append({**base(i, j),
                         "active": bool(factual["active"][i, j]),
                         "steady": bool(factual["steady"][i, j]),
                         "vol_r": round(float(factual["vol_r"][i, j]), 3),
                         "vol_w": round(float(factual["vol_w"][i, j]), 3),
                         "ratio": round(float(factual["ratio"][i, j]), 6)})
    elif cause == "candidate_missing":
        sel = (decided & (factual["n_candidates"] == 0)
               if star_idx is not None else decided)
        for i, j in zip(*np.nonzero(sel)):
            rows.append({**base(i, j),
                         "n_candidates":
                         int(factual["n_candidates"][i, j]),
                         "score": round(float(factual["score"][i, j]), 6),
                         "theta_star_in_grid": star_idx is not None})
    elif cause == "reaction_lag":
        frac = match.mean(axis=1)
        for i in range(len(frac)):
            if frac[i] >= 0.5 and i and frac[i - 1] >= 0.5:
                break
            rows.append({"interval": int(i),
                         "t": round(float(factual["t"][i]), 9),
                         "frac_at_best_static": round(float(frac[i]), 6),
                         "decided": int(decided[i].sum())})
    elif cause == "model_misranked":
        for i, j in zip(*np.nonzero(decided & ~match)):
            row = {**base(i, j),
                   "theta": [int(x) for x in factual["theta"][i, j]],
                   "theta_star": [int(x) for x in star],
                   "score": round(float(factual["score"][i, j]), 6)}
            if star_idx is not None:
                row["prob_best_static"] = round(
                    float(factual["probs"][i, j, star_idx]), 6)
            rows.append(row)
    elif cause == "inherent":
        rows.append({"pin_best_static_mbs": round(
            arms["pin_best_static"], 6),
            "factual_mbs": round(arms["factual"], 6),
            "gap_mbs": round(arms["pin_best_static"]
                             - arms["factual"], 6)})
    # a losing diagnosis must never ship without evidence: fall back to
    # the per-interval decision/convergence digest
    if cause not in ("none",) and not rows:
        frac = match.mean(axis=1)
        for i in range(decided.shape[0]):
            rows.append({"interval": int(i),
                         "t": round(float(factual["t"][i]), 9),
                         "decided": int(decided[i].sum()),
                         "frac_at_best_static": round(float(frac[i]), 6)})
    return rows[:max_evidence], len(rows)


# ---------------------------------------------------------------------- #
# the engine
# ---------------------------------------------------------------------- #
def diagnose(spec, model, cfg: DiagnoseConfig | None = None, *,
             race: dict | None = None, mesh=None, alt_model=None,
             alt_model_name: str | None = None, graph=None,
             device=None) -> dict:
    """Full counterfactual diagnosis of one scenario.

    ``race`` short-circuits phase A with an already-measured
    ``{dial_mbs, best_static_mbs, best_static_theta, ...}`` (e.g. a
    triaged fuzz row); otherwise the race is re-run here.
    ``alt_model`` adds the optional ``model_swap`` arm — the same
    scenario tuned by a different artifact.  Deterministic: the same
    (spec, model, cfg) produce a byte-identical diagnosis dict.
    ``mesh`` and ``graph`` are ``run_batch``'s, ``device``
    :func:`stack_scenarios`' (``None``: graphs on the CUDA card).
    """
    cfg = cfg if cfg is not None else DiagnoseConfig()
    if race is None:
        race = race_scenario(spec, model, cfg, mesh=mesh, graph=graph,
                             device=device)
    theta_star = [int(x) for x in race["best_static_theta"]]

    arms, factual = replay_arms(spec, model, cfg, theta_star, mesh=mesh,
                                graph=graph, device=device)
    if alt_model is not None:
        arms["model_swap"] = _swap_many([spec], alt_model, cfg, mesh=mesh,
                                        graph=graph, device=device)[0]
    return _finish_diagnosis(spec, race, arms, factual, cfg,
                             alt_model_name=alt_model_name)


def diagnose_many(pairs, model, cfg: DiagnoseConfig | None = None, *,
                  mesh=None, alt_model=None,
                  alt_model_name: str | None = None,
                  ragged: bool = True, graph=None,
                  device=None) -> list[dict]:
    """Diagnose a whole loser set — ``[(spec, race-or-None), ...]``.

    ``ragged=True`` groups the missing phase-A races, the intervention
    replays, and any model-swap arms by padded shape class and runs
    each group in one fused run — diagnosis dicts are
    bit-identical to calling :func:`diagnose` per pair, which
    ``ragged=False`` does literally.
    """
    cfg = cfg if cfg is not None else DiagnoseConfig()
    pairs = list(pairs)
    if not ragged:
        return [diagnose(spec, model, cfg, race=race, mesh=mesh,
                         alt_model=alt_model, alt_model_name=alt_model_name,
                         graph=graph, device=device)
                for spec, race in pairs]
    races = [race for _, race in pairs]
    for i, r in enumerate(races):
        if r is None:   # rare: catalog entries without recorded races —
            # the full-grid phase A defines θ*, so it can't ride
            # race_many's per-case-θ batching
            races[i] = race_scenario(pairs[i][0], model, cfg, mesh=mesh,
                                     graph=graph, device=device)
    replays = replay_arms_many(
        [(spec, races[i]["best_static_theta"])
         for i, (spec, _) in enumerate(pairs)], model, cfg, mesh=mesh,
        graph=graph, device=device)
    swaps = (None if alt_model is None
             else _swap_many([spec for spec, _ in pairs], alt_model, cfg,
                             mesh=mesh, graph=graph, device=device))
    out = []
    for i, (spec, _) in enumerate(pairs):
        arms, factual = replays[i]
        if swaps is not None:
            arms["model_swap"] = swaps[i]
        out.append(_finish_diagnosis(spec, races[i], arms, factual, cfg,
                                     alt_model_name=alt_model_name))
    return out


def _swap_many(specs, alt_model, cfg: DiagnoseConfig, mesh=None,
               graph=None, device=None) -> list[float]:
    """The optional ``model_swap`` arm for many specs: the same
    scenarios tuned by a different artifact, one ragged fused run per
    padded shape bucket."""
    from repro_torch.lab.batch import bucket_scenarios, run_batch
    from repro_torch.lab.scenarios import build

    built = [build(s) for s in specs]
    out = [0.0] * len(specs)
    for idxs, batch in bucket_scenarios(built,
                                        device=resolve_device(device)):
        run_batch(batch, model=alt_model, seconds=cfg.seconds,
                  interval=cfg.interval, fused=True, mesh=mesh, graph=graph)
        tp = batch.throughput(cfg.seconds)["total_mbs"]
        for e, i in enumerate(idxs):
            out[i] = float(tp[e])
    return out


def _finish_diagnosis(spec, race: dict, arms: dict, factual: dict,
                      cfg: DiagnoseConfig,
                      alt_model_name: str | None = None) -> dict:
    """Post-replay assembly: signals, attribution, evidence, report
    dict — shared by the per-scenario and ragged many-scenario paths."""
    from repro_torch.lab.fuzz import fingerprint

    theta_star = [int(x) for x in race["best_static_theta"]]
    losing = (race["best_static_mbs"] >= cfg.min_best_static_mbs
              and race["dial_mbs"] < (1.0 - cfg.loss_threshold)
              * race["best_static_mbs"])

    n_intervals = int(factual["decided"].shape[0])
    signals = _signals(factual, theta_star)
    cause = attribute(losing, arms, signals, cfg, n_intervals)
    evidence, n_total = _evidence(cause, factual, theta_star, arms,
                                  cfg.max_evidence)

    gap = arms["pin_best_static"] - arms["factual"]
    recovery = {"gap_mbs": round(gap, 6)}
    for name in ("gates_open", "freeze_theta", "model_swap"):
        if name in arms:
            recovery[name] = round(
                (arms[name] - arms["factual"]) / gap if gap > 0 else 0.0,
                6)

    out = {
        "schema": DIAGNOSIS_SCHEMA,
        "name": spec.name,
        "fingerprint": fingerprint(spec),
        "cause": cause,
        "losing": losing,
        "race": {
            "dial_mbs": race["dial_mbs"],
            "best_static_mbs": race["best_static_mbs"],
            "best_static_theta": theta_star,
            "dial_frac_of_best_static":
                race["dial_frac_of_best_static"],
        },
        "arms": {k: round(v, 6) for k, v in arms.items()},
        "recovery": recovery,
        "signals": signals,
        "evidence": evidence,
        "n_evidence_total": n_total,
        "n_intervals": n_intervals,
        "config": {
            "seconds": cfg.seconds, "interval": cfg.interval,
            "loss_threshold": cfg.loss_threshold,
            "min_best_static_mbs": cfg.min_best_static_mbs,
            "reproduce_frac": cfg.reproduce_frac,
            "recover_frac": cfg.recover_frac,
        },
    }
    if alt_model_name is not None:
        out["alt_model"] = alt_model_name
    return out


def cause_counts(diagnoses: list[dict]) -> dict:
    """``{cause: count}`` over a list of diagnoses, key-sorted."""
    counts: dict = {}
    for d in diagnoses:
        counts[d["cause"]] = counts.get(d["cause"], 0) + 1
    return dict(sorted(counts.items()))


# ---------------------------------------------------------------------- #
# report IO
# ---------------------------------------------------------------------- #
def render_diagnosis_markdown(report: dict) -> str:
    lines = ["# Counterfactual diagnosis", ""]
    lines.append(f"{report['n_diagnoses']} scenario(s) diagnosed; "
                 "dominant causes: "
                 + (", ".join(f"{c} x{n}" for c, n in
                              report["causes"].items()) or "none")
                 + ".")
    lines.append("")
    if report["diagnoses"]:
        lines += [
            "| scenario | cause | DIAL/best | factual | pin θ* | "
            "gates open | freeze | evidence |",
            "|---|---|---|---|---|---|---|---|",
        ]
        for d in report["diagnoses"]:
            a = d["arms"]
            lines.append(
                f"| {d['name']} | **{d['cause']}** | "
                f"{100 * d['race']['dial_frac_of_best_static']:.1f}% | "
                f"{a['factual']:.1f} | {a['pin_best_static']:.1f} | "
                f"{a['gates_open']:.1f} | {a['freeze_theta']:.1f} | "
                f"{d['n_evidence_total']} row(s) |")
        lines.append("")
        lines.append("Arms are MB/s under each intervention; `pin θ*` "
                     "replays with θ pinned to the best-static oracle, "
                     "`gates open` forces the volume/steadiness gates, "
                     "`freeze` never applies a decision.  See "
                     "docs/OBSERVABILITY.md for the cause taxonomy.")
        lines.append("")
    return "\n".join(lines)


def write_diagnosis_report(diagnoses: list[dict],
                           out_dir: str) -> tuple[str, str]:
    """``diagnosis.json`` + ``diagnosis.md``; byte-identical across
    invocations (sorted keys, no timestamps, content-only)."""
    os.makedirs(out_dir, exist_ok=True)
    report = {
        "schema": DIAGNOSIS_SCHEMA,
        "n_diagnoses": len(diagnoses),
        "causes": cause_counts(diagnoses),
        "diagnoses": diagnoses,
    }
    jpath = os.path.join(out_dir, "diagnosis.json")
    mpath = os.path.join(out_dir, "diagnosis.md")
    with open(jpath, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")
    with open(mpath, "w") as f:
        f.write(render_diagnosis_markdown(report))
    return jpath, mpath
