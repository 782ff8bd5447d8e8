"""Counterfactual diagnosis replay: one command from loss to cause.

The port of the reference's ``repro/lab/diagnose.py``.
``python -m repro_torch.lab diagnose <scenario>`` (or a triaged fuzz
loser via ``--from-report/--fingerprint``, or every loser via ``--all``)
re-runs the scenario through the fused loop under the intervention
arms (θ pinned to the best-static oracle, gates forced open, decisions
frozen, optional model swap) and writes the machine-readable diagnosis:

    diagnosis.json    byte-deterministic ``dial-diagnosis-v1`` report
    diagnosis.md      per-scenario cause table

See :mod:`repro_torch.obs.diagnose` for the engine and
``docs/OBSERVABILITY.md`` for the cause taxonomy.
"""

from __future__ import annotations

import json

from repro_torch import resolve_device
from repro_torch.lab.scenarios import get_scenario
from repro_torch.obs.diagnose import (DiagnoseConfig, cause_counts,
                                      diagnose_many,
                                      render_diagnosis_markdown,
                                      write_diagnosis_report)


def _losses(path: str) -> list[dict]:
    with open(path) as f:
        report = json.load(f)
    return report.get("triage", {}).get("losses", [])


def specs_from_report(path: str, fp: str | None,
                      all_losses: bool) -> list[tuple]:
    """``(spec, race)`` pairs for the requested triaged losers — the
    recorded race figures skip re-running phase A."""
    from repro_torch.lab.fuzz import spec_from_dict

    losses = _losses(path)
    if not all_losses:
        losses = [r for r in losses if r["fingerprint"] == fp]
        if not losses:
            have = ", ".join(r["fingerprint"]
                             for r in _losses(path)) or "none"
            raise KeyError(f"fingerprint {fp!r} not in {path} "
                           f"(triaged: {have})")
    return [(spec_from_dict(r["spec"], name=r["name"]),
             {"dial_mbs": r["dial_mbs"],
              "best_static_mbs": r["best_static_mbs"],
              "best_static_theta": r["best_static_theta"],
              "dial_frac_of_best_static": r["dial_frac_of_best_static"]})
            for r in losses]


def main(args) -> int:
    """CLI entry (dispatched from ``repro_torch.lab.__main__``)."""
    from repro_torch.core.model import DIALModel
    from repro_torch.lab.evaluate import default_model

    if args.from_report:
        if not (args.fingerprint or args.all):
            raise SystemExit("--from-report needs --fingerprint or --all")
        pairs = specs_from_report(args.from_report, args.fingerprint,
                                  args.all)
    elif args.scenario:
        pairs = [(get_scenario(args.scenario), None)]
    else:
        raise SystemExit("pass a scenario name or --from-report with "
                         "--fingerprint/--all")

    dev = resolve_device(args.device)
    model = (DIALModel.load(args.model, device=dev) if args.model
             else default_model(smoke=args.smoke, device=dev))
    alt_model = (DIALModel.load(args.alt_model, device=dev)
                 if args.alt_model else None)
    cfg = DiagnoseConfig(seconds=args.seconds, interval=args.interval,
                         loss_threshold=args.threshold,
                         max_evidence=args.max_evidence)
    from repro_torch.lab.__main__ import _make_mesh

    # a mixed loser set (--all) replays ragged: one traced run per
    # padded shape bucket instead of one per loser
    diags = diagnose_many(pairs, model, cfg,
                          mesh=_make_mesh(getattr(args, "mesh", None)),
                          alt_model=alt_model,
                          alt_model_name=args.alt_model,
                          ragged=not getattr(args, "no_ragged", False),
                          device=dev)
    jpath, mpath = write_diagnosis_report(diags, args.out)
    report = {"schema": diags[0]["schema"] if diags else "",
              "n_diagnoses": len(diags),
              "causes": cause_counts(diags), "diagnoses": diags}
    print(render_diagnosis_markdown(report))
    print(f"wrote {jpath} / {mpath}")
    return 0
