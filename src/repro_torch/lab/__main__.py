"""Scenario Lab CLI.

    python -m repro_torch.lab list
    python -m repro_torch.lab evaluate [--smoke] [--scenarios A B ...]
                                       [--model PREFIX] [--out reports/lab]
                                       [--device cpu]
    python -m repro_torch.lab campaign [--smoke] [--out models/lab]
                                       [--device cpu]

``evaluate`` runs every registered scenario (or the named subset) under
every static θ plus DIAL and writes ``report.json`` / ``report.md``;
``campaign`` runs batched offline collection + training and saves a
versioned model artifact.  ``--smoke`` shrinks each to CI size.
``--device`` defaults to the CUDA card; ``--device cpu`` runs the
kernels' plain versions.
"""

from __future__ import annotations

import argparse


def _cmd_list(args) -> None:
    from repro_torch.lab.scenarios import SCENARIOS

    w = max(len(n) for n in SCENARIOS)
    for name, spec in SCENARIOS.items():
        tags = ",".join(spec.tags)
        print(f"{name:<{w}}  {spec.n_clients}c x {spec.n_osts}ost  "
              f"[{tags}]  {spec.description}")


def _cmd_evaluate(args) -> None:
    from repro_torch.core.model import DIALModel
    from repro_torch.lab.evaluate import default_model, evaluate, write_report

    model = (DIALModel.load(args.model, device=args.device) if args.model
             else default_model(smoke=args.smoke, root=args.models_root,
                                device=args.device))
    seconds = 3.0 if args.smoke else args.seconds
    report = evaluate(names=args.scenarios or None, model=model,
                      seconds=seconds, interval=args.interval,
                      fused=not args.no_fused, ragged=not args.no_ragged,
                      device=args.device)
    jpath, mpath = write_report(report, args.out)
    s = report["summary"]
    print(f"{s['n_scenarios']} scenarios -> {jpath} / {mpath}")
    if "n_buckets" in s:
        print(f"ragged catalog: {s['n_buckets']} buckets, "
              f"{s['n_dispatches']} dispatches")
    print(f"mean DIAL vs default {s['mean_dial_vs_default']:.2f}x, "
          f"mean frac of best static "
          f"{100 * s['mean_dial_frac_of_best_static']:.1f}%")


def _cmd_campaign(args) -> None:
    import dataclasses

    from repro_torch.lab.campaign import (CampaignConfig, run_campaign,
                                          smoke_campaign)

    if args.smoke:
        cfg, gbdt = smoke_campaign()
        cfg = dataclasses.replace(cfg, contention_frac=args.contention_frac,
                                  seed=args.seed)
    else:
        cfg = CampaignConfig(seconds=args.seconds, reps=args.reps,
                             contention_frac=args.contention_frac,
                             seed=args.seed)
        gbdt = None
    d, _, info = run_campaign(cfg, out_root=args.out, gbdt_params=gbdt,
                              smoke=args.smoke, device=args.device)
    print(f"saved {d}: {info['samples']} samples, "
          f"positive rates {info['positive_rate']}, "
          f"trainer {info['train_meta']['trainer_backend']}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.lab",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="print the scenario catalog")

    ev = sub.add_parser("evaluate", help="tuned vs default vs best-static "
                                         "sweep over the catalog")
    ev.add_argument("--scenarios", nargs="*", default=None)
    ev.add_argument("--model", default=None,
                    help="DIALModel prefix (default: latest campaign "
                         "artifact under --models-root, else models/dial, "
                         "else a fresh campaign)")
    ev.add_argument("--models-root", default="models/lab",
                    help="campaign artifact root to resolve models from")
    ev.add_argument("--seconds", type=float, default=10.0)
    ev.add_argument("--interval", type=float, default=0.5)
    ev.add_argument("--no-fused", action="store_true",
                    help="use the per-interval host loop instead of the "
                         "device-resident loop")
    ev.add_argument("--no-ragged", action="store_true",
                    help="one batch per scenario instead of pooling the "
                         "mixed catalog into padded shape buckets")
    ev.add_argument("--out", default="reports/lab")
    ev.add_argument("--smoke", action="store_true",
                    help="CI-sized run (3 s per scenario, smoke model)")
    ev.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")

    cp = sub.add_parser("campaign", help="batched collect -> train -> "
                                         "versioned artifact")
    cp.add_argument("--seconds", type=float, default=60.0)
    cp.add_argument("--reps", type=int, default=2)
    cp.add_argument("--contention-frac", type=float, default=0.25)
    cp.add_argument("--seed", type=int, default=0)
    cp.add_argument("--out", default="models/lab")
    cp.add_argument("--smoke", action="store_true")
    cp.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")

    args = ap.parse_args(argv)
    {"list": _cmd_list, "evaluate": _cmd_evaluate,
     "campaign": _cmd_campaign}[args.cmd](args)


if __name__ == "__main__":
    main()
