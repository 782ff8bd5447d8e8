"""Scenario Lab CLI.

    python -m repro_torch.lab list
    python -m repro_torch.lab evaluate [--smoke] [--scenarios A B ...]
                                       [--model PREFIX] [--out reports/lab]
                                       [--mesh [N]] [--device cpu]
    python -m repro_torch.lab campaign [--smoke] [--out models/lab]
                                       [--device cpu]
    python -m repro_torch.lab continual [--smoke] [--scenario failing_ost]
                                        [--device cpu]
    python -m repro_torch.lab continual --hard-from reports/fuzz/report.json \
                                        [--max-cases N]
    python -m repro_torch.lab fuzz [--smoke] [--seed 0] [--out reports/fuzz]
                                   [--mesh [N]] [--device cpu]
    python -m repro_torch.lab trace <scenario> [--stride 20]
                                    [--out reports/trace] [--device cpu]
    python -m repro_torch.lab trace --from-report reports/fuzz/report.json \
                                    --fingerprint <fp>
    python -m repro_torch.lab diagnose <scenario> [--out reports/diagnose]
    python -m repro_torch.lab diagnose --from-report \
        reports/fuzz/report.json [--fingerprint <fp> | --all] [--mesh [N]]

``evaluate`` runs every registered scenario (or the named subset) under
every static θ plus DIAL and writes ``report.json`` / ``report.md``;
``campaign`` runs batched offline collection + training and saves a
versioned model artifact.  ``continual`` runs one drifting scenario
twice -- frozen model vs online refit (replay buffer, drift trigger,
retraining) -- and reports the post-failure recovery; with
``--hard-from`` it replays a fuzz report's triaged losers as a
curriculum instead and reports the loss-rate delta per cause.  ``fuzz`` generates scenarios
deterministically from a seed, races DIAL against a static-θ grid
through the fused batch path, and writes an auto-triaged
``reports/fuzz/`` of every scenario DIAL loses (with a counterfactual
diagnosis of each unless ``--no-diagnose``).  ``trace`` replays one
scenario (catalog name, or a triaged fuzz loser by fingerprint) through
the traced fused loop and writes decision provenance + per-OST
timelines as JSONL, Chrome ``trace_event`` and a markdown digest.
``diagnose`` replays a scenario under the counterfactual intervention
arms and writes a dominant-cause diagnosis with per-interval evidence.
``--smoke`` shrinks each to CI size.  ``--device`` defaults to the CUDA
card; ``--device cpu`` runs the kernels' plain versions.  ``--mesh N``
splits each fused batch over N devices (bare ``--mesh``: every visible
card).
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


def _make_mesh(n):
    """``--mesh`` value -> fleet mesh (``None`` off, 0 = every visible
    card)."""
    if n is None:
        return None
    from repro_torch.distributed.sharding import fleet_mesh

    return fleet_mesh(n or None)


def _cmd_evaluate(args) -> None:
    from repro_torch.core.model import DIALModel
    from repro_torch.lab.evaluate import default_model, evaluate, write_report

    model = (DIALModel.load(args.model, device=args.device) if args.model
             else default_model(smoke=args.smoke, root=args.models_root,
                                device=args.device))
    seconds = 3.0 if args.smoke else args.seconds
    report = evaluate(names=args.scenarios or None, model=model,
                      seconds=seconds, interval=args.interval,
                      fused=not args.no_fused, mesh=_make_mesh(args.mesh),
                      ragged=not args.no_ragged, device=args.device)
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


def _cmd_continual(args) -> None:
    from repro_torch.core.gbdt import GBDTParams
    from repro_torch.core.model import DIALModel
    from repro_torch.lab.continual import run_comparison, write_report
    from repro_torch.learn.online import OnlinePolicy

    if args.hard_from:
        _cmd_hard_cases(args)
        return
    model = (DIALModel.load(args.model, device=args.device) if args.model
             else None)
    seconds = 10.0 if args.smoke else args.seconds
    gbdt = (GBDTParams(n_trees=20, max_depth=4) if args.smoke
            else GBDTParams(n_trees=40, max_depth=5))
    policy = OnlinePolicy(refit_every=args.refit_every,
                          min_samples=16 if args.smoke else 32,
                          explore_eps=args.explore_eps)
    report = run_comparison(args.scenario, model=model, seconds=seconds,
                            interval=args.interval, policy=policy,
                            gbdt_params=gbdt, smoke=args.smoke,
                            device=args.device)
    path = write_report(report, args.out)
    fr, on = report["frozen"], report["online"]
    print(f"{args.scenario}: failure at t={report['t_fail']}s, "
          f"{report['refits']} refit(s), "
          f"{on['samples']} online samples -> {path}")
    print(f"post-failure MB/s: frozen {fr['post_fail_mbs']:.1f}, "
          f"online {on['post_fail_mbs']:.1f} "
          f"({report['post_fail_gain']:.2f}x; tail "
          f"{report['post_tail_gain']:.2f}x)")


def _cmd_hard_cases(args) -> None:
    """``continual --hard-from``: the fuzz-triage replay curriculum."""
    from repro_torch import resolve_device
    from repro_torch.core.gbdt import GBDTParams
    from repro_torch.core.model import DIALModel
    from repro_torch.lab.continual import (run_hard_case_curriculum,
                                           write_curriculum_report)
    from repro_torch.lab.evaluate import default_model
    from repro_torch.learn.online import OnlinePolicy

    dev = resolve_device(args.device)
    model = (DIALModel.load(args.model, device=dev) if args.model
             else default_model(smoke=args.smoke, device=dev))
    gbdt = (GBDTParams(n_trees=20, max_depth=4) if args.smoke
            else GBDTParams(n_trees=40, max_depth=5))
    policy = OnlinePolicy(refit_every=args.refit_every,
                          min_samples=16 if args.smoke else 32,
                          cooldown=2 if args.smoke else 4,
                          explore_eps=args.explore_eps)
    max_cases = args.max_cases if args.max_cases is not None else (
        6 if args.smoke else None)
    report = run_hard_case_curriculum(
        args.hard_from, model, seconds=6.0 if args.smoke else args.seconds,
        interval=args.interval, policy=policy, gbdt_params=gbdt,
        max_cases=max_cases, device=dev)
    path = write_curriculum_report(report, args.out)
    o = report["overall"]
    print(f"{report['n_losers']} triaged loser(s), "
          f"{report['n_replays']} curriculum replay(s), "
          f"{report['n_refits']} refit(s) -> {path}")
    print(f"loss rate {100 * o['before_loss_rate']:.0f}% -> "
          f"{100 * o['after_loss_rate']:.0f}% "
          f"(delta {100 * o['delta']:+.0f}%)")
    for cause, row in report["buckets"].items():
        print(f"  {cause}: {row['n']} case(s), loss rate "
              f"{100 * row['before_loss_rate']:.0f}% -> "
              f"{100 * row['after_loss_rate']:.0f}%")


def _cmd_fuzz(args) -> None:
    import dataclasses

    from repro_torch import resolve_device
    from repro_torch.core.model import DIALModel
    from repro_torch.lab.evaluate import default_model
    from repro_torch.lab.fuzz import (SMOKE, FuzzConfig, run_sweep,
                                      write_fuzz_report)

    cfg = SMOKE if args.smoke else FuzzConfig()
    over = {"seed": args.seed}
    if args.n is not None:
        over["n_scenarios"] = args.n
    if args.seconds is not None:
        over["seconds"] = args.seconds
    if args.threshold is not None:
        over["loss_threshold"] = args.threshold
    cfg = dataclasses.replace(cfg, **over)
    dev = resolve_device(args.device)
    model = (DIALModel.load(args.model, device=dev) if args.model
             else default_model(smoke=args.smoke, root=args.models_root,
                                device=dev))
    report = run_sweep(cfg, model, mesh=_make_mesh(args.mesh),
                       diagnose=not args.no_diagnose,
                       max_diagnoses=args.max_diagnoses,
                       ragged=not args.no_ragged, device=dev)
    jpath, mpath = write_fuzz_report(report, args.out)
    s = report["summary"]
    print(f"{s['n_scenarios']} scenarios, {s['n_buckets']} buckets, "
          f"{s['n_dispatches']} fused runs -> {jpath} / {mpath}")
    for b in s["bucket_occupancy"]:
        print(f"  bucket {b['shape']}: {b['n_specs']} specs, "
              f"{b['dispatches']} run(s), "
              f"pad waste {100 * b['pad_waste']:.1f}%")
    causes = s.get("loss_causes")
    by_cause = ("" if causes is None else " [" + (
        ", ".join(f"{c}: {n}" for c, n in causes.items()) or "no causes")
        + "]")
    print(f"mean DIAL frac of best static "
          f"{100 * s['mean_dial_frac_of_best_static']:.1f}%, "
          f"{s['n_losses']} loss(es) beyond "
          f"{100 * cfg.loss_threshold:.0f}%" + by_cause)


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
    ev.add_argument("--mesh", type=int, default=None, nargs="?", const=0,
                    help="split each fused batch over N devices (0 or "
                         "bare flag: every visible card)")
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

    ct = sub.add_parser("continual", help="frozen vs online-refit run of "
                                          "a drifting scenario")
    ct.add_argument("--scenario", default="failing_ost")
    ct.add_argument("--seconds", type=float, default=45.0)
    ct.add_argument("--interval", type=float, default=0.5)
    ct.add_argument("--refit-every", type=int, default=10)
    ct.add_argument("--explore-eps", type=float, default=0.10)
    ct.add_argument("--model", default=None,
                    help="DIALModel prefix (default: evaluate's model "
                         "resolution order)")
    ct.add_argument("--out", default="reports/lab")
    ct.add_argument("--smoke", action="store_true",
                    help="CI-sized run (10 s, small refits)")
    ct.add_argument("--hard-from", default=None,
                    help="fuzz report.json: instead of the frozen-vs-"
                         "online comparison, replay its triaged losers "
                         "as a hard-case curriculum (weighted by "
                         "diagnosed cause) and report the loss-rate "
                         "delta per cause bucket")
    ct.add_argument("--max-cases", type=int, default=None,
                    help="with --hard-from: cap the losers replayed "
                         "(worst-first; --smoke caps at 6)")
    ct.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")

    fz = sub.add_parser("fuzz", help="seeded scenario fuzzing: generate, "
                                     "race vs static grid, auto-triage")
    fz.add_argument("--seed", type=int, default=0)
    fz.add_argument("--n", type=int, default=None,
                    help="number of scenarios (default: config's)")
    fz.add_argument("--seconds", type=float, default=None)
    fz.add_argument("--threshold", type=float, default=None,
                    help="triage loss threshold X: flag scenarios where "
                         "DIAL < (1-X) * best static")
    fz.add_argument("--model", default=None,
                    help="DIALModel prefix (default: evaluate's model "
                         "resolution order)")
    fz.add_argument("--models-root", default="models/lab")
    fz.add_argument("--mesh", type=int, default=None, nargs="?", const=0,
                    help="split each bucket's batches over N devices (0 "
                         "or bare flag: every visible card)")
    fz.add_argument("--no-ragged", action="store_true",
                    help="bucket by exact structure instead of padded "
                         "shape class (more runs, no padding)")
    fz.add_argument("--out", default="reports/fuzz")
    fz.add_argument("--smoke", action="store_true",
                    help="CI-sized sweep (64 scenarios, 3 s, 6 static "
                         "arms, two topologies)")
    fz.add_argument("--no-diagnose", action="store_true",
                    help="skip stamping a counterfactual diagnosis into "
                         "each triaged loser")
    fz.add_argument("--max-diagnoses", type=int, default=None,
                    help="diagnose at most N losers (worst first; the "
                         "report records diagnosed-of-total; default: "
                         "every triaged loser)")
    fz.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")

    tr = sub.add_parser("trace", help="replay one scenario traced; write "
                                      "JSONL + Chrome trace + summary")
    tr.add_argument("scenario", nargs="?", default=None,
                    help="catalog scenario name (see `list`)")
    tr.add_argument("--from-report", default=None,
                    help="fuzz report.json to pull a triaged loser from")
    tr.add_argument("--fingerprint", default=None,
                    help="which triaged loss to replay (with "
                         "--from-report)")
    tr.add_argument("--stride", type=int, default=20,
                    help="timeline downsampling: one sample every N "
                         "engine ticks")
    tr.add_argument("--no-timeline", action="store_true",
                    help="decision provenance only (no per-tick records)")
    tr.add_argument("--diagnose", action="store_true",
                    help="also run the counterfactual diagnosis and "
                         "stamp its verdict into every sink (JSONL "
                         "record, Perfetto marker track, md section)")
    tr.add_argument("--seconds", type=float, default=10.0)
    tr.add_argument("--interval", type=float, default=0.5)
    tr.add_argument("--model", default=None,
                    help="DIALModel prefix (default: evaluate's model "
                         "resolution order)")
    tr.add_argument("--out", default="reports/trace")
    tr.add_argument("--smoke", action="store_true",
                    help="allow the smoke-grade campaign model")
    tr.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")

    dg = sub.add_parser("diagnose", help="counterfactual replay: "
                                         "attribute a loss to a cause "
                                         "with per-interval evidence")
    dg.add_argument("scenario", nargs="?", default=None,
                    help="catalog scenario name (see `list`)")
    dg.add_argument("--from-report", default=None,
                    help="fuzz report.json to pull triaged loser(s) from")
    dg.add_argument("--fingerprint", default=None,
                    help="which triaged loss to diagnose (with "
                         "--from-report)")
    dg.add_argument("--all", action="store_true",
                    help="diagnose every triaged loss of --from-report")
    dg.add_argument("--seconds", type=float, default=3.0)
    dg.add_argument("--interval", type=float, default=0.5)
    dg.add_argument("--threshold", type=float, default=0.05,
                    help="loss threshold X for the cause cascade")
    dg.add_argument("--max-evidence", type=int, default=8,
                    help="evidence rows kept per diagnosis (total is "
                         "always recorded)")
    dg.add_argument("--model", default=None,
                    help="DIALModel prefix (default: evaluate's model "
                         "resolution order)")
    dg.add_argument("--alt-model", default=None,
                    help="second DIALModel prefix for the model_swap "
                         "arm (was the artifact version the loss?)")
    dg.add_argument("--mesh", type=int, default=None, nargs="?", const=0,
                    help="run the replay arms split over N devices (0 or "
                         "bare flag: every visible card)")
    dg.add_argument("--no-ragged", action="store_true",
                    help="replay losers one at a time instead of one "
                         "traced run per padded shape bucket")
    dg.add_argument("--out", default="reports/diagnose")
    dg.add_argument("--smoke", action="store_true",
                    help="allow the smoke-grade campaign model")
    dg.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")

    args = ap.parse_args(argv)
    if args.cmd == "trace":
        from repro_torch.lab.trace import main as trace_main

        trace_main(args)
        return
    if args.cmd == "diagnose":
        from repro_torch.lab.diagnose import main as diagnose_main

        diagnose_main(args)
        return
    {"list": _cmd_list, "evaluate": _cmd_evaluate,
     "campaign": _cmd_campaign, "continual": _cmd_continual,
     "fuzz": _cmd_fuzz}[args.cmd](args)


if __name__ == "__main__":
    main()
