"""Traced scenario replay: one command from scenario to Perfetto.

The port of the reference's ``repro/lab/trace.py``.
``python -m repro_torch.lab trace <scenario>`` runs one catalog scenario
(or a triaged fuzz loser, via ``--from-report/--fingerprint``) through
the traced fused loop on the device, then writes the three sinks side
by side:

    trace.jsonl          lossless ``dial-trace-v2`` records
    trace.chrome.json    Chrome ``trace_event`` — open in Perfetto or
                         ``chrome://tracing``
    trace.md             human-readable digest (gate outcomes, θ
                         changes, per-OST throughput)

The records are more outputs of each interval (on the card, static
buffers of its CUDA graph); tracing a run never changes what the run
decides.
"""

from __future__ import annotations

import json
import os

from repro_torch import resolve_device
from repro_torch.lab.batch import run_batch, stack_scenarios
from repro_torch.lab.scenarios import ScenarioSpec, build, get_scenario
from repro_torch.obs.schema import RunTrace, TraceConfig


def load_spec_from_report(path: str, fp: str) -> ScenarioSpec:
    """Rebuild one triaged loss from a fuzz ``report.json`` by its
    fingerprint — the replay half of the report's ``trace_recipe``."""
    from repro_torch.lab.fuzz import spec_from_dict

    with open(path) as f:
        report = json.load(f)
    losses = report.get("triage", {}).get("losses", [])
    for r in losses:
        if r["fingerprint"] == fp:
            return spec_from_dict(r["spec"], name=r["name"])
    have = ", ".join(r["fingerprint"] for r in losses) or "none"
    raise KeyError(f"fingerprint {fp!r} not in {path} (triaged: {have})")


def trace_scenario(spec: ScenarioSpec, model, seconds: float = 10.0,
                   interval: float = 0.5, config: TraceConfig | None = None,
                   graph: bool | None = None, device=None) -> RunTrace:
    """Run ``spec`` DIAL-tuned through the traced fused loop on
    ``device`` (``None``: the CUDA card) and return the normalized
    :class:`RunTrace` (fleet columns = the scenario's interfaces, one OST
    track each)."""
    config = config if config is not None else TraceConfig()
    batch = stack_scenarios([build(spec)], device=resolve_device(device))
    result = run_batch(batch, model=model, seconds=seconds,
                       interval=interval, fused=True, trace=config,
                       graph=graph)
    trace = RunTrace.from_fused(result, config, batch.params.tick)
    trace.validate()
    return trace


def write_trace(trace: RunTrace, out_dir: str,
                title: str = "trace", diagnosis: dict | None = None) -> dict:
    """All three sinks into ``out_dir``; returns their paths.  With
    ``diagnosis`` (a :mod:`repro_torch.obs.diagnose` report), the verdict is
    stamped into every sink: a ``diagnosis`` JSONL record, a Perfetto
    marker track with per-evidence-row instants, a markdown section."""
    from repro_torch.obs.sinks import (render_summary, write_chrome,
                                       write_jsonl)

    os.makedirs(out_dir, exist_ok=True)
    paths = {
        "jsonl": write_jsonl(trace, os.path.join(out_dir, "trace.jsonl"),
                             diagnosis=diagnosis),
        "chrome": write_chrome(trace,
                               os.path.join(out_dir, "trace.chrome.json"),
                               diagnosis=diagnosis),
        "md": os.path.join(out_dir, "trace.md"),
    }
    with open(paths["md"], "w") as f:
        f.write(render_summary(trace, title=title, diagnosis=diagnosis))
    return paths


def main(args) -> int:
    """CLI entry (dispatched from ``repro_torch.lab.__main__``)."""
    from repro_torch.core.model import DIALModel
    from repro_torch.lab.evaluate import default_model
    from repro_torch.obs.sinks import render_summary

    if args.from_report:
        if not args.fingerprint:
            raise SystemExit("--from-report needs --fingerprint "
                             "(see the report's trace_recipe fields)")
        spec = load_spec_from_report(args.from_report, args.fingerprint)
    elif args.scenario:
        spec = get_scenario(args.scenario)
    else:
        raise SystemExit("pass a scenario name or --from-report/"
                         "--fingerprint")

    dev = resolve_device(args.device)
    model = (DIALModel.load(args.model, device=dev) if args.model
             else default_model(smoke=args.smoke, device=dev))
    cfg = TraceConfig(stride=args.stride,
                      timeline=not args.no_timeline)
    trace = trace_scenario(spec, model, seconds=args.seconds,
                           interval=args.interval, config=cfg, device=dev)
    diagnosis = None
    if getattr(args, "diagnose", False):
        from repro_torch.obs.diagnose import DiagnoseConfig, diagnose
        dcfg = DiagnoseConfig(seconds=args.seconds,
                              interval=args.interval)
        diagnosis = diagnose(spec, model, dcfg, device=dev)
    paths = write_trace(trace, args.out, title=spec.name,
                        diagnosis=diagnosis)
    print(render_summary(trace, title=spec.name, diagnosis=diagnosis))
    print(f"wrote {paths['jsonl']}, {paths['chrome']} "
          f"(open in Perfetto), {paths['md']}")
    return 0
