"""Paper Table III on the PyTorch/CUDA port: DIAL's overheads per interface.

    PYTHONPATH=src python3 benchmarks/torch_table3_overhead.py \
        [--model PREFIX] [--seconds 20] [--device cpu] [--out FILE.json]

The counterpart of ``benchmarks/table3_overhead.py``.  Three parts:

1. the host path: one ``DIALAgent(measure_overhead=True)`` on the same
   1-client x 2-OST sim (a sequential reader on OST 0, a random writer
   on OST 1), each interval's 100 engine ticks on the device first;
   per-interface snapshot, inference and end-to-end ms, read and write.
   On the card every stage boundary of a measured tick synchronizes the
   device, so a stage's time is its work's, not its launches' queueing;
2. the fused loop's differential figure on the same 2-client x 2-OST sim
   as the reference's ``run_fused``: the replayed tuned run
   (``FusedLoop``, each interval one CUDA graph replay on the card)
   minus the replayed engine-only run (``tuned=False``), per interface
   x interval.  Each loop runs twice on fresh state; the first run's
   warm-up, capture and instantiate (``compile_s``) are kept apart from
   the second run's replays (``execute_s``,
   :func:`repro_torch.obs.timers.compile_execute_split`); beside the
   wall figure, the same difference of the replays' device span (CUDA
   events);
3. the same figure with the tuned run through a 1-device fleet mesh
   (``run_sharded``, the sim lifted to a one-element batch); its
   engine-only run is part 2's, run again (a one-element shard runs the
   same engine); its ``compile_s`` is the capture and instantiate
   (``loop_cache_stats``).

``--model`` loads a ``DIALModel``; without it a smoke model is trained
(``smoke_campaign()``, under ``build/table3_model/``).  ``--device``
defaults to the CUDA card.  The paper's Table III figures (a 16-core
host) print beside the results for comparison.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.core.agent import DIALAgent, SimClientPort  # noqa: E402
from repro_torch.core.model import DIALModel  # noqa: E402
from repro_torch.obs.timers import compile_execute_split  # noqa: E402
from repro_torch.pfs.engine import PFSSim  # noqa: E402
from repro_torch.pfs.engine_torch import FusedEngine  # noqa: E402
from repro_torch.pfs.loop_torch import FusedLoop  # noqa: E402
from repro_torch.pfs.state import READ, WRITE  # noqa: E402
from repro_torch.pfs.workloads import (random_stream,  # noqa: E402
                                       sequential_stream, table_from_sim)

PAPER = ("paper Table III (a 16-core host): read 0.33 / 10.06 / 24.64 ms, "
         "write 0.85 / 13.51 / 28.82 ms (snapshot / inference / end to end)")


def _sim(n_clients: int, device) -> PFSSim:
    sim = PFSSim(n_clients=n_clients, n_osts=2, device=device)
    sim.attach(sequential_stream(0, READ, 2**20, ost=0, n_threads=4))
    sim.attach(random_stream(n_clients - 1, WRITE, 64 * 1024, ost=1,
                             n_threads=4))
    return sim


def run(model: DIALModel, seconds: float = 20.0, interval: float = 0.5,
        device=None) -> dict:
    """Part 1: the host path's per-interface figures, per op."""
    dev = resolve_device(device)
    sim = _sim(1, dev)
    agent = DIALAgent(SimClientPort(sim, 0), model, measure_overhead=True,
                      device=dev)
    steps = max(int(round(interval / sim.params.tick)), 1)
    table, wstate = table_from_sim(sim)
    engine = FusedEngine(sim.params, sim.topo, table, steps)
    for _ in range(int(round(seconds / interval))):
        sim.state, wstate = engine.run_interval(sim.state, wstate)
        agent.tick()
    return {name: {**agent.timings[op].summary(),
                   "ticks": len(agent.timings[op].end_to_end_ms)}
            for op, name in ((READ, "read"), (WRITE, "write"))}


def _timed_runs(run_once, device) -> dict:
    """Two runs of a loop on fresh state: the first's setup apart."""
    first, second = run_once(), run_once()
    return {"compile_s": first["compile_s"],
            "first_execute_s": first["execute_s"],
            "execute_s": second["execute_s"],
            "replay_device_ms": second.get("replay_device_ms")}


def run_fused(model: DIALModel, sharded: bool = False, seconds: float = 20.0,
              interval: float = 0.5, device=None) -> dict:
    """Parts 2 and 3: the fused differential figure, per interface x
    interval; ``sharded`` runs the tuned loop through a 1-device mesh."""
    from repro_torch.distributed.sharding import fleet_mesh
    from repro_torch.lab.batch import (loop_cache_stats,
                                       reset_loop_cache_stats, run_sharded)

    dev = resolve_device(device)
    probe = _sim(2, dev)
    steps = max(int(round(interval / probe.params.tick)), 1)
    n_intervals = int(round(seconds / interval))
    out = {}
    loops = {"tuned": FusedLoop(probe.params, probe.topo, steps, model),
             "engine_only": FusedLoop(probe.params, probe.topo, steps, None,
                                      tuned=False)}
    for name, loop in loops.items():
        def once(loop=loop):
            s = _sim(2, dev)
            table, wstate = table_from_sim(s)
            r = compile_execute_split(loop, table, s.state, wstate,
                                      n_intervals)
            r["replay_device_ms"] = loop.last_run.get(
                "device_ms_per_interval")
            return r
        out[name] = _timed_runs(once, dev)
    if sharded:
        mesh = fleet_mesh(1) if dev.type == "cuda" else fleet_mesh(
            devices=[dev])

        def once_sharded():
            s = _sim(2, dev)
            table, wstate = table_from_sim(s)
            mask = np.ones((1, s.n_osc), dtype=bool)
            reset_loop_cache_stats()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            run_sharded(s.params, s.topo, s.topo, (table,), s.state, wstate,
                        None, mask, None, model, steps, n_intervals, None,
                        None, None, mesh)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            st = loop_cache_stats()     # the shard's loop: capture s, replays
            return {"compile_s": st["capture_s"],
                    "execute_s": wall - st["capture_s"],
                    "replay_device_ms": (st["replay_device_ms"]
                                         / st["replays"] if st["replays"]
                                         else None)}
        out["tuned"] = _timed_runs(once_sharded, dev)
        out["mesh_devices"] = len(mesh)
    per_if = ((out["tuned"]["execute_s"] - out["engine_only"]["execute_s"])
              / (n_intervals * probe.n_osc) * 1e3)
    out["tuning_ms_per_interface_interval"] = per_if
    dev_t, dev_e = (out[k]["replay_device_ms"]
                    for k in ("tuned", "engine_only"))
    out["device_tuning_ms_per_interface_interval"] = (
        None if dev_t is None or dev_e is None
        else (dev_t - dev_e) / probe.n_osc)
    out["n_intervals"] = n_intervals
    out["n_interfaces"] = probe.n_osc
    return out


def smoke_model(device) -> DIALModel:
    from repro_torch.lab.campaign import run_campaign, smoke_campaign

    cfg, gbdt = smoke_campaign()
    _, model, _ = run_campaign(cfg, out_root=os.path.join(
        ROOT, "build", "table3_model"), gbdt_params=gbdt, smoke=True,
        device=device)
    return model


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip() or "no nvidia-smi output"
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default=None)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--fused-seconds", type=float, default=10.0)
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_line() if dev.type == "cuda" else f"device {dev}"
    model = (DIALModel.load(args.model, device=dev) if args.model
             else smoke_model(dev))
    res = {"device": card, "host": run(model, args.seconds, device=dev)}
    for op in ("read", "write"):
        r = res["host"][op]
        print(f"[{card}] host {op:5s}: snapshot={r['snapshot_ms']:.6f} ms  "
              f"inference={r['inference_ms']:.6f} ms  "
              f"end-to-end={r['end_to_end_ms']:.6f} ms  "
              f"({r['ticks']} decided ticks)")
    for sharded in (False, True):
        rf = run_fused(model, sharded=sharded, seconds=args.fused_seconds,
                       device=dev)
        tag = "torch-sharded" if sharded else "torch-fused"
        res[tag] = rf
        dms = rf["device_tuning_ms_per_interface_interval"]
        print(f"[{card}] {tag}: tuning "
              f"{rf['tuning_ms_per_interface_interval']:.6f} ms/interface/"
              f"interval (wall; tuned run {rf['tuned']['execute_s']:.6f} s, "
              f"engine-only {rf['engine_only']['execute_s']:.6f} s, setup "
              f"{rf['tuned']['compile_s']:.6f} s)"
              + ("" if dms is None else
                 f"; device span {dms:.6f} ms/interface/interval"))
    print(f"({PAPER}; the paper's, for comparison)")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
