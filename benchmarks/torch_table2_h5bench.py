"""Paper Table II on the PyTorch/CUDA port: H5bench-style workloads, DIAL
vs optimal.

    PYTHONPATH=src python3 benchmarks/torch_table2_h5bench.py \
        [--model models/dial] [--device cpu] [--json FILE]

The counterpart of ``benchmarks/table2_h5bench.py``: VPIC-IO (1/2/3-D
contiguous array writes) and BDCATS-IO (partial/strided/full reads) on
a 1-client x 8-OST sim.  'Optimal' is the exhaustive search over Θ's 24
(window, in-flight) pairs; DIAL starts from Lustre's defaults (256, 8)
and tunes online.  The paper's claim: DIAL lands within a few percent
of optimal.

Both arms run on the fused schedule.  A static arm is the engine alone
(:func:`repro_torch.pfs.loop_torch.run_engine`, ``FusedLoop(tuned=False)``;
one loop per sim shape, so the grid of a workload replays one captured
interval); the DIAL arm is ``run_fleet(backend="torch-fused")`` over
client 0's interfaces.  On the card each interval is a CUDA-graph
replay, on the CPU the same loop runs eagerly.  The ticks and decisions
are the reference's ``sim.run`` and ``run_with_agents``'s.

The reference's sim takes ``seed=11``; its random generator is never
drawn, so the port's sim takes none.  The CUDA card is the default
device; without one this raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import NamedTuple

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.core.config_space import SPACE  # noqa: E402
from repro_torch.core.fleet import run_fleet  # noqa: E402
from repro_torch.core.model import DIALModel  # noqa: E402
from repro_torch.pfs.engine import PFSSim  # noqa: E402
from repro_torch.pfs.loop_torch import run_engine  # noqa: E402
from repro_torch.pfs.workloads import bdcats_read, vpic_write  # noqa: E402

SECONDS = 20.0
DEFAULT = (256, 8)                      # Lustre's defaults


class Arm(NamedTuple):
    """One run: delivered MB/s and bytes, the DIAL arm's ``FleetAgent``
    (``None`` for a static arm), and its fused loop's ``last_run``
    (replays, capture seconds, launches per replay)."""

    mbs: float
    done_bytes: float
    fleet: object
    run: dict


def start(wl, window: int, inflight: int, device) -> PFSSim:
    """A 1-client x 8-OST sim with ``wl`` attached, client 0's knobs
    set."""
    sim = PFSSim(n_clients=1, n_osts=8, device=device)
    sim.attach(wl)
    sim.set_knobs(sim.client_oscs(0), window_pages=window,
                  rpcs_in_flight=inflight)
    return sim


def drive(sim: PFSSim, wl, model, seconds: float) -> Arm:
    """``seconds`` of ``sim``: static, or DIAL on client 0 when ``model``
    is given; both on the fused schedule."""
    fleet = None
    if model is None:
        run = run_engine(sim, seconds)
    else:
        fleet = run_fleet(sim, model, oscs=sim.client_oscs(0),
                          seconds=seconds, backend="torch-fused",
                          device=sim.device)
        run = dict(fleet.loop.last_run)
    done = wl.done_bytes(sim)
    return Arm(done / seconds / 1e6, done, fleet, run)


def arm(make_wl, window, inflight, tuned_model=None, seconds=SECONDS,
        device=None) -> Arm:
    """One arm of a workload from (``window``, ``inflight``)."""
    wl = make_wl()
    return drive(start(wl, window, inflight, resolve_device(device)), wl,
                 tuned_model, seconds)


def _run(make_wl, window, inflight, tuned_model=None, seconds=SECONDS,
         device=None) -> float:
    """The reference's ``_run``: delivered MB/s."""
    return arm(make_wl, window, inflight, tuned_model, seconds, device).mbs


def optimal(grid: list) -> tuple[float, tuple]:
    """The best static MB/s of ``[(cfg, MB/s), ...]`` and its (window,
    in-flight); the first wins a tie, as in the reference."""
    best, best_cfg = -1.0, None
    for cfg, mbs in grid:
        if mbs > best:
            best, best_cfg = mbs, cfg
    return best, best_cfg


WORKLOADS = [
    ("VPIC-IO (1D array write)", lambda: vpic_write(0, 1)),
    ("VPIC-IO (2D array write)", lambda: vpic_write(0, 2)),
    ("VPIC-IO (3D array write)", lambda: vpic_write(0, 3)),
    ("BDCATS-IO (partial read)", lambda: bdcats_read(0, "partial")),
    ("BDCATS-IO (strided read)", lambda: bdcats_read(0, "strided")),
    ("BDCATS-IO (full read)", lambda: bdcats_read(0, "full")),
]


def measure(model, configs=None, seconds=SECONDS, workloads=WORKLOADS,
            device=None) -> list[dict]:
    """Per workload its static arms over ``configs`` (default all of Θ)
    and its DIAL arm from the defaults."""
    out = []
    for name, mk in workloads:
        grid = [((w, f), arm(mk, w, f, seconds=seconds, device=device))
                for w, f in (SPACE.configs() if configs is None
                             else configs)]
        out.append({"workload": name, "grid": grid,
                    "dial": arm(mk, *DEFAULT, tuned_model=model,
                                seconds=seconds, device=device)})
    return out


def row(m: dict) -> dict:
    """The reference's row of a measured workload."""
    opt, opt_cfg = optimal([(c, a.mbs) for c, a in m["grid"]])
    dial = m["dial"].mbs
    return {"workload": m["workload"], "optimal_mbs": round(opt, 1),
            "optimal_cfg": opt_cfg, "dial_mbs": round(dial, 1),
            "dial_frac_of_optimal": round(dial / opt, 3)}


def trajectory(fleet) -> list:
    """A DIAL arm's decisions, interval by interval: (interfaces, ops,
    θ, changed)."""
    return [(r.oscs.tolist(), r.ops.tolist(), r.decisions.theta.tolist(),
             r.decisions.changed.tolist()) for r in fleet.decisions]


def detail(measured: list) -> list[dict]:
    """The measured workloads as JSON: unrounded MB/s of every arm, the
    DIAL arm's delivered bytes and θ trajectory."""
    return [{"workload": m["workload"],
             "grid": [[list(cfg), a.mbs] for cfg, a in m["grid"]],
             "dial_mbs": m["dial"].mbs,
             "dial_done_bytes": m["dial"].done_bytes,
             "dial_trajectory": trajectory(m["dial"].fleet)}
            for m in measured]


def run(model_path: str = "models/dial", device=None) -> list[dict]:
    """Table II's rows, on ``device`` (None = the CUDA card)."""
    dev = resolve_device(device)
    return [row(m) for m in measure(DIALModel.load(model_path, device=dev),
                                    device=dev)]


def device_name(dev) -> str:
    """The card's name, or the device's."""
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else str(dev))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="models/dial")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                    "PyTorch versions")
    ap.add_argument("--json", default=None,
                    help="also write every arm's unrounded MB/s and the "
                    "DIAL arms' θ trajectories here")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    measured = measure(DIALModel.load(args.model, device=dev), device=dev)
    wall = time.perf_counter() - t0
    for r in map(row, measured):
        print(f"{r['workload']:28s} optimal={r['optimal_mbs']:8.1f} MB/s "
              f"(w={r['optimal_cfg'][0]},f={r['optimal_cfg'][1]})  "
              f"DIAL={r['dial_mbs']:8.1f} MB/s "
              f"({100 * r['dial_frac_of_optimal']:.1f}% of optimal)")
    print(f"{len(measured)} workloads x {len(SPACE.configs())} static arms "
          f"+ DIAL, {SECONDS:g} s each, on {device_name(dev)}: "
          f"{wall:.1f} s wall")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": device_name(dev), "seconds": SECONDS,
                       "wall_s": wall, "workloads": detail(measured)}, f)


if __name__ == "__main__":
    main()
