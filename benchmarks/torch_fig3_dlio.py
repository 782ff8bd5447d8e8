"""Paper Fig. 3 on the PyTorch/CUDA port: deep-learning I/O kernels (DLIO),
DIAL vs default.

    PYTHONPATH=src python3 benchmarks/torch_fig3_dlio.py \
        [--model models/dial] [--device cpu] [--json FILE]

The counterpart of ``benchmarks/fig3_dlio.py``: BERT- and Megatron-style
readers across thread counts and OST spans on a 1-client x 8-OST sim,
each from Lustre's defaults, static and with DIAL.  The paper reports up
to 1.75x over the default configuration.

The arms run on Table II's route (``torch_table2_h5bench.drive``): the
static arm through the engine-only fused loop, the DIAL arm through
``run_fleet(backend="torch-fused")``; on the card each interval is a
CUDA-graph replay.  ``SECONDS`` is read when a run starts, as in the
reference.  The reference's sim takes ``seed=13``; its random generator
is never drawn.  The CUDA card is the default device; without one this
raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from repro_torch import resolve_device  # noqa: E402
from repro_torch.core.model import DIALModel  # noqa: E402
from repro_torch.pfs.workloads import dlio_reader  # noqa: E402

from benchmarks.torch_table2_h5bench import (DEFAULT,  # noqa: E402
                                             device_name, drive, start,
                                             trajectory)

SECONDS = 25.0

CASES = [
    # (model, n_threads, n_osts_used)
    ("bert", 2, 1), ("bert", 8, 1), ("bert", 16, 2), ("bert", 32, 4),
    ("megatron", 2, 1), ("megatron", 8, 1), ("megatron", 16, 2),
    ("megatron", 32, 4),
]


def arm(model_name, threads, osts, dial_model=None, device=None):
    """One arm of a case from the defaults (a ``torch_table2_h5bench.Arm``)."""
    wl = dlio_reader(0, model_name, threads, osts=tuple(range(osts)))
    return drive(start(wl, *DEFAULT, resolve_device(device)), wl,
                 dial_model, SECONDS)


def _run(model_name, threads, osts, dial_model=None, device=None) -> float:
    """The reference's ``_run``: delivered MB/s."""
    return arm(model_name, threads, osts, dial_model, device).mbs


def measure(model, cases=CASES, device=None) -> list[dict]:
    """Per case its default and DIAL arms."""
    return [{"case": (m, t, o), "default": arm(m, t, o, device=device),
             "dial": arm(m, t, o, dial_model=model, device=device)}
            for m, t, o in cases]


def row(c: dict) -> dict:
    """The reference's row of a measured case."""
    (m, t, o), base, dial = c["case"], c["default"].mbs, c["dial"].mbs
    return {"kernel": m, "threads": t, "osts": o,
            "default_mbs": round(base, 1), "dial_mbs": round(dial, 1),
            "speedup": round(dial / max(base, 1e-9), 2)}


def detail(measured: list) -> list[dict]:
    """The measured cases as JSON: unrounded MB/s of both arms, the DIAL
    arm's delivered bytes and θ trajectory."""
    return [{"case": list(c["case"]), "default_mbs": c["default"].mbs,
             "dial_mbs": c["dial"].mbs,
             "dial_done_bytes": c["dial"].done_bytes,
             "dial_trajectory": trajectory(c["dial"].fleet)}
            for c in measured]


def run(model_path: str = "models/dial", device=None) -> list[dict]:
    """Fig. 3's rows, on ``device`` (None = the CUDA card)."""
    dev = resolve_device(device)
    return [row(c) for c in measure(DIALModel.load(model_path, device=dev),
                                    device=dev)]


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
    rows = [row(c) for c in measured]
    for r in rows:
        print(f"DLIO-{r['kernel']:9s} t={r['threads']:2d} osts={r['osts']}: "
              f"default={r['default_mbs']:7.1f}  DIAL={r['dial_mbs']:7.1f}  "
              f"({r['speedup']:.2f}x)")
    best = max(r["speedup"] for r in rows)
    print(f"max speedup over default: {best:.2f}x (paper: up to 1.75x)")
    print(f"{len(rows)} cases x 2 arms, {SECONDS:g} s each, on "
          f"{device_name(dev)}: {wall:.1f} s wall")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": device_name(dev), "seconds": SECONDS,
                       "wall_s": wall, "cases": detail(measured)}, f)


if __name__ == "__main__":
    main()
