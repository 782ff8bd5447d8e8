"""The port's paper runs on the card beside the reference's on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_paper_rows.py DIR

``DIR`` holds what ``benchmarks/torch_paper.sh`` wrote on the card: the
model the CLI trained (``dial.{read,write}.npz``) and the two tables'
``--json`` records.  On the same model this runs the reference's
``benchmarks/table2_h5bench.py::run`` and ``benchmarks/fig3_dlio.py::run``
(their rows and wall times), then each arm once more through the
reference's ``_run`` (unrounded MB/s; the DIAL arms with their fleets
kept, for θ), and prints both packages' rows side by side, the largest
relative MB/s difference of each row's arms, and the first interval at
which a DIAL arm's θ trajectory differs.  Writes ``DIR/compare.json``.
A helper of the tests: it imports both packages, as they do.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import benchmarks.fig3_dlio as fig3  # noqa: E402
import benchmarks.table2_h5bench as t2  # noqa: E402
from repro.core.agent import run_with_agents  # noqa: E402
from repro.core.config_space import SPACE  # noqa: E402
from repro.core.model import DIALModel  # noqa: E402
from repro.pfs import PFSSim  # noqa: E402


def dial_arm(make_wl, model, seconds: float, seed: int):
    """The reference's ``_run`` body for a DIAL arm from the defaults,
    keeping the fleet: (MB/s, θ trajectory)."""
    sim = PFSSim(n_clients=1, n_osts=8, seed=seed)
    wl = make_wl()
    sim.attach(wl)
    sim.set_knobs(sim.client_oscs(0), window_pages=256, rpcs_in_flight=8)
    fleet = run_with_agents(sim, model, [0], seconds)
    traj = [[r.oscs.tolist(), r.ops.tolist(), r.decisions.theta.tolist(),
             r.decisions.changed.tolist()] for r in fleet.decisions]
    return wl.done_bytes(sim) / seconds / 1e6, traj


def first_diff(a: list, b: list):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1.0)


def main(d: str) -> None:
    prefix = os.path.join(d, "dial")
    model = DIALModel.load(prefix)
    with open(os.path.join(d, "table2.json")) as f:
        port2 = json.load(f)
    with open(os.path.join(d, "fig3.json")) as f:
        port3 = json.load(f)
    out = {"table2": [], "fig3": []}

    t0 = time.perf_counter()
    rows2 = t2.run(prefix)
    out["table2_wall_s"] = time.perf_counter() - t0
    for (name, mk), row, p in zip(t2.WORKLOADS, rows2, port2["workloads"]):
        assert p["workload"] == name
        grid = [t2._run(mk, w, f) for w, f in SPACE.configs()]
        mbs, traj = dial_arm(mk, model, t2.SECONDS, 11)
        prow = {"optimal_mbs": round(max(m for _, m in p["grid"]), 1),
                "optimal_cfg": max(p["grid"], key=lambda g: g[1])[0],
                "dial_mbs": round(p["dial_mbs"], 1)}
        rec = dict(workload=name, ref=row, port=prow,
                   static_max_rel=max(rel(m, r) for (_, m), r in
                                      zip(p["grid"], grid)),
                   dial_rel=rel(p["dial_mbs"], mbs),
                   theta_first_diff=first_diff(p["dial_trajectory"], traj),
                   theta_changes=sum(sum(c) for *_, c in traj))
        out["table2"].append(rec)
        print(f"{name:28s} ref optimal {row['optimal_mbs']:8.1f} at "
              f"{tuple(row['optimal_cfg'])}, DIAL {row['dial_mbs']:8.1f} | "
              f"port optimal {prow['optimal_mbs']:8.1f} at "
              f"{tuple(prow['optimal_cfg'])}, DIAL {prow['dial_mbs']:8.1f} | "
              f"static max rel {rec['static_max_rel']:.3e}, DIAL rel "
              f"{rec['dial_rel']:.3e}, θ first differs at "
              f"{rec['theta_first_diff']} ({rec['theta_changes']} changes)")

    t0 = time.perf_counter()
    rows3 = fig3.run(prefix)
    out["fig3_wall_s"] = time.perf_counter() - t0
    for (m, t, o), row, p in zip(fig3.CASES, rows3, port3["cases"]):
        assert p["case"] == [m, t, o]
        base = fig3._run(m, t, o)
        mbs, traj = dial_arm(
            lambda: fig3.dlio_reader(0, m, t, osts=tuple(range(o))), model,
            fig3.SECONDS, 13)
        rec = dict(case=[m, t, o], ref=row,
                   port={"default_mbs": round(p["default_mbs"], 1),
                         "dial_mbs": round(p["dial_mbs"], 1),
                         "speedup": round(p["dial_mbs"]
                                          / max(p["default_mbs"], 1e-9), 2)},
                   default_rel=rel(p["default_mbs"], base),
                   dial_rel=rel(p["dial_mbs"], mbs),
                   theta_first_diff=first_diff(p["dial_trajectory"], traj),
                   theta_changes=sum(sum(c) for *_, c in traj))
        out["fig3"].append(rec)
        print(f"DLIO-{m:9s} t={t:2d} osts={o}: ref default "
              f"{row['default_mbs']:7.1f} DIAL {row['dial_mbs']:7.1f} "
              f"({row['speedup']:.2f}x) | port {rec['port']['default_mbs']:7.1f}"
              f" {rec['port']['dial_mbs']:7.1f} ({rec['port']['speedup']:.2f}x)"
              f" | rel {rec['default_rel']:.3e} / {rec['dial_rel']:.3e}, θ "
              f"first differs at {rec['theta_first_diff']} "
              f"({rec['theta_changes']} changes)")
    print(f"reference walls (CPU): Table II {out['table2_wall_s']:.1f} s, "
          f"Fig. 3 {out['fig3_wall_s']:.1f} s; port ({port2['device']}): "
          f"Table II {port2['wall_s']:.1f} s, Fig. 3 {port3['wall_s']:.1f} s")
    with open(os.path.join(d, "compare.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1])
