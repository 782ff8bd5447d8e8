"""The control of a cell's comparison: the reference put in the
program's place, its engine in float32 (the precision below the
configuration's float64), judged by the float64 reference as a run of
the program is.  Every compared number it reads is an upper reading of
that number; the benchmark's own runs never run it.

    python3 dialbench/control.py --workload <cell> --seeds 1 2 3

prints one JSON line a seed: the readings and whether the cell's limits
pass them (they must not).  A fleet cell reads its first two sessions,
the second from the control's own state, as a run reads its first and
a later one.
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]

import torch  # noqa: E402

from dialbench import compare, generate, harness  # noqa: E402


class Inputs:
    """A cell's generated inputs, in the form the reference reads."""

    def __init__(self, cell, seed: int, device):
        cfg, traffic = cell.config, cell.traffic
        seed = int(seed) % (2**63)
        if traffic["driver"] == "fleet":
            self.ref_scens = [generate.fleet_scenario(cfg)]
            self.n = int(traffic["session_intervals"])
            tuned = bool(traffic["tuned"])
        else:
            self.ref_scens = generate.lab_scenarios(
                cfg, int(traffic["variants"]), seed)
            self.n = int(round(float(traffic["call_seconds"])
                               / float(traffic["interval_s"])))
            tuned = True
        self.forests = (generate.forests(cfg, self.ref_scens, seed, device)
                        if tuned else None)
        self.sessions = 2 if traffic["driver"] == "fleet" else 1


def readings(cell, seed: int, device) -> dict:
    """The float32 control's worst reading of each compared number."""
    inp = Inputs(cell, seed, device)
    start, values = None, []
    for i in range(inp.sessions):
        ctl, fleet = harness.reference_outputs(
            cell, inp, [(i, start, None, inp.n)], torch.float32, device)
        out = harness.ref_as_output(ctl[0][1])
        ref, _ = harness.reference_outputs(
            cell, inp, [(i, start, None, inp.n)], torch.float64, device)
        values.append(compare.numbers(out, ref[0][1],
                                      torch.as_tensor(fleet.osc_ost),
                                      fleet.n_osts))
        start = {k: (v.to(torch.float64) if torch.is_tensor(v)
                     and v.is_floating_point() else v)
                 for k, v in out["state"].items()}
    worst = compare.worst(values)
    return {"seed": seed, "readings": worst,
            "passes_limits": compare.verdict(worst, cell.limits)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.find_cell(ROOT, args.workload)
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload,
                          **readings(cell, seed, args.device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
