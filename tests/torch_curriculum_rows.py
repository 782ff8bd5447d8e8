"""The port's hard-case curriculum on the card beside the reference's on
the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_curriculum_rows.py DIR

``DIR`` holds what the card run wrote: the model it replayed
(``dial.{read,write}.npz``), the fuzz report (``report.json``) and the
port's ``python -m repro_torch.lab continual --hard-from DIR/report.json
--smoke --max-cases N --model DIR/dial --out DIR/port`` result
(``port/curriculum.json``, every loser of the report).  This runs the
reference's CLI with the same arguments on the CPU into
``DIR/reference/`` and prints both packages' loss rates before and after
the refits, their delta and refits, and each case's cause, weight and
races (DIAL and best-static MB/s, losing or not).  The refit forests
come from different trainers (ROADMAP Queue 3, reference fault 4), so
the after rates are compared as rates.  Writes ``DIR/compare.json``.

A helper of the tests: it imports both packages, as they do, and sets
``jax.experimental.enable_x64 = jax.enable_x64`` (the reference's lab
imports the name jax 0.9.0 moved) in its own process only.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import jax  # noqa: E402
import jax.experimental  # noqa: E402

jax.experimental.enable_x64 = jax.enable_x64
from repro.lab.__main__ import main as ref_main  # noqa: E402


def _race(r: dict) -> str:
    return (f"DIAL {r['dial_mbs']:.3f} / static {r['best_static_mbs']:.3f} "
            f"MB/s at {tuple(r['best_static_theta'])}"
            + (" losing" if r["losing"] else ""))


def main(d: str) -> dict:
    with open(os.path.join(d, "report.json")) as f:
        n = len(json.load(f)["triage"]["losses"])
    with open(os.path.join(d, "port", "curriculum.json")) as f:
        port = json.load(f)
    t0 = time.perf_counter()
    ref_main(["continual", "--hard-from", os.path.join(d, "report.json"),
              "--smoke", "--max-cases", str(n), "--model",
              os.path.join(d, "dial"), "--out",
              os.path.join(d, "reference")])
    ref_s = time.perf_counter() - t0
    with open(os.path.join(d, "reference", "curriculum.json")) as f:
        ref = json.load(f)
    same_cases = [(c["name"], c["cause"], c["weight"]) for c in port["cases"]
                  ] == [(c["name"], c["cause"], c["weight"])
                        for c in ref["cases"]]
    print(f"{n} losers in the report; the same cases, causes and weights: "
          f"{same_cases}; the reference's curriculum took {ref_s:.1f} s on "
          "the CPU")
    for side, r in (("port (card)", port), ("reference (CPU)", ref)):
        o = r["overall"]
        print(f"{side}: {r['n_losers']} losers, {r['n_replays']} replays, "
              f"{r['n_refits']} refits; loss rate {o['before_loss_rate']} "
              f"-> {o['after_loss_rate']} (delta {o['delta']})")
        for cause, b in r["buckets"].items():
            print(f"  {cause}: {b['n']} cases, {b['before_loss_rate']} -> "
                  f"{b['after_loss_rate']}")
    for p, r in zip(port["cases"], ref["cases"]):
        print(f"{p['name']} ({p['cause']}, weight {p['weight']}):")
        for side in ("before", "after"):
            print(f"  {side}: port {_race(p[side])}; reference "
                  f"{_race(r[side])}")
    out = dict(n_losers=n, same_cases=same_cases, reference_s=ref_s,
               port={k: port[k] for k in ("n_losers", "n_replays",
                                          "n_refits", "overall", "buckets")},
               reference={k: ref[k] for k in ("n_losers", "n_replays",
                                              "n_refits", "overall",
                                              "buckets")})
    with open(os.path.join(d, "compare.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main(sys.argv[1])
