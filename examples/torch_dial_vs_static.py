"""Decentralized collective behaviour on the PyTorch/CUDA port: four
clients share OSTs; each runs an independent DIAL agent (no
communication).  Compare aggregate delivered bandwidth vs static defaults
as the mix of workloads shifts mid-run -- the adaptivity claim of the
paper at multi-client scope.

Run:  PYTHONPATH=src python examples/torch_dial_vs_static.py [--device cpu]

The counterpart of ``examples/dial_vs_static.py``, with the same
scenario, sizes and printout: one ``DIALAgent(SimClientPort(...))`` per
client, the sim stepped tick by tick (this is the example of independent
agents, so no fused schedule).  The CUDA card is the default device;
without one this raises unless ``--device cpu`` is given.
"""

import argparse
import time

from repro_torch import resolve_device
from repro_torch.core.agent import DIALAgent, SimClientPort
from repro_torch.core.model import DIALModel
from repro_torch.pfs.engine import PFSSim
from repro_torch.pfs.state import READ, WRITE
from repro_torch.pfs.workloads import Workload


def scenario(tuned: bool, seconds: float = 40.0, device=None) -> list:
    dev = resolve_device(device)
    model = DIALModel.load("models/dial", device=dev) if tuned else None
    sim = PFSSim(n_clients=4, n_osts=4, device=dev)
    wls = [
        # phase 1 mix: two seq readers, one random reader, one writer
        Workload(client=0, op=READ, req_size=16 * 2**20, randomness=0.0,
                 n_threads=2, osts=(0, 1)),
        Workload(client=1, op=READ, req_size=8 * 1024, randomness=1.0,
                 n_threads=32, osts=(1,)),
        Workload(client=2, op=WRITE, req_size=1 * 2**20, randomness=0.1,
                 n_threads=4, osts=(2, 3)),
        # late joiner: kicks in mid-run via duty cycling
        Workload(client=3, op=READ, req_size=64 * 1024, randomness=0.9,
                 n_threads=16, osts=(0, 2), duty_cycle=0.5, period=seconds),
    ]
    # heterogeneous starting points: two clients inherit configurations
    # tuned for a PREVIOUS workload phase (the adaptivity scenario)
    starts = {0: (256, 8), 1: (1024, 32), 2: (256, 8), 3: (16, 1)}
    for w in wls:
        sim.attach(w)
        sw, sf = starts[w.client]
        sim.set_knobs(sim.client_oscs(w.client), window_pages=sw,
                      rpcs_in_flight=sf)
    agents = [DIALAgent(SimClientPort(sim, c), model, device=dev)
              for c in range(4)] if tuned else []
    steps = int(0.5 / sim.params.tick)
    for _ in range(int(seconds / 0.5)):
        for _ in range(steps):
            sim.step()
        for a in agents:
            a.tick()
    return [w.done_bytes(sim) / seconds / 1e6 for w in wls]


NAMES = ["seq reader (2 OSTs)", "random-8K reader x32",
         "writer (2 OSTs)", "late 64K shuffled x16"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                    "PyTorch versions")
    dev = resolve_device(ap.parse_args(argv).device)
    t0 = time.perf_counter()
    static = scenario(False, device=dev)
    t1 = time.perf_counter()
    dial = scenario(True, device=dev)
    t2 = time.perf_counter()
    print("per-client delivered bandwidth over a shifting 4-client mix")
    print("(clients 1 and 3 start from configurations tuned for an earlier")
    print(" workload phase — the decentralized-adaptation scenario):\n")
    for name, s, d in zip(NAMES, static, dial):
        print(f"  {name:24s} static={s:7.1f}  DIAL={d:7.1f} MB/s "
              f"({d / max(s, 0.1):5.2f}x)")
    print(f"  {'aggregate':24s} static={sum(static):7.1f}  "
          f"DIAL={sum(dial):7.1f} MB/s ({sum(dial)/sum(static):5.2f}x)")
    print(f"({dev}: static {t1 - t0:.1f} s, DIAL {t2 - t1:.1f} s wall)")


if __name__ == "__main__":
    main()
