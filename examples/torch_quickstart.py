"""Quickstart on the PyTorch/CUDA port: DIAL end to end on the card.

1. Load the learned client-side models (or build small ones).
2. Run a workload on the simulated Lustre cluster from a bad config,
   once static and once with a DIAL agent tuning each OSC interface.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The counterpart of ``examples/quickstart.py``, with the same scenario,
sizes and printout.  The CUDA card is the default device; without one
this raises unless ``--device cpu`` is given.
"""

import argparse
import time

from repro_torch import resolve_device
from repro_torch.core.agent import run_with_agents
from repro_torch.core.dataset import CollectConfig, collect, train_models
from repro_torch.core.gbdt import GBDTParams
from repro_torch.core.model import DIALModel
from repro_torch.pfs.engine import PFSSim
from repro_torch.pfs.state import READ
from repro_torch.pfs.workloads import sequential_stream


def get_model(device) -> DIALModel:
    try:
        model = DIALModel.load("models/dial", device=device)
        print("loaded pretrained forests from models/dial.*")
        return model
    except FileNotFoundError:
        print("collecting a small offline dataset (paper SIV-A recipe)...")
        data = collect(CollectConfig(seconds=40.0, reps=2), device=device)
        print(f"  read samples: {len(data['read'][0])}, "
              f"write samples: {len(data['write'][0])}")
        return train_models(data, GBDTParams(n_trees=80, max_depth=6),
                            device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                    "PyTorch versions")
    dev = resolve_device(ap.parse_args(argv).device)
    t0 = time.perf_counter()
    model = get_model(dev)

    def throughput(tuned: bool) -> float:
        sim = PFSSim(n_clients=1, n_osts=4, device=dev)
        wl = sequential_stream(0, READ, 16 * 2**20, ost=0)
        sim.attach(wl)
        # pathological starting configuration
        sim.set_knobs(sim.client_oscs(0), window_pages=16, rpcs_in_flight=1)
        if tuned:
            run_with_agents(sim, model, clients=[0], seconds=15.0,
                            device=dev)
        else:
            sim.run(15.0)
        return wl.done_bytes(sim) / 15.0 / 1e6

    static = throughput(False)
    dial = throughput(True)
    print("\nsequential 16 MiB reads from (window=16 pages, in-flight=1):")
    print(f"  static : {static:7.1f} MB/s")
    print(f"  DIAL   : {dial:7.1f} MB/s   ({dial / static:.1f}x)")
    print(f"({dev}: {time.perf_counter() - t0:.1f} s wall)")


if __name__ == "__main__":
    main()
