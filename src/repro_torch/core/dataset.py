"""Offline training-data collection and model training (paper SIV-A).

The paper collects ~100k read and ~98k write non-zero samples by running
the simplest Filebench workloads -- single-stream I/O with sequential or
random access -- while exploring configurations.  The reference
(``repro/core/dataset.py``) reproduces that recipe against the
simulator; this is its port, with the simulator on the device.  Each
probe interval:

    1. observe H_t = [s_{t-k} .. s_t] under the current theta,
    2. sample a random theta' from the space and apply it,
    3. at the next probe, label the transition with
       1[ tput_{t+1} / tput_t > 1 + eps ]   (eps = 0.15).

Zero-volume intervals are dropped.  The 96 cells (2 ops x 3 patterns x
4 request sizes x 4 thread counts) run together in one simulator, one
isolated OST each.

On the device an interval is one :meth:`FusedEngine.run_interval`, one
:func:`probe_all` over the measured interfaces and one
:func:`snapshot_all`; the host reads the snapshot once per interval.
The per-cell bookkeeping (pending samples, history, the ``rng.integers``
draws) stays on the host in the reference's per-cell order, so the
random stream and the samples are the reference's.  The explored knobs
are written in one :meth:`PFSSim.set_knobs` per interval: every write
takes effect on the next tick, so batching them changes nothing.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import itertools
import os

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.config_space import SPACE, ConfigSpace
from repro_torch.core.gbdt import GBDTParams
from repro_torch.core.metrics import (READ_KNOB_IDX, WRITE_KNOB_IDX,
                                      snapshot_all)
from repro_torch.core.model import DIALModel, dataset_fingerprint
from repro_torch.learn.boost import fit_forest_batch
from repro_torch.pfs.engine import PFSSim
from repro_torch.pfs.engine_torch import FusedEngine
from repro_torch.pfs.state import READ, WRITE
from repro_torch.pfs.stats import probe_all
from repro_torch.pfs.workloads import Workload, table_from_sim

EPS_IMPROVE = 0.15  # the paper's epsilon

REQ_SIZES = (8 * 1024, 64 * 1024, 1 * 2**20, 16 * 2**20)  # 8K/64K/1M/16M
PATTERNS = (0.0, 0.9, 1.0)                        # seq, shuffled, random
THREADS = (1, 4, 16, 32)


@dataclasses.dataclass
class CollectConfig:
    seconds: float = 60.0
    interval: float = 0.5
    reps: int = 4
    k: int = 1
    min_volume_bytes: float = 64 * 1024
    include_contention: bool = False   # beyond-paper enrichment
    seed: int = 0


def _cells() -> list[dict]:
    return [dict(op=op, randomness=rnd, req_size=req, n_threads=thr)
            for op, rnd, req, thr in itertools.product(
                (READ, WRITE), PATTERNS, REQ_SIZES, THREADS)]


def feature_vector(vecs: list, op: int, theta_feat) -> np.ndarray:
    """The model input ``(H_t, theta, theta - theta applied)`` of one
    interface, from its op's snapshot vectors ``[s_{t-k} .. s_t]``
    (float64, as the reference's ``metrics.feature_vector``)."""
    th = np.asarray(theta_feat, dtype=np.float64)
    knobs = READ_KNOB_IDX if op == READ else WRITE_KNOB_IDX
    last = vecs[-1]
    delta = np.array([th[0] - last[knobs[0]], th[1] - last[knobs[1]]])
    return np.concatenate(list(vecs) + [th, delta])


def _build_rep(cells: list, n_noise: int, device) -> PFSSim:
    n = len(cells)
    sim = PFSSim(n_clients=n + n_noise, n_osts=n, device=device)
    for i, cell in enumerate(cells):
        sim.attach(Workload(client=i, op=cell["op"],
                            req_size=cell["req_size"],
                            randomness=cell["randomness"],
                            n_threads=cell["n_threads"], osts=(i,),
                            name=f"cell{i}"))
    # contention traffic rides fresh client ids, so it shares only the
    # cell's OST, never the measured interface itself
    for j in range(n_noise):
        sim.attach(Workload(client=n + j, op=READ, req_size=1 * 2**20,
                            randomness=0.3, n_threads=4,
                            osts=((j + 1) % n,), name=f"noise{j}"))
    return sim


def collect(cfg: CollectConfig = CollectConfig(),
            space: ConfigSpace = SPACE, device=None) -> dict:
    """Run the collection sweep on ``device`` (None = CUDA); returns
    ``{'read': (X, y), 'write': (X, y)}`` as the reference does
    (X float32, y float64)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    Xr, yr, Xw, yw = [], [], [], []
    theta_feats = space.as_features()
    configs = space.configs()

    for _ in range(cfg.reps):
        cells = _cells()
        n = len(cells)
        sim = _build_rep(cells, 4 if cfg.include_contention else 0, dev)
        oscs = [sim.osc_id(i, i) for i in range(n)]
        osc_t = torch.as_tensor(oscs, device=dev)
        ops = np.array([cell["op"] for cell in cells])
        steps = max(int(round(cfg.interval / sim.params.tick)), 1)
        table, wstate = table_from_sim(sim)
        engine = FusedEngine(sim.params, sim.topo, table, steps)
        prev = probe_all(sim, osc_t)
        hist = collections.deque(maxlen=cfg.k + 1)   # host (read, write)
        pending = [None] * n                         # (features, tput_t)

        for _ in range(int(round(cfg.seconds / cfg.interval))):
            sim.state, wstate = engine.run_interval(sim.state, wstate)
            cur = probe_all(sim, osc_t)
            snap = snapshot_all(prev, cur)
            prev = cur
            read_m, write_m, vol_r, vol_w = (
                a.cpu().numpy() for a in (snap.read, snap.write,
                                          snap.read_volume,
                                          snap.write_volume))
            hist.append((read_m, write_m))
            vol = np.where(ops == READ, vol_r, vol_w)
            tput = np.where(ops == READ, read_m[:, 0], write_m[:, 0])
            knob_osc, knob_w, knob_f = [], [], []
            for i in range(n):
                op = int(ops[i])
                # finalize the previous interval's sample with this label
                if pending[i] is not None:
                    feats, tput_prev = pending[i]
                    if tput_prev > 0 and vol[i] >= cfg.min_volume_bytes:
                        label = float(tput[i] / tput_prev > 1.0 + EPS_IMPROVE)
                        (Xr if op == READ else Xw).append(feats)
                        (yr if op == READ else yw).append(label)
                    pending[i] = None
                    continue  # let the new theta settle before re-observing
                # explore on alternating intervals so H_t reflects a steady
                # state under the old theta, as the agent sees at inference
                if len(hist) >= cfg.k + 1 and vol[i] >= cfg.min_volume_bytes:
                    j = int(rng.integers(len(configs)))
                    w, f = configs[j]
                    feats = feature_vector([h[op][i] for h in hist], op,
                                           theta_feats[j])
                    knob_osc.append(oscs[i])
                    knob_w.append(w)
                    knob_f.append(f)
                    pending[i] = (feats, tput[i])
            if knob_osc:
                sim.set_knobs(knob_osc, window_pages=knob_w,
                              rpcs_in_flight=knob_f)

    return {
        "read": (np.array(Xr, dtype=np.float32), np.array(yr)),
        "write": (np.array(Xw, dtype=np.float32), np.array(yw)),
    }


def train_models(data: dict, gbdt_params: GBDTParams | None = None,
                 space: ConfigSpace = SPACE, device=None) -> DIALModel:
    """Fit the read and write GBDTs together, in exact precision, on
    ``device`` (None = CUDA) and bundle them, with ``train_meta``
    (trainer, precision, dataset fingerprint) for artifact validation."""
    for name in ("read", "write"):
        if len(data[name][0]) == 0:
            raise ValueError(f"no {name} samples collected")
    fr, fw = fit_forest_batch([data["read"], data["write"]],
                              gbdt_params or GBDTParams(),
                              precision="exact", device=device)
    return DIALModel(read_forest=fr, write_forest=fw, space=space,
                     train_meta={"trainer_backend": "torch",
                                 "precision": "exact",
                                 "dataset": dataset_fingerprint(data)})


def main(argv=None) -> tuple:
    """The collect + train CLI (the reference's ``main``)::

        PYTHONPATH=src python -m repro_torch.core.dataset [--out models/dial]
            [--seconds 60] [--reps 4] [--contention] [--seed 0]
            [--device cpu]

    Collects and trains on the CUDA card unless ``--device cpu`` is
    given, prints the reference's two sample lines, and saves
    ``<out>.{read,write}.npz`` in the reference's layout (either
    package's ``DIALModel.load`` reads them).  Returns ``(data, model)``.
    """
    ap = argparse.ArgumentParser(
        description="DIAL offline data collection + training")
    ap.add_argument("--out", default="models/dial")
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--contention", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                    "PyTorch versions")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = CollectConfig(seconds=args.seconds, reps=args.reps,
                        include_contention=args.contention, seed=args.seed)
    data = collect(cfg, device=dev)
    for op_name in ("read", "write"):
        X, y = data[op_name]
        print(f"{op_name}: {len(X)} samples, positive rate {y.mean():.3f}")
    model = train_models(data, device=dev)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    model.save(args.out)
    print(f"saved forests to {args.out}.{{read,write}}.npz")
    return data, model


if __name__ == "__main__":
    main()
