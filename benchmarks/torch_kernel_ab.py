#!/usr/bin/env python3
"""Time the port's ``segment_sum``, ``selective_scan``, ``rglru_scan`` and
forest kernels of one source tree on the card, at the main paths' shapes.

    PYTHONPATH=<tree>/src python3 benchmarks/torch_kernel_ab.py --label L

The tree is whichever ``repro_torch`` the path finds, so two commits are
compared on one card by unpacking the other one (``git archive``) into a
git-ignored directory and running this script once per tree, in turns
(parent, change, change, parent), in one call.  Times are CUDA-event
means: from a CUDA graph of 50 calls (the kernel's own time) and eager
(the host's launch included).  ``segment_sum`` takes the maps of the
256-client x 32-OST fleet, one column and the main path's batched forms;
a tree whose kernel takes one column is timed with one launch a column.
``selective_scan`` takes one falcon-mamba-7b prefill layer (4 x 3,072 x
8,192, N = 16, bf16 in), ``rglru_scan`` one recurrentgemma-9b prefill
layer (4 x 3,072 x 4,096, float32, gates as the layer makes them).  The
forest kernel scores the fleet's rows (every interface x 24
configurations, packed by the tree's own ``pack_fleet_rows``, so a tree
that buckets rows to a power of two is timed at its bucket) with a
read/write pair of the default shape (160 trees, depth 5) whose
thresholds are the rows' own feature values; the single form takes the
read forest over every row's first 32 features.  The fleet's untuned
100-tick engine interval is timed on the host clock (synchronized),
where the batched sums show end to end, and the fleet's tuned fused
loop on CUDA graphs (with that forest pair) by its replays' span on
CUDA events and its wall time.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fleet(dev):
    """``chip_smoke.build_sim``'s 256-client x 32-OST fleet and its
    workload table."""
    from chip_smoke import build_sim
    from repro_torch.pfs.workloads import table_from_sim

    sim = build_sim(256, 32, dev)
    return sim, table_from_sim(sim)


def engine_interval_ms(dev, n: int = 5) -> list:
    """Host-clock ms of ``n`` untuned 100-tick engine intervals of the
    fleet, synchronized, after one warm-up interval."""
    import time

    from repro_torch.pfs.engine_torch import FusedEngine

    sim, (table, wstate) = fleet(dev)
    engine = FusedEngine(sim.params, sim.topo, table, 100)
    state, wstate = engine.run_interval(sim.state, wstate)
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, wstate = engine.run_interval(state, wstate)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def segment_sum_times(dev, rng) -> list:
    from chip_smoke import time_ms, time_ms_graph
    from repro_torch.kernels.segment_reduce.kernel import segment_sum_cuda

    sim, (table, _) = fleet(dev)
    maps = {"osc_ost": sim.topo.ost_map, "osc_client": sim.topo.client_map,
            "entry_row": table.row_map, "entry_osc": table.osc_map}
    out = []
    for name, k in (("osc_ost", 1), ("osc_ost", 2), ("osc_client", 1),
                    ("entry_row", 1), ("entry_osc", 8)):
        smap = maps[name]
        v = torch.as_tensor(rng.standard_normal((k, smap.n_entries)),
                            device=dev)
        try:
            segment_sum_cuda(v, smap)
            run = lambda: segment_sum_cuda(v, smap)  # noqa: E731
            form = "one launch"
        except ValueError:      # a kernel of one column
            rows = list(v)
            run = lambda: [segment_sum_cuda(r, smap)  # noqa: E731
                           for r in rows]
            form = f"{k} launches"
        out.append(dict(mapping=name, columns=k, form=form,
                        graph_ms=time_ms_graph(run),
                        eager_ms=time_ms(run, 200)))
    return out


def selective_scan_times(dev) -> dict:
    import torch.nn.functional as F
    from chip_smoke import time_ms
    from repro_torch.kernels.mamba_scan.kernel import selective_scan_cuda

    b, s, dm, n = 4, 3072, 8192, 16
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    bf = dict(device=dev, dtype=torch.bfloat16)
    u = F.silu(torch.randn((b, s, dm), generator=g, device=dev)).to(**bf)
    delta = F.softplus(torch.randn((b, s, dm), generator=g, device=dev)
                       - 4.0).to(**bf)
    A = -torch.arange(1, n + 1, device=dev, dtype=torch.float32).repeat(dm, 1)
    B, C = (torch.randn((b, s, n), generator=g, device=dev).to(**bf)
            for _ in range(2))
    D = torch.ones(dm, device=dev)
    f32 = [t.float() for t in (u, delta, B, C)]
    return dict(shape=[b, s, dm, n],
                bf16_ms=time_ms(lambda: selective_scan_cuda(
                    u, delta, A, B, C, D), 20),
                f32_ms=time_ms(lambda: selective_scan_cuda(
                    f32[0], f32[1], A, f32[2], f32[3], D), 20))


def rglru_times(dev) -> dict:
    from chip_smoke import time_ms, time_ms_graph
    from repro_torch.kernels.rglru_scan.kernel import rglru_cuda

    b, s, w = 4, 3072, 4096
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    x = torch.randn((b, s, w), generator=g, device=dev)
    lam = torch.log(torch.expm1(torch.linspace(0.35, 0.9, w, device=dev)))
    r = torch.rand((b, s, w), generator=g, device=dev)
    a = torch.exp(-8.0 * torch.nn.functional.softplus(lam) * r)
    run = lambda: rglru_cuda(x, a)  # noqa: E731
    return dict(shape=[b, s, w], graph_ms=time_ms_graph(run, 20),
                eager_ms=time_ms(run, 20))


def fleet_model(dev, rng):
    """The fleet's warm-up feature rows and a read/write forest pair of
    the default shape (160 trees, depth 5) whose thresholds are the
    rows' own feature values."""
    from chip_smoke import warmup_features
    from repro_torch.convert import model_from_numpy
    from repro_torch.pfs.state import READ, WRITE

    feats = warmup_features(256, 32, dev)[0]
    forests = []
    for op in (READ, WRITE):
        rows = feats[op].cpu().numpy()
        feature = rng.integers(0, rows.shape[1], (160, 31))
        threshold = rows[rng.integers(0, len(rows), (160, 31)), feature]
        forests.append(dict(
            feature=feature, threshold=threshold.astype(np.float32),
            leaf=rng.normal(0.0, 0.1, (160, 32)).astype(np.float32),
            base_score=0.0, depth=5, n_features=rows.shape[1]))
    return feats, model_from_numpy(*forests, device=dev)


def fused_replay_times(dev, model, n_runs: int = 3,
                       n_intervals: int = 10) -> dict:
    """The fleet's tuned fused loop on CUDA graphs (phase 6 of
    ``chip_smoke.py``): a first run of ``n_intervals`` (the capture, then
    the replays), then ``n_runs`` runs from the same start; per run the
    replays' span on CUDA events and the run's wall time (host clock,
    synchronized), both in ms per interval."""
    import time

    from repro_torch.pfs.loop_torch import FusedLoop

    sim, (table, wstate) = fleet(dev)
    loop = FusedLoop(sim.params, sim.topo, 100, model)
    loop.run(table, sim.state, wstate, n_intervals)
    first = loop.last_run["device_ms_per_interval"]
    capture_s = loop.last_run["capture_s"] + (
        loop.last_run["instantiate_s"] or 0.0)
    span, wall = [], []
    for _ in range(n_runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop.run(table, sim.state, wstate, n_intervals)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) / n_intervals * 1e3)
        span.append(loop.last_run["device_ms_per_interval"])
    return dict(interfaces=sim.n_osc, intervals=n_intervals,
                capture_s=capture_s, first_run_span_ms=first,
                span_ms=span, wall_ms=wall)


def forest_times(dev, feats, model) -> dict:
    from chip_smoke import time_ms, time_ms_graph
    from repro_torch.kernels.gbdt_forest.kernel import forest_margin_cuda
    from repro_torch.kernels.gbdt_forest.ops import pack_fleet_rows, \
        pair_forests
    from repro_torch.pfs.state import READ, WRITE

    feature, threshold, leaf, base, depth, n_features = (
        torch.as_tensor(v, device=dev) if isinstance(v, np.ndarray) else v
        for v in pair_forests(model.read_forest, model.write_forest))
    x, op = pack_fleet_rows(feats[READ], feats[WRITE], n_features)
    rf = model.read_forest
    x1 = x[:, :rf.n_features].contiguous()
    base1 = torch.tensor([rf.base_score], dtype=torch.float32, device=dev)
    runs = {
        "paired_forest_margin": lambda: forest_margin_cuda(
            x, op, feature, threshold, leaf, base, depth),
        "forest_margin": lambda: forest_margin_cuda(
            x1, None, rf.feature[None], rf.threshold[None], rf.leaf[None],
            base1, depth)}
    n_rows = sum(int(feats[o].shape[0]) for o in (READ, WRITE))
    return {name: dict(rows=n_rows, launch_rows=int(x.shape[0]),
                       graph_ms=time_ms_graph(run), eager_ms=time_ms(run, 20))
            for name, run in runs.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: no CUDA device")
    # the tree under test is the first ``repro_torch`` on the path; once
    # imported, ``chip_smoke`` (its helpers are reused) cannot shadow it
    import repro_torch
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    rng = np.random.default_rng(args.seed)
    feats, model = fleet_model(dev, rng)
    print(json.dumps(dict(
        label=args.label, package=repro_torch.__file__, device=smi,
        segment_sum=segment_sum_times(dev, rng),
        engine_interval_ms=engine_interval_ms(dev),
        fused_replay=fused_replay_times(dev, model),
        selective_scan=selective_scan_times(dev),
        rglru_scan=rglru_times(dev),
        forest=forest_times(dev, feats, model))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
