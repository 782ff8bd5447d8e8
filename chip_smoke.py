#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of DIAL on one NVIDIA GPU.

    PYTHONPATH=src python3 chip_smoke.py [--seed N] [--model PREFIX]

Phases, in order; any failure exits non-zero:

1. provenance: torch / CUDA versions, the card, ``nvidia-smi``;
2. build: ``nvcc`` compiles every ``src/repro_torch/csrc/*.cu`` (in
   parallel) for sm_90a;
3. kernel checks at the main path's shapes, each kernel against its
   plain PyTorch version: ``segment_sum`` bit-equal to ``np.bincount``
   on the four mappings of the smoke topology, the forest kernels
   within 1e-5 of the plain margins;
4. the main path: ``run_fleet`` on a 256-client x 32-OST PFSSim
   (8,192 interfaces) for 10 intervals of 100 ticks, then
   ``DIALModel.predict_proba`` of the read model over every interface's
   Θ; launch counters are zeroed just before each of the two and read
   just after; then one interval's host-clock
   breakdown and the device's busy share under ``torch.profiler``;
5. the same tuned fleet at 8 x 4 on the card and on the CPU (plain
   versions): identical θ trajectories, counters within 1e-6.

It prints one JSON line of kernel results, the ``nvidia-smi`` name and
power limit, and as its last line
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Without a CUDA
device, or without the repository's ``src/`` beside it, it exits
non-zero and prints no result.

Without ``--model`` the forests are made from ``--seed`` at the default
GBDT shape (160 trees, depth 5), with thresholds drawn from feature
values of a warm-up interval so that descents take both branches.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32, outside tensor cores
N_TREES, DEPTH = 160, 5        # the reference's default GBDTParams
CLIENTS, OSTS = 256, 32        # 8,192 OSC interfaces
SECONDS, INTERVAL = 5.0, 0.5   # 10 tuning intervals of 100 ticks


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call over ``iters`` calls (CUDA events,
    after one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------- #
# scenario and model
# ---------------------------------------------------------------------- #
def build_sim(n_clients: int, n_osts: int, device):
    """The paper's presets, cycling client roles: VPIC writers and
    BDCATS readers striped over 4 OSTs, DLIO readers (4 threads) and a
    random writer on 1 OST."""
    from repro_torch.pfs.engine import PFSSim
    from repro_torch.pfs.state import WRITE
    from repro_torch.pfs import workloads as W

    sim = PFSSim(n_clients, n_osts, device=device)
    for c in range(n_clients):
        stripe = tuple((c + j) % n_osts for j in range(min(4, n_osts)))
        role, k = c % 4, c // 4
        if role == 0:
            sim.attach(W.vpic_write(c, dims=1 + k % 3, osts=stripe))
        elif role == 1:
            sim.attach(W.bdcats_read(c, ("partial", "strided", "full")[k % 3],
                                     osts=stripe))
        elif role == 2:
            sim.attach(W.dlio_reader(c, ("bert", "megatron")[k % 2],
                                     n_threads=4, osts=(c % n_osts,)))
        else:
            sim.attach(W.random_stream(c, WRITE, 256 * 1024, ost=c % n_osts,
                                       n_threads=2))
    return sim


def warmup_features(n_clients: int, n_osts: int, device):
    """Two intervals of the scenario, then every interface's feature rows
    against all of Θ for each op: ``{op: (rows*|Θ|, dim) float32}``, and
    each interface's op model."""
    import torch
    from repro_torch.core.config_space import SPACE
    from repro_torch.core.metrics import fleet_feature_matrix, snapshot_all
    from repro_torch.pfs.engine_torch import FusedEngine
    from repro_torch.pfs.state import READ, WRITE
    from repro_torch.pfs.stats import probe_all
    from repro_torch.pfs.workloads import table_from_sim

    sim = build_sim(n_clients, n_osts, device)
    table, wstate = table_from_sim(sim)
    engine = FusedEngine(sim.params, sim.topo, table, 100)
    snaps, prev = [], probe_all(sim)
    for _ in range(2):
        sim.state, wstate = engine.run_interval(sim.state, wstate)
        cur = probe_all(sim)
        snaps.append(snapshot_all(prev, cur))
        prev = cur
    theta = torch.as_tensor(SPACE.as_features(), device=device)
    ops = torch.where(snaps[-1].read_volume >= snaps[-1].write_volume,
                      READ, WRITE)
    feats = {op: fleet_feature_matrix(snaps, op, torch.nonzero(ops == op)[:, 0],
                                      theta) for op in (READ, WRITE)}
    every = {op: fleet_feature_matrix(snaps, op,
                                      torch.arange(sim.n_osc, device=device),
                                      theta) for op in (READ, WRITE)}
    return feats, every


def seeded_forest(rng, x: np.ndarray) -> dict:
    """A depth-5, 160-tree forest over ``x``'s columns whose thresholds
    are values the columns take, so descents go both ways."""
    n_internal, n_leaves = 2 ** DEPTH - 1, 2 ** DEPTH
    feature = rng.integers(0, x.shape[1], size=(N_TREES, n_internal))
    rows = rng.integers(0, x.shape[0], size=(N_TREES, n_internal))
    threshold = x[rows, feature].astype(np.float32)
    leaf = (0.12 * rng.standard_normal((N_TREES, n_leaves))).astype(np.float32)
    return dict(feature=feature.astype(np.int32), threshold=threshold,
                leaf=leaf, base_score=0.1, depth=DEPTH,
                n_features=x.shape[1])


# ---------------------------------------------------------------------- #
# phases
# ---------------------------------------------------------------------- #
def check_segment_sum(smaps: dict, rng) -> dict:
    import torch
    from repro_torch.kernels.segment_reduce.kernel import segment_sum_cuda
    from repro_torch.kernels.segment_reduce.ref import segment_sum_ref

    cases = []
    for name, smap in smaps.items():
        e, s = smap.n_entries, smap.num_segments
        ids_h = smap.ids.cpu().numpy()
        v_h = rng.standard_normal(e) * 10.0 ** rng.uniform(-3, 9, size=e)
        v = torch.as_tensor(v_h, device=smap.ids.device)
        want = np.bincount(ids_h, weights=v_h, minlength=s)
        got = segment_sum_cuda(v, smap).cpu().numpy()
        err_oracle = float(np.abs(got - want).max())
        if not np.array_equal(got.view(np.int64), want.view(np.int64)):
            raise AssertionError(f"segment_sum[{name}] is not bit-equal to "
                                 f"np.bincount: max |diff| {err_oracle}")
        plain = segment_sum_ref(v, smap.ids, s).cpu().numpy()
        scale = np.bincount(ids_h, weights=np.abs(v_h), minlength=s)
        err = np.abs(got - plain)
        if (err > 1e-12 * scale).any():
            raise AssertionError(f"segment_sum[{name}] vs index_add_: "
                                 f"{err.max()} over rtol 1e-12")
        # the kernel reads each value (8 B) and its CSR position (4 B),
        # the S + 1 offsets, and writes S doubles; it never reads the ids
        nbytes = e * (8 + 4) + (s + 1) * 4 + s * 8
        case = dict(
            mapping=name, entries=e, segments=s,
            ms=time_ms(lambda: segment_sum_cuda(v, smap), 200),
            plain_ms=time_ms(lambda: segment_sum_ref(v, smap.ids, s), 200),
            library_ms=time_ms(lambda: torch.bincount(smap.ids, weights=v,
                                                      minlength=s), 200),
            bound_ms=max(nbytes / HBM_BYTES_PER_S, e / F32_OPS_PER_S) * 1e3,
            max_abs_err=err_oracle,
            max_abs_err_vs_index_add=float(err.max()))
        cases.append(case)
        log(f"segment_sum[{name}] E={e} S={s}: bit-equal to np.bincount; "
            f"|kernel - index_add_| max {err.max():.3e}; "
            f"kernel {case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms, "
            f"bincount {case['library_ms']:.4f} ms")
    head = cases[0]   # the OST mapping: most launches, most skewed
    return dict(name="segment_sum", route="cuda",
                source="src/repro_torch/csrc/segment_sum.cu",
                replaces="src/repro/kernels/segment_reduce/kernel.py:27",
                max_abs_err=max(c["max_abs_err"] for c in cases),
                tolerance="bit-equal to np.bincount; "
                "rtol 1e-12 of the segment's sum of |values| vs index_add_",
                ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by="bytes",
                library_ms=head["library_ms"], shape=head["mapping"],
                cases=cases)


def check_forest(name, replaces, x, op, feature, threshold, leaf, base):
    from repro_torch.kernels.gbdt_forest.kernel import forest_margin_cuda
    from repro_torch.kernels.gbdt_forest.ref import paired_forest_margin_ref

    got = forest_margin_cuda(x, op, feature, threshold, leaf, base, DEPTH)
    plain = paired_forest_margin_ref(x, op, feature, threshold, leaf, base,
                                     DEPTH)
    err = float((got - plain).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"{name}: |kernel - plain| {err} over 1e-5")
    n, f = x.shape
    p, t, n_internal = feature.shape
    nbytes = (n * f * 4 + (0 if op is None else n * 4) + n * 4
              + p * t * (n_internal * 8 + 2 ** DEPTH * 4) + p * 4)
    ops = n * t * (DEPTH + 1)
    b_bytes, b_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    entry = dict(
        name=name, route="cuda", source="src/repro_torch/csrc/gbdt_forest.cu",
        replaces=replaces, max_abs_err=err, tolerance="atol 1e-5 on margins",
        ms=time_ms(lambda: forest_margin_cuda(x, op, feature, threshold, leaf,
                                              base, DEPTH), 20),
        plain_ms=time_ms(lambda: paired_forest_margin_ref(
            x, op, feature, threshold, leaf, base, DEPTH), 3),
        bound_ms=max(b_bytes, b_ops) * 1e3,
        bound_by="bytes" if b_bytes >= b_ops else "operations",
        library_ms=None, shape=[n, f])
    log(f"{name} N={n} F={f}: |kernel - plain| max {err:.3e}; kernel "
        f"{entry['ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms, bound "
        f"{entry['bound_ms']:.4f} ms")
    return entry


def check_state(state, where: str) -> None:
    """Every counter finite and non-negative; per-op byte conservation."""
    import torch
    from repro_torch.pfs.state import READ, WRITE

    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{where}: {f.name} not finite")
            if not bool((v >= -1e-6).all()):
                raise AssertionError(f"{where}: {f.name} negative")
    s = {f.name: getattr(state, f.name).double().cpu().numpy()
         for f in dataclasses.fields(state)
         if isinstance(getattr(state, f.name), torch.Tensor)}
    pipe = lambda op: (s["pending"][op] + s["queue_bytes"][op]
                       + s["unready_bytes"][op] + s["ready_bytes"][op])
    for what, a, b in (
            ("read bytes", s["ctr_req_bytes"][READ],
             s["ctr_bytes_done"][READ] + pipe(READ)),
            ("write acceptance", s["ctr_req_bytes"][WRITE],
             s["ctr_bytes_done"][WRITE]),
            ("dirty cache", s["dirty_bytes"], pipe(WRITE))):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-3,
                                   err_msg=f"{where}: {what} conservation")


def fleet_ticks(sim, interval: float) -> int:
    return max(int(round(interval / sim.params.tick)), 1)


def trajectory(fleet):
    return [(r.oscs.tolist(), r.ops.tolist(), r.decisions.theta.tolist(),
             r.decisions.changed.tolist()) for r in fleet.decisions]


def counted(fn):
    """Run ``fn`` with every launch counter set to 0 just before and read
    just after; returns (fn's result, seconds, the launch counts)."""
    import torch
    from repro_torch.kernels import LAUNCHES

    torch.cuda.synchronize()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(LAUNCHES)


def run_phases(seed: int, model_prefix, dev) -> list:
    """Phases 3-5 on device ``dev``; returns the kernels' result dicts."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.convert import model_from_numpy
    from repro_torch.core.fleet import run_fleet
    from repro_torch.core.metrics import feature_dim
    from repro_torch.core.model import DIALModel
    from repro_torch.kernels.gbdt_forest.ops import pack_fleet_rows, \
        pair_forests
    from repro_torch.pfs.engine_torch import FusedEngine
    from repro_torch.pfs.state import READ, WRITE
    from repro_torch.pfs.workloads import table_from_sim

    rng = np.random.default_rng(seed)
    # model: an artifact, or forests from the seed over warm-up features
    feats, every = warmup_features(CLIENTS, OSTS, dev)
    if model_prefix:
        model = DIALModel.load(model_prefix, device=dev)
        model_np = {op: dict(zip(("feature", "threshold", "leaf"),
                                 model.forest(op).numpy_arrays()),
                             base_score=model.forest(op).base_score,
                             depth=model.forest(op).depth,
                             n_features=model.forest(op).n_features)
                    for op in (READ, WRITE)}
    else:
        model_np = {op: seeded_forest(rng, every[op].cpu().numpy())
                    for op in (READ, WRITE)}
        if any(model_np[op]["n_features"] != feature_dim(op)
               for op in (READ, WRITE)):
            raise AssertionError("warm-up features have the wrong width")
        model = model_from_numpy(model_np[READ], model_np[WRITE], device=dev)

    # 3. kernel checks at the main path's shapes
    sim = build_sim(CLIENTS, OSTS, dev)
    table, _ = table_from_sim(sim)
    kernels = [check_segment_sum(
        {"osc_ost": sim.topo.ost_map, "osc_client": sim.topo.client_map,
         "entry_row": table.row_map, "entry_osc": table.osc_map}, rng)]
    feature, threshold, leaf, base, _, n_features = pair_forests(
        model.read_forest, model.write_forest)
    x, op = pack_fleet_rows(feats[READ], feats[WRITE], n_features)
    log(f"fleet rows: {feats[READ].shape[0]} read + {feats[WRITE].shape[0]} "
        f"write = {feats[READ].shape[0] + feats[WRITE].shape[0]}, bucketed "
        f"to {x.shape[0]}")
    to = lambda a: torch.as_tensor(a, device=dev)
    kernels.append(check_forest(
        "paired_forest_margin", "src/repro/kernels/gbdt_forest/kernel.py:96",
        x, op, *map(to, (feature, threshold, leaf, base))))
    rf = model.read_forest
    kernels.append(check_forest(
        "forest_margin", "src/repro/kernels/gbdt_forest/kernel.py:31",
        x[:, :rf.n_features].contiguous(), None, rf.feature[None],
        rf.threshold[None], rf.leaf[None],
        torch.tensor([rf.base_score], dtype=torch.float32, device=dev)))
    del x, op
    torch.cuda.empty_cache()

    # 4. the main path, launches counted only here: the tuned fleet
    # (segment_sum, paired_forest_margin), then the read model scoring
    # every interface's Θ (forest_margin), each counted on its own
    n_intervals = int(round(SECONDS / INTERVAL))
    fleet, t_fleet, counts = counted(lambda: run_fleet(
        sim, model, seconds=SECONDS, interval=INTERVAL, device=dev))
    p_space, _, proba_counts = counted(
        lambda: model.predict_proba(READ, every[READ]))
    check_state(sim.state, "main path")
    decided = sum(len(r) for r in fleet.decisions)
    changed = sum(int(r.decisions.changed.sum()) for r in fleet.decisions)
    if not any(len(r) for r in fleet.decisions):
        raise AssertionError("main path: no interval made a decision")
    if not bool(torch.isfinite(p_space).all()) \
            or p_space.shape[0] != sim.n_osc * 24:
        raise AssertionError("main path: read-model scores malformed")
    paths = {"segment_sum": ("run_fleet", counts),
             "paired_forest_margin": ("run_fleet", counts),
             "forest_margin": ("DIALModel.predict_proba", proba_counts)}
    for k in kernels:
        k["path"], path_counts = paths[k["name"]]
        k["launches"] = path_counts.get(k["name"], 0)
        if k["launches"] <= 0:
            raise AssertionError(f"{k['path']} never launched {k['name']}")
    log(f"main path: {sim.n_clients} clients x {sim.n_osts} OSTs = "
        f"{sim.n_osc} interfaces, {n_intervals} intervals x "
        f"{fleet_ticks(sim, INTERVAL)} ticks in {t_fleet:.3f} s: "
        f"{n_intervals / t_fleet:.3f} intervals/s, "
        f"{t_fleet / n_intervals * 1e3:.2f} ms/interval; "
        f"{decided} decided rows, {changed} θ changes; launches/interval "
        + ", ".join(f"{k}={v / n_intervals:g}" for k, v in counts.items())
        + "; predict_proba over every interface's Θ: "
        + ", ".join(f"{k}={v}" for k, v in proba_counts.items()))

    # where an interval's time goes (host clock, synchronized)
    table, wstate = table_from_sim(sim)
    engine = FusedEngine(sim.params, sim.topo, table,
                         fleet_ticks(sim, INTERVAL))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.state, wstate = engine.run_interval(sim.state, wstate)
    torch.cuda.synchronize()
    t_engine = time.perf_counter() - t0
    t0 = time.perf_counter()
    fleet.tick()
    torch.cuda.synchronize()
    t_tick = time.perf_counter() - t0
    log(f"breakdown: engine interval {t_engine * 1e3:.2f} ms, fleet tick "
        f"{t_tick * 1e3:.2f} ms")
    # device activity of one more interval + tick under the profiler;
    # the busy share is over the unprofiled wall time just measured
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sim.state, wstate = engine.run_interval(sim.state, wstate)
        fleet.tick()
        torch.cuda.synchronize()
    ops = [a for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
    if ops:
        busy = sum(a.device_time_total for a in ops) / 1e3
        top = sorted(ops, key=lambda a: -a.device_time_total)[:6]
        log(f"device: {sum(a.count for a in ops)} device operations, busy "
            f"{busy:.2f} ms of {(t_engine + t_tick) * 1e3:.2f} ms "
            f"({busy / ((t_engine + t_tick) * 1e3):.1%}); top: "
            + "; ".join(f"{a.key[:40]} x{a.count} {a.device_time_total / 1e3:.2f} ms"
                        for a in top))
    else:
        log("device: busy share not measured (the profiler recorded no "
            "device activity)")

    # 5. the card against the CPU's plain versions, small
    model_cpu = model_from_numpy(model_np[READ], model_np[WRITE],
                                 device="cpu")
    runs = {}
    for key, d, m in (("dev", dev, model), ("cpu", "cpu", model_cpu)):
        small = build_sim(8, 4, d)
        small.set_knobs(torch.arange(small.n_osc), window_pages=64,
                        rpcs_in_flight=2)
        runs[key] = (small, run_fleet(small, m, seconds=3.0, interval=0.5,
                                      device=d))
    if trajectory(runs["dev"][1]) != trajectory(runs["cpu"][1]):
        raise AssertionError("8x4 fleet: θ trajectories differ, card vs CPU")
    for f in dataclasses.fields(runs["cpu"][0].state):
        a = getattr(runs["cpu"][0].state, f.name)
        if isinstance(a, torch.Tensor):
            a = a.double().numpy()
            b = getattr(runs["dev"][0].state, f.name).double().cpu().numpy()
            err = np.max(np.abs(a - b) / np.maximum(np.abs(a), 1.0))
            if not err <= 1e-6:
                raise AssertionError(f"8x4 fleet: {f.name} differs by {err}")
    log("reference check: 8x4 fleet on the card == CPU plain versions "
        f"({sum(len(r) for r in runs['cpu'][1].decisions)} decided rows)")

    return kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model", default=None,
                    help="prefix of .read.npz/.write.npz artifacts")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch import _build

    # 1. provenance
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    log(f"provenance: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}, nvidia-smi: {smi}")

    # 2. build
    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for "
        f"{', '.join(_build.sources())} (compiled now: "
        f"{', '.join(reports) or 'none'})")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")

    kernels = run_phases(args.seed, args.model, torch.device("cuda"))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
