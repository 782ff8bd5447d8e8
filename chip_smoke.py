#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of DIAL on one NVIDIA GPU.

    PYTHONPATH=src python3 chip_smoke.py [--seed N] [--model PREFIX]

Phases, in order; any failure exits non-zero:

1. provenance: torch / CUDA versions, the card, ``nvidia-smi``;
2. build: ``nvcc`` compiles every ``src/repro_torch/csrc/*.cu`` (in
   parallel) for sm_90a;
3. the training path (paper SIV-A) through the collect + train CLI
   (``repro_torch.core.dataset``'s ``main``, saved under
   ``build/dial_cli/``): ``collect`` of the 96 cells on a 96 x 96
   PFSSim (9,216 interfaces) for 15 s (30 intervals; cut from 30 s),
   ``train_models`` at the default GBDT shape (160 trees, depth 5,
   exact float64) on its rows; launch counters are zeroed just before
   each and read just after.  A 3 s collect of the next seed on the card
   must give the CPU's labels and rows, and is the held-out set of the
   AUC through ``DIALModel.predict_proba``; the same training on the
   CPU (plain versions) must give the same forests;
4. kernel checks at the main paths' shapes, each kernel against its
   plain PyTorch version: ``segment_sum`` bit-equal to ``np.bincount``
   on the four mappings of the fleet topology, one column and the main
   path's batched forms (two columns on the OST map, eight on the
   interface map), its bound the larger of the bytes and the longest
   segment's chain of dependent float64 adds (``add_chain_cuda``'s rate
   over a long chain, times the segment), ``pow_cr`` (the engine's
   correctly rounded congestion ``pow``) at the engine's shape and over
   2^20 values, bit-equal to its plain version, beside the values libm,
   numpy and ``torch.pow`` round otherwise, the forest kernels on the
   fleet's exact rows (every interface x 24 configurations, no bucket)
   within 1e-5 of the plain margins, two launches bit-equal, timed from
   a CUDA graph (the paired form also at the fused loop's row order,
   every interface's 24 rows under its own op), ``tree_histogram`` on
   the bin codes of a
   paper-scale pair (100,000 read + 98,000 write rows resampled from the
   collected ones) at the five level shapes of a depth-5 tree, float64
   bit-equal and float32 within 1e-6 of the largest |cell|, two
   launches bit-equal; then the float64 order bound: the longest
   segment's count of dependent float64 adds on registers in one thread,
   timed, and beside it the kernel on that segment alone;
5. the paper-scale fit: ``fit_forest_batch`` on that pair in both
   precisions, timed and counted; 20 of the exact fit's 160 trees once
   more under ``torch.profiler`` for the kernel's device time;
6. the tuned fleet: ``run_fleet`` on a 256-client x 32-OST PFSSim
   (8,192 interfaces) for 10 intervals of 100 ticks with the model
   trained in phase 3 (or ``--model``), then from fresh sims built the
   same way ``run_fleet(backend="torch-fused")``, the fused loop, eager
   (``graph=False``) and with each interval a CUDA-graph replay, then
   ``DIALModel.predict_proba`` of the read model over every interface's
   Θ; counters zeroed just before each of the four and read just after
   (the graphed run's launches are those one captured interval holds
   times the replays); θ trajectories identical across the three fleet
   runs, graph bit-equal to eager, every state field within 1e-6 of the
   host run's; ms per interval of each, the capture and instantiate
   time, and a replayed run's ms per interval and device busy share
   (``torch.profiler``); ``segment_sum`` launches per interval and per
   tick of the engine and of the demand step; then one host interval's
   breakdown and the device's busy share;
7. the same tuned fleet at 8 x 4 on the card and on the CPU (plain
   versions), host loop and fused loop: identical θ trajectories,
   counters within 1e-6;
8. LM serving: ``serve`` of recurrentgemma-9b, falcon-mamba-7b and
   gemma2-2b at their full published configs (width and depth, bf16,
   random weights from the seed), 4 prompts of 3,072 tokens and 32
   greedy tokens each, one model at a time, counters zeroed just before
   each and read just after (flash_attention, rglru_scan and
   selective_scan must each launch where the model has the layer),
   then one prefill and 8 decode steps of it once more under the
   profiler for the device's time by kernel class;
   then each kernel against its plain version at one layer's real
   shapes, timed beside SDPA for attention (each of its launch forms:
   bf16 prefill on tensor cores, the bf16 split-KV decode, and float32
   prefill and decode on CUDA cores); bf16 is held at atol 3e-2 and each
   output row within 5% of its RMS; the scan's bound counts its
   exponentials on the SFU at the card's highest SM clock; then the
   smoke configs in
   float32 on the card and on the CPU (plain versions), the same
   weights: identical greedy tokens, logits within 1e-4;
9. the Scenario Lab, with the model phase 3 trained: ``evaluate`` of
   the 12-scenario catalog (25 policy arms each, 2.5 s at 0.5 s, 4
   buckets) on the host path, the fused loop eager, on CUDA graphs and
   on graphs again (rows identical all four ways, bit for bit; 4
   buckets and 4 dispatches; the wall time, captures and their seconds
   and the loop cache's hits and misses of each), then 1,024
   ``variants`` of noisy_neighbor (8,192 interfaces) through
   ``run_batch(fused=True)`` for 10 intervals eager, on graphs and on
   graphs again (graph bit-equal to eager; ms per replayed interval on
   CUDA events, one replayed interval's busy share under
   ``torch.profiler``, launches per interval), ``segment_sum`` on the
   four maps of that batch and of each catalog bucket and the forest on
   each one's rows against their plain versions, and ``smoke_campaign()``
   (its 15 s cut to 7.5 s) through ``run_campaign`` on the card and on
   the CPU (the collected rows and labels identical, forests equal);
   counters zeroed just before each run and read just after, every
   number beside the card's name and power limit;
10. observability and the loss-finding pipeline, with the same model:
   the 8,192-interface fleet of phase 6 through a traced fused loop
   (``TraceConfig(stride=20)``) eager and on a graph, and untraced on a
   graph (θ, decisions and state bit-equal to the untraced replay's;
   every record, provenance and timeline, bit-equal to the traced
   eager run's), then replayed runs of the two loops alternated in this
   process for the traced-vs-untraced span (CUDA events), and eager runs
   of 3 intervals alternated for the host-bound eager interval's wall
   time; the fuzz sweep at ``FuzzConfig``'s defaults (the 24-point Θ
   grid, 6 s, four topologies, 0-3 events) cut from 512 to 8
   scenarios, diagnosis on, twice on graphs (the two ``report.json``
   byte-identical; wall time, captures, buckets); ``SMOKE`` cut from 64
   to 4 scenarios on the
   card on graphs and eager and on the CPU (the three reports
   byte-identical), and its losers through ``diagnose_many`` on graphs
   and eager (identical, equal to the sweep's diagnoses); ``trace`` of the worst
   triaged loser written as JSONL, Chrome and markdown and read back;
   ``segment_sum`` as the timeline tap launches it (five columns on the
   fleet's OST map) and on each fuzz bucket's maps, and the forest on
   each bucket's rows, against their plain versions.  Launches of each
   run go into rows 1 and 2.  Its outputs are written under
   ``build/obs/``;
11. the rest of DIAL's side, with the same model: ``run_comparison(
   "failing_ost", seconds=10)`` (frozen vs online refit, 20 intervals
   x 2 arms, refits of 40 x 5 trees) on the card here and in a child
   process (reports byte-identical) and on the CPU in another child (the frozen
   arm bit-equal, the online arm through its first refit; a later
   difference is logged with its interval); ``continual --hard-from``
   on phase 10's cut-sweep report with the ``--smoke`` settings through
   the CLI in a third child (the after races capture anew); the three
   children run beside the first comparison (each a host-bound loop on
   its own cores);
   ``FleetAgent(measure_overhead=True)`` on phase 6's fleet for its 10
   intervals (θ identical to phase 6's host loop; per-interface
   snapshot, inference and end-to-end ms); the wide batch through
   ``run_batch(fused=True, mesh=fleet_mesh())`` on graphs beside the
   unsharded run, alternated (bit-equal; ms per replayed interval of
   each); and the three kernels at the continual path's shapes
   (``segment_sum`` on the 4 x 4 scenario's maps, the paired forest on
   its 16 x 24 rows, ``tree_histogram`` on the first refit's rows)
   against their plain versions.  Launches go into rows 1, 2 and 4;
   outputs under ``build/dial/``;
12. LM training with DIAL in its data path, with the same model:
   ``train("gemma2-2b", smoke=False)`` at its full published config for
   6 steps of 4 x 2,048 tokens, the pipeline's 4 host clients tuned by
   DIAL (every loss and grad norm finite; per step the ``next_batch``
   and train-step ms, tokens/s, MFU, peak GiB, decisions and ingest
   MB/s; ``segment_sum`` and the paired forest launched, the three LM
   kernels not); the three smoke configs in float32 card vs CPU from
   one seeded parameter tree and the same pipeline (losses and grad
   norms within 1e-4, parameters within 1e-4 of a leaf's max, θ and
   decisions bit-equal); resume on the card (6 steps against 3 + a
   checkpoint + 3, losses within 1e-5) and ``pfs_write`` of that
   checkpoint card vs CPU (within 1e-9); the LM kernels raising on
   ``requires_grad`` inputs; and ``run_continual`` of degraded_ost,
   frozen, card == the CPU engine with the card's ``pow`` (ROADMAP Queue
   3), its first difference from the CPU with numpy's ``power`` logged.
   The full run's launches go into the ``segment_sum``, ``pow_cr`` and
   paired-forest rows; outputs under ``build/train/``.

13. the other seven families, one model at a time: ``serve`` of
   olmoe-1b-7b, qwen2-moe-a2.7b, musicgen-large (tokens (B, T, 4)),
   stablelm-12b (head dim 160) and starcoder2-15b at 4 x 3,072 prompt
   tokens, qwen1.5-32b at 1 x 3,072 and llava-next-34b at 1 x (2,880
   random image positions + 3,072 tokens) -- batch 4 does not fit
   beside their ~70 GB of weights -- at their full published configs,
   bf16, 32 greedy tokens, counters zeroed just before each and read
   just after (flash_attention must launch in each; the MoE models'
   share of routed assignments dropped at prefill, by layer); the
   device breakdown of olmoe-1b-7b and stablelm-12b; one full-width
   MoE layer of each MoE family at 1 x 512 tokens on the card and the
   CPU (tokens routed otherwise counted, the groups routed alike
   within the bf16 bar); the seven smoke configs in float32 card vs
   CPU (greedy tokens identical, logits within 1e-4; the loss, every
   gradient and one AdamW step within 1e-4); an MoE smoke config served
   twice on the card, bit-equal;
14. the LM over a mesh, one process a visible card (NCCL; one card is a
   1 x 1 mesh, still through DTensor): gemma2-2b at its full config on
   phase 12's shape, two sharded train steps (parameters by
   ``param_pspecs``, ZeRO-1 moments, the batch over the data axes)
   against the same steps unsharded on card 0 (the first batch's
   gradients leaf by leaf, bit-equal on 1 x 1; loss, grad norm,
   parameters over the update), a save under the mesh re-placed on the
   transposed mesh, the EF-int8 compressed and plain data-parallel
   gradients and their reductions' ms;
15. sharded serving: ``serve(..., mesh=...)`` of phase 8's three models
   at their full configs on phase 8's shape, one process a visible card,
   every kernel on its rank's local shards (counters zeroed just before
   each serve and read just after: flash_attention, rglru_scan and
   selective_scan must launch), on 1 x 1 the prefill logits and greedy
   tokens bit-equal to phase 8's; prefill s, decode ms a step and peak
   GiB beside phase 8's; and the records of a CPU child started after
   the build and held to two of the host's cores, ``launch/dryrun.py``
   of gemma2-2b's four shapes on both production meshes (256 and 512
   ranks of a fake process group) at its full config, under
   ``build/dryrun/``;
16. (run before phase 15, its CPU side from before phase 13) the
   paper's experiments, with phase 3's model, through
   ``benchmarks/torch_table2_h5bench.py`` and ``torch_fig3_dlio.py``:
   Table II's six workloads (static arms at (256, 8), (16, 1) and
   (1024, 32) of Θ's 24, and the DIAL arm from (256, 8)) and Fig. 3's
   bert 16 x 2 and megatron 32 x 4 (default and DIAL), each 2.5 s (cut
   from 20 and 25 s), on the card (static arms through one engine-only
   fused loop per sim shape, DIAL arms through ``run_fleet(backend=
   "torch-fused")``, every interval a CUDA-graph replay) and in three
   CPU children with the card's congestion ``pow``
   (``pow_cr``'s plain version): every arm's delivered bytes bit-equal,
   the DIAL arms' θ trajectories and the rows (``optimal_cfg``
   included) identical; launches counted and replayed go into the
   ``segment_sum``, ``pow_cr`` and paired-forest rows; ``segment_sum``
   on the 1 x 8 sim's maps and the forest on its 8 x 24 rows against
   their plain versions; under ``build/paper/``.

It prints one JSON line of kernel results, the ``nvidia-smi`` name and
power limit, and as its last line
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Without a CUDA
device, or without the repository's ``src/`` beside it, it exits
non-zero and prints no result.
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
sys.path.insert(0, ROOT)         # benchmarks/ (phase 16's scripts)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32, outside tensor cores
F64_OPS_PER_S = 34e12          # H100 SXM float64, outside tensor cores
SFU_PER_CLOCK_PER_SM = 16      # exp2 results (CUDA guide, compute 9.0)
DEPTH = 5                      # the default GBDTParams' depth
CLIENTS, OSTS = 256, 32        # 8,192 OSC interfaces
SECONDS, INTERVAL = 5.0, 0.5   # 10 tuning intervals of 100 ticks
# 30 collection intervals (paper SIV-A's recipe; cut from 30 s to keep the
# smoke with phase 16 inside 80% of its limit)
COLLECT_SECONDS = 15.0
PAPER_ROWS = {"read": 100_000, "write": 98_000}   # paper SIV-A sample counts
PROFILE_TREES = 20             # the profiled fit's trees (of 160; cut)
# (n_nodes, right children parked on the drop id) of a depth-5 tree's
# five histogram launches: the root, then the left children of each level
LEVELS = ((1, False), (1, True), (2, True), (4, True), (8, True))


# what a later phase holds against phase 6's host loop
MAIN_PATH: dict = {}
# phase 8's serve outputs by arch (tokens, prefill logits on the host),
# which phase 15's 1 x 1 mesh serve must equal bit for bit
SERVED: dict = {}


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    """Each visible card's name and power limit, a line each, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


def max_sm_clock_mhz() -> float:
    """The card's highest SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True, timeout=60).stdout
    return float(out.split()[0])


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


def time_ms_graph(fn, iters: int = 50) -> float:
    """Mean device milliseconds per call of ``fn``, replayed from one CUDA
    graph of ``iters`` calls: for calls shorter than their host launch
    cost, which ``time_ms`` would measure instead."""
    import torch
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return time_ms(graph.replay, 5) / iters


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
    """Two intervals of the scenario, then the feature rows against all
    of Θ, ``{op: (rows*|Θ|, dim) float32}``: of the interfaces whose op
    model it is, and of every interface; and each interface's op."""
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
    return feats, every, ops


def auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Area under the ROC curve (rank statistic; ties broken by order)."""
    order = np.argsort(scores)
    r = np.empty(len(scores))
    r[order] = np.arange(1, len(scores) + 1)
    pos = labels == 1
    n_pos, n_neg = pos.sum(), (~pos).sum()
    return float((r[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def assert_forests_match(a, b, what: str, tol: float = 1e-5) -> None:
    """The reference trainers' parity bar: features equal, thresholds
    and leaves within ``tol``, base score equal."""
    fa, ta, la = a.numpy_arrays()
    fb, tb, lb = b.numpy_arrays()
    with np.errstate(invalid="ignore"):      # inf - inf
        thr_ok = (np.abs(ta - tb) <= tol) | (np.isinf(ta) & np.isinf(tb))
    if not (np.array_equal(fa, fb) and thr_ok.all()
            and np.abs(la - lb).max() <= tol
            and abs(a.base_score - b.base_score) <= tol):
        raise AssertionError(f"{what}: forests differ (features equal: "
                             f"{np.array_equal(fa, fb)}, max |leaf diff| "
                             f"{np.abs(la - lb).max()})")


# ---------------------------------------------------------------------- #
# phases
# ---------------------------------------------------------------------- #
def check_segment_sum(smaps: dict, rng) -> dict:
    """``segment_sum`` on the fleet's maps, one column and the engine's
    and demand step's batched forms, against ``np.bincount``; its bound is
    the larger of the bytes and the ordered add chain of the map's
    longest segment."""
    import torch
    from repro_torch.kernels.segment_reduce.kernel import segment_sum_cuda
    from repro_torch.kernels.segment_reduce.ref import segment_sum_ref
    from repro_torch.kernels.tree_histogram.kernel import add_chain_cuda

    # the order bound's rate: one thread's dependent float64 adds on
    # registers over a long chain (its launch cost spread thin)
    dev = next(iter(smaps.values()))[0].ids.device
    v8 = torch.as_tensor(rng.standard_normal(8), device=dev)
    n_rate = 1 << 20
    want = np.cumsum(np.resize(v8.cpu().numpy(), n_rate))[-1]
    if not float(add_chain_cuda(v8, n_rate)) == float(want):
        raise AssertionError("add_chain: not the ordered sum")
    ns_per_add = time_ms(lambda: add_chain_cuda(v8, n_rate), 5) * 1e6 / n_rate
    log(f"segment_sum order bound: {ns_per_add:.3f} ns per dependent float64 "
        f"add ({n_rate} adds on registers, one thread)")
    cases = []
    for name, (smap, k) in smaps.items():
        e, s = smap.n_entries, smap.num_segments
        ids_h = smap.ids.cpu().numpy()
        if not ((ids_h >= 0) & (ids_h < s)).all():
            raise AssertionError(f"segment_sum[{name}]: ids out of range")
        v_h = rng.standard_normal((k, e)) * 10.0 ** rng.uniform(-3, 9, (k, e))
        v = torch.as_tensor(v_h if k > 1 else v_h[0], device=dev)
        run = lambda: segment_sum_cuda(v, smap)  # noqa: E731
        got = run()
        if not torch.equal(got, run()):
            raise AssertionError(f"segment_sum[{name}]: two launches differ")
        got = got.cpu().numpy().reshape(k, s)
        want = np.stack([np.bincount(ids_h, weights=col, minlength=s)
                         for col in v_h])
        err_oracle = float(np.abs(got - want).max())
        if not np.array_equal(got.view(np.int64), want.view(np.int64)):
            raise AssertionError(f"segment_sum[{name}] is not bit-equal to "
                                 f"np.bincount: max |diff| {err_oracle}")
        plain = lambda: segment_sum_ref(v, smap.ids, s)  # noqa: E731
        scale = np.stack([np.bincount(ids_h, weights=np.abs(col),
                                      minlength=s) for col in v_h])
        err = np.abs(got - plain().cpu().numpy().reshape(k, s))
        if (err > 1e-12 * scale).any():
            raise AssertionError(f"segment_sum[{name}] vs index_add_: "
                                 f"{err.max()} over rtol 1e-12")
        # one index_add (atomics, no fixed order) onto zeros made ahead
        zeros = torch.zeros(got.shape if k > 1 else (s,), dtype=torch.float64,
                            device=dev)
        library = lambda: zeros.index_add(-1, smap.ids, v)  # noqa: E731
        # the kernel reads each value (8 B) and its CSR position (4 B),
        # the S + 1 offsets, and writes K x S doubles; the order bound is
        # the longest segment's chain of dependent adds
        nbytes = k * e * 8 + e * 4 + (s + 1) * 4 + k * s * 8
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_order = smap.max_len * ns_per_add * 1e-6
        case = dict(
            mapping=name, columns=k, entries=e, segments=s,
            longest=smap.max_len, ms=time_ms_graph(run),
            eager_ms=time_ms(run, 200), plain_ms=time_ms_graph(plain),
            library_ms=time_ms_graph(library),
            chain_launch_ms=time_ms_graph(
                lambda: add_chain_cuda(v8, smap.max_len)),
            bytes_bound_ms=t_bytes, order_bound_ms=t_order,
            bound_ms=max(t_bytes, t_order),
            bound_by="bytes" if t_bytes >= t_order else "operations",
            max_abs_err=err_oracle,
            max_abs_err_vs_index_add=float(err.max()))
        cases.append(case)
        log(f"segment_sum[{name}] K={k} E={e} S={s} (longest {smap.max_len})"
            f": bit-equal to np.bincount, two launches bit-equal; "
            f"|kernel - index_add_| max {err.max():.3e}; kernel "
            f"{case['ms'] * 1e3:.2f} us (CUDA graph; eager "
            f"{case['eager_ms'] * 1e3:.2f} us with the host's launch), plain "
            f"{case['plain_ms'] * 1e3:.2f} us, index_add "
            f"{case['library_ms'] * 1e3:.2f} us; bound "
            f"{case['bound_ms'] * 1e3:.3f} us ({case['bound_by']}: bytes "
            f"{t_bytes * 1e3:.4f} us, add chain {t_order * 1e3:.3f} us; "
            f"add_chain_cuda at {smap.max_len} adds, launch included, "
            f"{case['chain_launch_ms'] * 1e3:.2f} us)")
    head = cases[0]   # the OST mapping: most launches, most skewed
    return dict(name="segment_sum", route="cuda",
                source="src/repro_torch/csrc/segment_sum.cu",
                replaces="src/repro/kernels/segment_reduce/kernel.py:27",
                max_abs_err=max(c["max_abs_err"] for c in cases),
                tolerance="bit-equal to np.bincount per column; two "
                "launches bit-equal; rtol 1e-12 of the segment's sum of "
                "|values| vs index_add_",
                ms=head["ms"], eager_ms=head["eager_ms"],
                plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], library_ms=head["library_ms"],
                shape=f"{head['mapping']}, K={head['columns']}",
                timing="kernel, plain and index_add from a CUDA graph of 50 "
                "calls; eager_ms from 200 calls on the host",
                ns_per_add=ns_per_add, cases=cases)


# float64 operations of one correctly rounded pow (csrc/pow_cr.cu): the
# log, a Newton step through one double-double exp, a second exp, each
# exp ~520 (three products, the Taylor terms, ten squarings)
POW_CR_OPS = 1100


def check_pow_cr(n_osts: int, rng) -> dict:
    """``pow_cr`` (the engine's congestion factor, ``(buffer / queued) **
    e``) at the engine's shape, one value per OST, and over 2^20 values
    of its range: bit-equal to its plain version on the CPU, two
    launches bit-equal; beside it how many values libm's ``pow``, this
    host's numpy ``power`` and ``torch.pow`` on the card round
    otherwise."""
    import math

    import torch
    from repro_torch.kernels.pow_cr.kernel import pow_cr_cuda
    from repro_torch.kernels.pow_cr.ref import pow_cr_ref
    from repro_torch.pfs.state import SimParams

    e = SimParams().congestion_exp
    cases = []
    for n in (n_osts, 1 << 20):
        x_h = np.exp(rng.uniform(np.log(1e-5), np.log(7e7), n))
        x = torch.as_tensor(x_h, device="cuda")
        run = lambda: pow_cr_cuda(x, e)  # noqa: E731
        got = run()
        if not torch.equal(got, run()):
            raise AssertionError("pow_cr: two launches differ")
        got_h = got.cpu().numpy()
        want = pow_cr_ref(torch.from_numpy(x_h), e).numpy()
        if not np.array_equal(got_h.view(np.int64), want.view(np.int64)):
            raise AssertionError(f"pow_cr: {int((got_h != want).sum())} of "
                                 f"{n} values differ from the plain version")
        libm = np.array([math.pow(v, e) for v in x_h])
        nbytes, ops = 16 * n, POW_CR_OPS * n
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F64_OPS_PER_S * 1e3
        case = dict(
            n=n, ms=time_ms_graph(run), eager_ms=time_ms(run, 200),
            plain_ms=time_ms(lambda: pow_cr_ref(x, e), 5),
            library_ms=time_ms_graph(lambda: torch.pow(x, e)),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            max_abs_err=0.0,
            libm_differs=int((libm != got_h).sum()),
            numpy_differs=int((np.power(x_h, e) != got_h).sum()),
            torch_pow_differs=int((torch.pow(x, e).cpu().numpy()
                                   != got_h).sum()))
        cases.append(case)
        log(f"pow_cr n={n}: bit-equal to its plain version, two launches "
            f"bit-equal; kernel {case['ms'] * 1e3:.2f} us (CUDA graph; eager "
            f"{case['eager_ms'] * 1e3:.2f} us), plain (torch float64 ops on "
            f"the card) {case['plain_ms'] * 1e3:.2f} us, torch.pow "
            f"{case['library_ms'] * 1e3:.2f} us; bound "
            f"{case['bound_ms'] * 1e3:.4f} us ({case['bound_by']}); values "
            f"rounded otherwise by libm pow {case['libm_differs']}, numpy "
            f"power {case['numpy_differs']}, torch.pow on the card "
            f"{case['torch_pow_differs']}")
    head = cases[0]
    return dict(name="pow_cr", route="cuda",
                source="src/repro_torch/csrc/pow_cr.cu",
                replaces="src/repro/pfs/engine_jax.py:175 (jnp.power in the "
                "engine tick; XLA, no Pallas kernel)",
                max_abs_err=0.0,
                tolerance="bit-equal to the plain version on the CPU; two "
                "launches bit-equal",
                ms=head["ms"], eager_ms=head["eager_ms"],
                plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], library_ms=head["library_ms"],
                shape=f"{head['n']} values (one per OST)",
                timing="kernel and torch.pow from a CUDA graph of 50 calls; "
                "plain from 5 eager calls", cases=cases)


def check_forest(name, replaces, x, op, feature, threshold, leaf, base,
                 label: str = ""):
    import torch
    from repro_torch.kernels.gbdt_forest.kernel import forest_margin_cuda
    from repro_torch.kernels.gbdt_forest.ref import paired_forest_margin_ref

    run = lambda: forest_margin_cuda(  # noqa: E731
        x, op, feature, threshold, leaf, base, DEPTH)
    got = run()
    if not torch.equal(got, run()):
        raise AssertionError(f"{name}: two launches differ")
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
        replaces=replaces, max_abs_err=err, tolerance="atol 1e-5 on "
        "margins; two launches bit-equal",
        ms=time_ms_graph(run), eager_ms=time_ms(run, 20),
        plain_ms=time_ms(lambda: paired_forest_margin_ref(
            x, op, feature, threshold, leaf, base, DEPTH), 3),
        bound_ms=max(b_bytes, b_ops) * 1e3,
        bound_by="bytes" if b_bytes >= b_ops else "operations",
        library_ms=None, shape=[n, f],
        timing="ms from a CUDA graph of 50 calls; eager_ms from 20 calls")
    log(f"{name}{label} N={n} F={f}: |kernel - plain| max {err:.3e}; kernel "
        f"{entry['ms']:.4f} ms (graph; eager {entry['eager_ms']:.4f}), "
        f"plain {entry['plain_ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms")
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


def fused_check(fleet, sim, fused: dict) -> None:
    """The 8,192-interface check: the host loop's θ trajectory, the fused
    loop's eager and graphed ones identical; graph bit-equal to eager
    (decision records with their probabilities, every state field);
    every state field of the graphed run within 1e-6 (relative, floor 1)
    of the host run's."""
    import torch

    want = trajectory(fleet)
    for name, run in fused.items():
        if trajectory(run["fleet"]) != want:
            raise AssertionError(f"{sim.n_osc} interfaces: the fused loop's "
                                 f"({name}) θ trajectory differs from the "
                                 "host loop's")
    eager, graph = fused["eager"], fused["graph"]
    for a, b in zip(eager["fleet"].decisions, graph["fleet"].decisions):
        for f in dataclasses.fields(a.decisions):
            if not torch.equal(getattr(a.decisions, f.name),
                               getattr(b.decisions, f.name)):
                raise AssertionError(f"graph vs eager: decision {f.name} "
                                     "differs")
    for f in dataclasses.fields(eager["sim"].state):
        a = getattr(eager["sim"].state, f.name)
        b = getattr(graph["sim"].state, f.name)
        if not (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b):
            raise AssertionError(f"graph vs eager: state {f.name} differs")
    worst, exact = 0.0, True
    for f in dataclasses.fields(sim.state):
        a = getattr(sim.state, f.name)
        if not isinstance(a, torch.Tensor):
            continue
        b = getattr(graph["sim"].state, f.name)
        exact = exact and torch.equal(a, b)
        a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
        err = float(np.max(np.abs(a - b) / np.maximum(np.abs(a), 1.0)))
        if not err <= 1e-6:
            raise AssertionError(f"fused vs host loop: {f.name} differs by "
                                 f"{err}")
        worst = max(worst, err)
    probs_equal = all(torch.equal(a.decisions.probs, b.decisions.probs)
                      for a, b in zip(fleet.decisions,
                                      graph["fleet"].decisions))
    log(f"reference check: {sim.n_osc} interfaces, {len(want)} intervals: "
        f"θ trajectories identical (host loop, fused eager, fused graph; "
        f"{sum(len(r) for r in fleet.decisions)} decided rows), graph "
        f"bit-equal to eager, state vs the host loop max rel diff {worst:.3e}"
        f" (bit-equal: {exact}), probabilities equal to the host loop's: "
        f"{probs_equal}")


def profile_replay(loop, table, make_inputs):
    """One replayed interval of ``loop`` (its graph already captured):
    its wall time (host clock, synchronized) and, in a second replay
    under ``torch.profiler``, the device operations it ran.  Returns
    ``(wall seconds, the profiler's device rows)``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    inputs = make_inputs()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop.advance(table, inputs, 1)
    torch.cuda.synchronize()
    t_one = time.perf_counter() - t0
    if loop.last_run["captured_now"]:
        raise AssertionError("profiled replay: the interval was captured "
                             "again")
    inputs = make_inputs()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loop.advance(table, inputs, 1)
        torch.cuda.synchronize()
    return t_one, [a for a in prof.key_averages()
                   if a.device_type == DeviceType.CUDA]


def replayed_run(loop, dev, n_intervals: int) -> dict:
    """The graphed loop once its interval is captured, from a fresh sim:
    wall ms per interval of a whole run, and one replayed interval's wall
    time and device busy time (``torch.profiler``)."""
    import torch

    from repro_torch.pfs.workloads import table_from_sim

    sim = build_sim(CLIENTS, OSTS, dev)
    table, wstate = table_from_sim(sim)
    loop.run(table, sim.state, wstate, 1)    # captured if not yet
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop.run(table, sim.state, wstate, n_intervals)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    if loop.last_run["captured_now"]:
        raise AssertionError("replayed run: the interval was captured again")
    t_one, ops = profile_replay(loop, table,
                                lambda: loop.prepare(sim.state, wstate, 1))
    out = dict(replayed_run_ms_per_interval=t_run / n_intervals * 1e3,
               one_replay_wall_ms=t_one * 1e3, busy_ms=None, busy_share=None)
    if ops:
        busy = sum(a.device_time_total for a in ops) / 1e3
        out.update(busy_ms=busy, busy_share=busy / (t_one * 1e3),
                   device_ops=sum(a.count for a in ops))
        top = sorted(ops, key=lambda a: -a.device_time_total)[:6]
        log(f"replayed run: {n_intervals} intervals in {t_run:.3f} s, "
            f"{out['replayed_run_ms_per_interval']:.2f} ms/interval (copy-in "
            f"and the records' host transfer included); one replayed "
            f"interval {t_one * 1e3:.2f} ms wall, device busy {busy:.2f} ms "
            f"({busy / (t_one * 1e3):.1%}) in {out['device_ops']} device "
            f"operations; top: " + "; ".join(
                f"{a.key[:40]} x{a.count} {a.device_time_total / 1e3:.2f} ms"
                for a in top))
    else:
        log(f"replayed run: {n_intervals} intervals in {t_run:.3f} s; one "
            f"replayed interval {t_one * 1e3:.2f} ms wall; busy share not "
            "measured (the profiler recorded no device activity)")
    return out


def training_path(seed: int, dev):
    """Phase 3: the collect + train CLI (``repro_torch.core.dataset``'s
    ``main``) at phase 3's settings on the card, its collect and its
    training each with their launches counted, the AUC on rows collected
    apart; then the card held against the CPU."""
    import torch
    from unittest import mock

    from repro_torch.core import dataset
    from repro_torch.core.dataset import CollectConfig, collect, train_models
    from repro_torch.pfs.state import READ, WRITE

    n_intervals = int(round(COLLECT_SECONDS / 0.5))
    stages = {}

    def staged(name, fn):
        def run(*a, **k):
            out, secs, counts = counted(lambda: fn(*a, **k))
            stages[name] = (secs, counts)
            return out
        return run

    prefix = os.path.join(ROOT, "build", "dial_cli", "dial")
    with mock.patch.object(dataset, "collect", staged("collect", collect)), \
            mock.patch.object(dataset, "train_models",
                              staged("train", train_models)):
        data, model = dataset.main([
            "--out", prefix, "--seconds", str(COLLECT_SECONDS), "--reps",
            "1", "--seed", str(seed)])
    (t_collect, collect_counts), (t_train, train_counts) = (
        stages["collect"], stages["train"])
    for name, (X, y) in data.items():
        if len(X) == 0 or len(set(y.tolist())) != 2 \
                or not np.isfinite(X).all():
            raise AssertionError(f"collect: {name} rows malformed "
                                 f"({len(X)} rows)")
    if collect_counts.get("segment_sum", 0) <= 0:
        raise AssertionError("collect never launched segment_sum")
    log(f"collect (the CLI, --seconds {COLLECT_SECONDS:g} --reps 1; cut "
        f"from 30 s): 96 cells on 9,216 interfaces, {n_intervals} "
        f"intervals in {t_collect:.3f} s ({t_collect / n_intervals * 1e3:.2f} "
        f"ms/interval): {len(data['read'][0])} read rows (positive "
        f"{data['read'][1].mean():.3f}), {len(data['write'][0])} write "
        f"rows (positive {data['write'][1].mean():.3f}); launches "
        + ", ".join(f"{k}={v}" for k, v in collect_counts.items()))
    if train_counts.get("tree_histogram", 0) != 160 * DEPTH:
        raise AssertionError(f"train_models launched tree_histogram "
                             f"{train_counts.get('tree_histogram', 0)} "
                             f"times, not 160 x {DEPTH}")

    # held-out rows: a short collect from another seed, on the card and
    # on the CPU (their rows and labels must agree)
    short = CollectConfig(seconds=3.0, reps=1, seed=seed + 1)
    on_card, on_cpu = collect(short, device=dev), collect(short,
                                                          device="cpu")
    for name in ("read", "write"):
        (Xa, ya), (Xb, yb) = on_card[name], on_cpu[name]
        if Xa.shape != Xb.shape or not np.array_equal(ya, yb) \
                or not np.allclose(Xa, Xb, rtol=1e-5, atol=0.0):
            raise AssertionError(f"collect {name}: card and CPU differ")
    test = {READ: on_card["read"], WRITE: on_card["write"]}
    xs = {op: torch.as_tensor(X, device=dev) for op, (X, _) in test.items()}
    probs, _, auc_counts = counted(lambda: {
        op: model.predict_proba(op, x) for op, x in xs.items()})
    if auc_counts.get("forest_margin", 0) <= 0:
        raise AssertionError("predict_proba never launched forest_margin")
    aucs = {}
    for op, name in ((READ, "read"), (WRITE, "write")):
        p = probs[op].cpu().numpy()
        if not np.isfinite(p).all():
            raise AssertionError(f"{name} model: probabilities not finite")
        aucs[name] = auc(p, test[op][1])
        if not aucs[name] > 0.5:
            raise AssertionError(f"{name} model: held-out AUC {aucs[name]} "
                                 "no better than chance")
    log(f"train_models (the CLI): {len(data['read'][0])} read + "
        f"{len(data['write'][0])} write rows, 160 trees depth {DEPTH} "
        f"exact, in {t_train:.3f} s; launches "
        + ", ".join(f"{k}={v}" for k, v in train_counts.items())
        + f"; saved to {os.path.relpath(prefix, ROOT)}.{{read,write}}.npz; "
        f"held-out AUC (a 3 s collect of seed {seed + 1}) read "
        f"{aucs['read']:.4f} ({len(test[READ][0])} rows), write "
        f"{aucs['write']:.4f} ({len(test[WRITE][0])} rows)")

    # the card against the CPU's plain versions: the same training
    cpu_model = train_models(data, device="cpu")
    for op, name in ((READ, "read"), (WRITE, "write")):
        assert_forests_match(model.forest(op), cpu_model.forest(op),
                             f"train_models {name}, card vs CPU")
        q = cpu_model.predict_proba(op, xs[op].cpu()).numpy()
        err = float(np.abs(probs[op].cpu().numpy() - q).max())
        if not err <= 1e-5:
            raise AssertionError(f"{name} model: card vs CPU probabilities "
                                 f"differ by {err}")
    log("reference check: train_models on the card == CPU plain versions "
        "(features equal, thresholds/leaves within 1e-5); 3 s collect on "
        f"the card == CPU ({len(on_cpu['read'][0])} + "
        f"{len(on_cpu['write'][0])} rows, labels identical, rows within "
        "1e-5)")
    info = dict(collect_s=t_collect, collect_intervals=n_intervals,
                collect_counts=collect_counts, train_s=t_train, auc=aucs,
                train_counts=train_counts, auc_counts=auc_counts)
    return model, data, info


def paper_pair(data: dict, rng) -> list:
    """The paper's sample counts, rows drawn with replacement from the
    collected ones: ``[(X_read, y_read), (X_write, y_write)]``."""
    out = []
    for name, rows in PAPER_ROWS.items():
        X, y = data[name]
        idx = rng.integers(0, len(X), size=rows)
        out.append((X[idx], y[idx]))
    return out


def check_tree_histogram(pair: list, rng, dev) -> dict:
    """``tree_histogram`` on the paper-scale pair's bin codes (binned and
    padded as the trainer does) at the five level shapes, both dtypes."""
    import torch
    from repro_torch.core.gbdt import GBDTParams
    from repro_torch.kernels.tree_histogram.kernel import (add_chain_cuda,
                                                           tree_histogram_cuda)
    from repro_torch.kernels.tree_histogram.ref import tree_histogram_ref
    from repro_torch.learn.boost import prepare_batch, training_index

    p = GBDTParams()
    nb = p.n_bins
    _, padded = prepare_batch(pair, [p] * len(pair))
    stack = lambda attr: torch.as_tensor(
        np.stack([getattr(d, attr) for d in padded]), device=dev)
    index, _ = training_index(stack("Xb"), stack("valid") > 0,
                              torch.full((len(pair),), p.min_child_hess,
                                         device=dev), nb)
    bins_cpu, walk_cpu = index.bins.cpu(), index.walk.cpu()
    b, n, f = index.bins.shape
    n_walked = int(index.walk.sum())        # (forest, feature) pairs
    longest = int((index.bnd[..., 1:] - index.bnd[..., :-1]).max())
    log(f"tree_histogram index: {n_walked} of {b * f} (forest, feature) "
        f"pairs walked; longest segment {longest} of {n} rows")
    cases = []
    for dtype, rate in ((torch.float64, F64_OPS_PER_S),
                        (torch.float32, F32_OPS_PER_S)):
        size = 8 if dtype == torch.float64 else 4
        for n_nodes, drop in LEVELS:
            values = rng.standard_normal((b, 2, n)) \
                * np.array([1.0, 0.25])[None, :, None]
            node = rng.integers(0, n_nodes, size=(b, n))
            if drop:      # right children parked on the drop id
                node = np.where(rng.random((b, n)) < 0.5, node, n_nodes)
            v = torch.as_tensor(values, dtype=dtype, device=dev)
            nd = torch.as_tensor(node, dtype=torch.int32, device=dev)
            run = lambda: tree_histogram_cuda(v, index.perm, index.bnd, nd,
                                              n_nodes)
            got = run()
            if not torch.equal(got, run()):
                raise AssertionError("tree_histogram: two launches differ")
            want = tree_histogram_ref(v.cpu(), bins_cpu, nd.cpu(), n_nodes,
                                      nb, walk_cpu)
            err = float((got.cpu() - want).abs().max())
            scale = float(want.abs().max())
            if dtype == torch.float64:
                if not torch.equal(got.cpu().view(torch.int64),
                                   want.view(torch.int64)):
                    raise AssertionError(f"tree_histogram f64 n_nodes="
                                         f"{n_nodes}: not bit-equal to the "
                                         f"plain version ({err})")
            elif not err <= 1e-6 * scale:
                raise AssertionError(f"tree_histogram f32 n_nodes={n_nodes}: "
                                     f"{err} over 1e-6 x {scale}")
            plain = lambda: tree_histogram_ref(v, index.bins, nd, n_nodes,
                                               nb, index.walk)
            err_card = float((got - plain()).abs().max())
            # one index_add_ of every (sample, walked feature) pair's two
            # channels onto precomputed flat cell ids (ids and rows not
            # timed)
            keep = (nd >= 0) & (nd < n_nodes)
            pairs = index.walk[:, None, :].expand(b, n, f)
            flat = (((torch.arange(b, device=dev)[:, None, None] * n_nodes
                      + torch.where(keep, nd, 0)[:, :, None].long()) * f
                     + torch.arange(f, device=dev)) * nb
                    + index.bins.long())[pairs]
            src = torch.where(keep[:, None], v, 0.0).transpose(1, 2)[
                :, :, None, :].expand(b, n, f, 2)[pairs]
            zeros = torch.zeros((b * n_nodes * f * nb, 2), dtype=dtype,
                                device=dev)
            # the streams the kernel reads: values, node ids, the walked
            # features' order and every bin start; it writes every cell
            nbytes = (b * 2 * n * size + b * n * 4 + n_walked * n * 4
                      + b * f * (nb + 1) * 4 + b * 2 * n_nodes * f * nb * size)
            n_ops = int((keep[:, :, None] & pairs).sum()) * 2
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, n_ops / rate
            case = dict(
                dtype=str(dtype).split(".")[-1], n_nodes=n_nodes, drop=drop,
                ms=time_ms(run, 20),
                plain_ms=time_ms(plain, 5),
                library_ms=time_ms(lambda: zeros.index_add(0, flat, src), 5),
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                max_abs_err=err, max_abs_err_vs_card_plain=err_card,
                max_abs_cell=scale)
            cases.append(case)
            log(f"tree_histogram[{case['dtype']}, {n_nodes} node(s)"
                f"{', drop id' if drop else ''}] B={b} n={n} F={f} "
                f"NB={nb}: {'bit-equal to' if size == 8 else f'{err:.3e} from'}"
                f" the plain version (CPU), {err_card:.3e} from it on the "
                f"card; kernel {case['ms']:.4f} ms, plain "
                f"{case['plain_ms']:.4f} ms, index_add {case['library_ms']:.4f}"
                f" ms, bound {case['bound_ms']:.5f} ms ({case['bound_by']})")
            del flat, src, zeros
    # the float64 order bound: the longest segment's chain of dependent
    # adds alone, operands in registers (one thread, add_chain_cuda)
    v8 = torch.as_tensor(rng.standard_normal(8), device=dev)
    bare = lambda: add_chain_cuda(v8, longest)  # noqa: E731
    want = np.cumsum(np.resize(v8.cpu().numpy(), longest))[-1]
    if not float(bare()) == float(want):
        raise AssertionError("add_chain: not the ordered sum")
    order_ms = time_ms(bare, 20)
    log(f"tree_histogram[float64 order bound]: {longest} dependent adds on "
        f"registers, one thread: {order_ms:.4f} ms "
        f"({order_ms * 1e6 / longest:.2f} ns per add), equal to the ordered "
        "sum")
    # diagnostic: the kernel on that one segment alone (one node, one
    # channel): the walk's own cost per sample over the bare chain
    vc = torch.as_tensor(rng.standard_normal((1, 1, longest)), device=dev)
    pc = torch.arange(longest, dtype=torch.int32, device=dev)[None, None]
    bc = torch.tensor([[[0, longest]]], dtype=torch.int32, device=dev)
    nc = torch.zeros((1, longest), dtype=torch.int32, device=dev)
    one = lambda: tree_histogram_cuda(vc, pc, bc, nc, 1)  # noqa: E731
    got = one()
    want = tree_histogram_ref(vc.cpu(), torch.zeros((1, longest, 1),
                                                    dtype=torch.int32),
                              nc.cpu(), 1, 1)
    if not (torch.equal(got, one()) and torch.equal(
            got.cpu().view(torch.int64), want.view(torch.int64))):
        raise AssertionError("tree_histogram one segment: not bit-equal to "
                             "the plain version, or two launches differ")
    one_ms = time_ms(one, 20)
    log(f"tree_histogram[float64, one segment alone]: {longest} rows, one "
        f"node, one channel: {one_ms:.4f} ms ({one_ms * 1e6 / longest:.2f} "
        f"ns per sample, {one_ms / order_ms:.2f}x the bare chain)")
    tree = [c for c in cases if c["dtype"] == "float64"]
    mean = lambda k: sum(c[k] for c in tree) / len(tree)
    return dict(
        name="tree_histogram", route="cuda",
        source="src/repro_torch/csrc/tree_histogram.cu",
        replaces="src/repro/kernels/tree_histogram/kernel.py:32",
        max_abs_err=max(c["max_abs_err"] for c in tree),
        tolerance="float64 bit-equal to the plain version (CPU); float32 "
        "within 1e-6 of the largest |cell|; two launches bit-equal",
        ms=mean("ms"), plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
        bound_by="bytes" if all(c["bound_by"] == "bytes" for c in tree)
        else "operations",
        library_ms=mean("library_ms"), order_bound_ms=order_ms,
        one_segment_ms=one_ms,
        shape=f"float64, mean of a depth-5 tree's 5 launches (1, 1, 2, 4, 8 "
        f"nodes), B={b} n={n} F={f} NB={nb}, {n_walked} of {b * f} "
        f"features walked, longest segment {longest} rows", cases=cases)


def paper_fit(pair: list, dev) -> dict:
    """Phase 5: the read/write pair at the paper's sample counts, both
    precisions, timed (host binning included) and counted; the first
    :data:`PROFILE_TREES` trees of the exact fit once more under the
    profiler for the kernel's device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.gbdt import GBDTParams
    from repro_torch.learn.boost import fit_forest_batch

    rows = [len(X) for X, _ in pair]
    out = {}
    for precision in ("exact", "fast"):
        forests, secs, counts = counted(lambda: fit_forest_batch(
            pair, GBDTParams(), precision=precision, device=dev))
        launches = counts.get("tree_histogram", 0)
        if launches != 160 * DEPTH:
            raise AssertionError(f"paper-scale {precision} fit launched "
                                 f"tree_histogram {launches} times")
        for f in forests:
            if not bool(torch.isfinite(f.leaf).all()):
                raise AssertionError(f"paper-scale {precision} fit: leaves "
                                     "not finite")
        out[precision] = dict(rows=rows, seconds=secs, launches=launches,
                              wall_ms_per_level=secs * 1e3 / launches)
        log(f"paper-scale fit [{precision}]: {rows[0]} read + {rows[1]} "
            f"write rows (resampled), {secs:.3f} s, tree_histogram "
            f"launches {launches}, {secs * 1e3 / launches:.3f} ms of wall "
            "time per level")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fit_forest_batch(pair, GBDTParams(n_trees=PROFILE_TREES),
                         precision="exact", device=dev)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = [a for a in prof.key_averages()
              if a.device_type == DeviceType.CUDA]
    hist = [a for a in events if "tree_histogram_kernel" in a.key]
    if hist:
        busy = sum(a.device_time_total for a in events) / 1e3
        k_ms = sum(a.device_time_total for a in hist) / 1e3
        k_n = sum(a.count for a in hist)
        out["exact"].update(kernel_device_ms=k_ms, kernel_launches=k_n,
                            device_busy_ms=busy, profiled_wall_ms=wall_ms)
        log(f"paper-scale fit [exact] profiled ({PROFILE_TREES} of its 160 "
            f"trees): tree_histogram {k_n} launches, {k_ms:.2f} ms on the "
            f"device ({k_ms / k_n:.4f} ms each); device busy {busy:.2f} ms "
            f"of this profiled fit's {wall_ms:.2f} ms wall time "
            f"({busy / wall_ms:.1%}; the profiler's host cost is in that "
            f"wall time); that busy time x 160 / {PROFILE_TREES} over the "
            f"unprofiled fit's {out['exact']['seconds'] * 1e3:.2f} ms is "
            f"{busy * 160 / PROFILE_TREES / (out['exact']['seconds'] * 1e3):.1%}")
    else:
        log("paper-scale fit: kernel device time not measured (the "
            "profiler recorded no tree_histogram kernel)")
    return out


def run_phases(seed: int, model_prefix, dev) -> tuple:
    """Phases 3-7 on device ``dev``; returns the kernels' result dicts
    and the model that tuned the fleet."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.convert import forest_to_numpy, model_from_numpy
    from repro_torch.core.fleet import run_fleet
    from repro_torch.core.model import DIALModel
    from repro_torch.kernels.gbdt_forest.ops import pack_fleet_rows, \
        pair_forests
    from repro_torch.pfs.engine_torch import FusedEngine
    from repro_torch.pfs.state import READ, WRITE, engine_step
    from repro_torch.pfs.workloads import table_from_sim

    rng = np.random.default_rng(seed)
    # 3. the training path; its model tunes the fleet unless --model
    model, data, trained = training_path(seed, dev)
    if model_prefix:
        model = DIALModel.load(model_prefix, device=dev)
    model_np = {op: forest_to_numpy(model.forest(op)) for op in (READ, WRITE)}
    feats, every, ops_i = warmup_features(CLIENTS, OSTS, dev)

    # 4. kernel checks at the main paths' shapes
    sim = build_sim(CLIENTS, OSTS, dev)
    table, _ = table_from_sim(sim)
    # the maps with the column counts the main path batches: the engine's
    # per-OST sums alone and in pairs, the demand step's eight per-wave
    # interface sums
    kernels = [check_segment_sum(
        {"osc_ost": (sim.topo.ost_map, 1), "osc_ost x2": (sim.topo.ost_map, 2),
         "osc_client": (sim.topo.client_map, 1),
         "entry_row": (table.row_map, 1), "entry_osc": (table.osc_map, 1),
         "entry_osc x8": (table.osc_map, 8)}, rng),
        check_pow_cr(sim.n_osts, rng)]
    feature, threshold, leaf, base, _, n_features = pair_forests(
        model.read_forest, model.write_forest)
    x, op = pack_fleet_rows(feats[READ], feats[WRITE], n_features)
    log(f"fleet rows: {feats[READ].shape[0]} read + {feats[WRITE].shape[0]} "
        f"write = {x.shape[0]}, scored as they are (no bucket)")
    to = lambda a: torch.as_tensor(a, device=dev)
    kernels.append(check_forest(
        "paired_forest_margin", "src/repro/kernels/gbdt_forest/kernel.py:96",
        x, op, *map(to, (feature, threshold, leaf, base))))
    # the fused loop's row order: every interface's 24 rows under its
    # own op, interfaces in order (both forests in every block's rows)
    m = every[READ].shape[0] // sim.n_osc
    padded = {op: torch.nn.functional.pad(
        every[op], (0, n_features - every[op].shape[1])) for op in every}
    op_rows = ops_i.to(torch.int32).repeat_interleave(m)
    x_f = torch.where((op_rows == READ)[:, None], padded[READ], padded[WRITE])
    order = check_forest(
        "paired_forest_margin", "src/repro/kernels/gbdt_forest/kernel.py:96",
        x_f, op_rows, *map(to, (feature, threshold, leaf, base)),
        label=" (fused loop's row order)")
    kernels[-1]["fused_order"] = {k: order[k] for k in (
        "ms", "eager_ms", "plain_ms", "bound_ms", "max_abs_err", "shape")}
    del padded, x_f, op_rows
    rf = model.read_forest
    kernels.append(check_forest(
        "forest_margin", "src/repro/kernels/gbdt_forest/kernel.py:31",
        x[:, :rf.n_features].contiguous(), None, rf.feature[None],
        rf.threshold[None], rf.leaf[None],
        torch.tensor([rf.base_score], dtype=torch.float32, device=dev)))
    del x, op
    pair = paper_pair(data, rng)
    kernels.append(check_tree_histogram(pair, rng, dev))
    torch.cuda.empty_cache()

    # 5. the paper-scale fit
    kernels[-1]["paper_fit"] = paper_fit(pair, dev)
    kernels[-1]["training"] = {k: trained[k] for k in (
        "collect_s", "collect_intervals", "train_s", "auc")}
    torch.cuda.empty_cache()

    # 6. the main paths, launches counted only here: the tuned fleet
    # (segment_sum, paired_forest_margin) on the host loop, then the fused
    # loop eager and replayed as a CUDA graph (each from a fresh sim built
    # as the first), then the read model scoring every interface's Θ
    # (forest_margin), each counted on its own
    n_intervals = int(round(SECONDS / INTERVAL))
    fleet, t_fleet, counts = counted(lambda: run_fleet(
        sim, model, seconds=SECONDS, interval=INTERVAL, device=dev))
    fused = {}
    for name, graph in (("eager", False), ("graph", None)):
        sim_f = build_sim(CLIENTS, OSTS, dev)
        fl, t_f, c_f = counted(lambda: run_fleet(
            sim_f, model, seconds=SECONDS, interval=INTERVAL, device=dev,
            backend="torch-fused", graph=graph))
        check_state(sim_f.state, f"fused loop ({name})")
        fused[name] = dict(sim=sim_f, fleet=fl, seconds=t_f, counts=c_f,
                           run=dict(fl.loop.last_run))
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
    fused_check(fleet, sim, fused)
    MAIN_PATH["trajectory"] = trajectory(fleet)   # phase 11's overhead run
    graph_run = fused["graph"]["run"]
    replays = graph_run["replays"]
    graph_counts = {k: v * replays
                    for k, v in graph_run["launches_per_replay"].items()}
    fleet_paths = {"run_fleet": counts,
                   "run_fleet torch-fused eager": fused["eager"]["counts"],
                   "run_fleet torch-fused graph (captured x replays)":
                       graph_counts}
    paths = {"segment_sum": fleet_paths, "pow_cr": fleet_paths,
             "paired_forest_margin": fleet_paths,
             "forest_margin": {"DIALModel.predict_proba": proba_counts},
             "tree_histogram": {"train_models": trained["train_counts"]}}
    for k in kernels:
        by_path = {p: c.get(k["name"], 0) for p, c in paths[k["name"]].items()}
        k["path"] = ", ".join(by_path)
        k["launches"] = sum(by_path.values())
        if len(by_path) > 1:
            k["launches_by_path"] = by_path
        for p, c in by_path.items():
            if c <= 0:
                raise AssertionError(f"{p} never launched {k['name']}")
    log(f"main path: {sim.n_clients} clients x {sim.n_osts} OSTs = "
        f"{sim.n_osc} interfaces, {n_intervals} intervals x "
        f"{fleet_ticks(sim, INTERVAL)} ticks in {t_fleet:.3f} s: "
        f"{n_intervals / t_fleet:.3f} intervals/s, "
        f"{t_fleet / n_intervals * 1e3:.2f} ms/interval; "
        f"{decided} decided rows, {changed} θ changes; launches/interval "
        + ", ".join(f"{k}={v / n_intervals:g}" for k, v in counts.items())
        + "; predict_proba over every interface's Θ: "
        + ", ".join(f"{k}={v}" for k, v in proba_counts.items()))
    eager_run = fused["eager"]
    log(f"fused loop, eager: {eager_run['seconds']:.3f} s, "
        f"{eager_run['seconds'] / n_intervals * 1e3:.2f} ms/interval (device "
        f"span {eager_run['run']['device_ms_per_interval']:.2f} ms/interval); "
        f"launches/interval " + ", ".join(
            f"{k}={v / n_intervals:g}" for k, v in
            eager_run["counts"].items()))
    inst = graph_run["instantiate_s"]
    log(f"fused loop, graph: {fused['graph']['seconds']:.3f} s with the "
        f"warm-up interval, capture {graph_run['capture_s']:.3f} s"
        + (f" and instantiate {inst:.3f} s" if inst is not None else
           " (instantiate included: this torch captures and instantiates "
           "in one call)")
        + f"; replays {graph_run['device_ms_per_interval']:.2f} ms/interval "
        f"(device span); launches per replay (captured) "
        + ", ".join(f"{k}={v}" for k, v in
                    graph_run["launches_per_replay"].items())
        + f", x {replays} replays; counted in the run (warm-up + capture) "
        + ", ".join(f"{k}={v}" for k, v in fused["graph"]["counts"].items()))
    fused_summary = dict(
        host_ms_per_interval=t_fleet / n_intervals * 1e3,
        eager_ms_per_interval=eager_run["seconds"] / n_intervals * 1e3,
        eager_device_ms_per_interval=eager_run["run"][
            "device_ms_per_interval"],
        graph_run_s=fused["graph"]["seconds"],
        graph_device_ms_per_interval=graph_run["device_ms_per_interval"],
        capture_s=graph_run["capture_s"], instantiate_s=inst,
        launches_per_replay=graph_run["launches_per_replay"],
        replays=replays)
    fused_summary.update(replayed_run(fused["graph"]["fleet"].loop, dev,
                                      n_intervals))
    next(k for k in kernels
         if k["name"] == "paired_forest_margin")["fused_loop"] = fused_summary

    # segment_sum launches: per tuned interval, and per tick of the
    # engine and of the demand step alone (both pure; results dropped)
    table, wstate = table_from_sim(sim)
    _, _, step_counts = counted(
        lambda: engine_step(sim.params, sim.topo, sim.state))
    _, _, demand_counts = counted(
        lambda: table.demand_step(sim.params, wstate, sim.state))
    log(f"segment_sum launches: {counts['segment_sum'] / n_intervals:g} per "
        f"tuned interval; engine_step {step_counts['segment_sum']} a tick, "
        f"demand_step {demand_counts['segment_sum']} a tick "
        f"({table.n_waves} wave(s))")
    kernels[0]["launches_per_interval"] = counts["segment_sum"] / n_intervals
    kernels[0]["launches_engine_step"] = step_counts["segment_sum"]
    kernels[0]["launches_demand_step"] = demand_counts["segment_sum"]

    # where an interval's time goes (host clock, synchronized)
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

    # 7. the card against the CPU's plain versions, small: the host loop
    # and the fused loop (a CUDA graph on the card)
    model_cpu = model_from_numpy(model_np[READ], model_np[WRITE],
                                 device="cpu")
    for backend in ("torch", "torch-fused"):
        runs = {}
        for key, d, m in (("dev", dev, model), ("cpu", "cpu", model_cpu)):
            small = build_sim(8, 4, d)
            small.set_knobs(torch.arange(small.n_osc), window_pages=64,
                            rpcs_in_flight=2)
            runs[key] = (small, run_fleet(small, m, seconds=3.0,
                                          interval=0.5, device=d,
                                          backend=backend))
        what = f"8x4 fleet ({backend})"
        if trajectory(runs["dev"][1]) != trajectory(runs["cpu"][1]):
            raise AssertionError(f"{what}: θ trajectories differ, card vs "
                                 "CPU")
        for f in dataclasses.fields(runs["cpu"][0].state):
            a = getattr(runs["cpu"][0].state, f.name)
            if isinstance(a, torch.Tensor):
                a = a.double().numpy()
                b = getattr(runs["dev"][0].state,
                            f.name).double().cpu().numpy()
                err = np.max(np.abs(a - b) / np.maximum(np.abs(a), 1.0))
                if not err <= 1e-6:
                    raise AssertionError(f"{what}: {f.name} differs by {err}")
        log(f"reference check: {what} on the card == CPU plain versions "
            f"({sum(len(r) for r in runs['cpu'][1].decisions)} decided rows)")

    return kernels, model


# ---------------------------------------------------------------------- #
# phase 8: LM serving
# ---------------------------------------------------------------------- #
SERVE_ARCHS = ("recurrentgemma-9b", "falcon-mamba-7b", "gemma2-2b")
SERVE = dict(batch=4, prompt_len=3072, gen_tokens=32)
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
# bf16 attention: besides atol 3e-2, each output row's max |kernel - plain|
# within this share of the row's RMS.  Rounding P and the output to bf16
# costs ~1e-2 of it; a key split or tile dropped or added, ~1e-1 and more.
BF16_ROW_REL = 5e-2
# the decode form's row log-sum-exp against the plain version's (float32
# sums of exp of the same bf16 scores, in another order)
LSE_ATOL = 2e-3
# the float32 form's: the same logits to float32 rounding, summed in
# another order (a row's log-sum-exp is ~1-50 here)
F32_LSE_ATOL = 2e-5
# each new kernel: the layer kinds that run it
SERVE_KERNELS = {"flash_attention": {"attn", "attn_local", "moe"},
                 "rglru_scan": {"recurrent"}, "selective_scan": {"mamba"}}


def serving_path(seed: int, dev) -> dict:
    """Full-config ``serve`` of each family, launches counted per run."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve

    runs = {}
    for arch in SERVE_ARCHS:
        cfg = get_config(arch)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        out, secs, counts = counted(lambda: serve(
            arch, smoke=False, seed=seed, device=dev, **SERVE))
        peak = torch.cuda.max_memory_allocated(dev)
        b, n = SERVE["batch"], SERVE["gen_tokens"]
        toks = out["tokens"]
        if toks.shape != (b, n) or toks.min() < 0 \
                or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"serve {arch}: tokens malformed "
                                 f"{toks.shape}")
        for key in ("prefill_logits", "logits"):
            lg = out[key]
            if lg.shape != (b, 1, cfg.vocab_size) \
                    or not bool(torch.isfinite(lg).all()):
                raise AssertionError(f"serve {arch}: {key} not finite or "
                                     f"malformed")
        kinds = set(cfg.layer_types())
        for name, uses in SERVE_KERNELS.items():
            if kinds & uses and counts.get(name, 0) <= 0:
                raise AssertionError(f"serve {arch} never launched {name}")
        SERVED[arch] = dict(tokens=toks,
                            prefill_logits=out["prefill_logits"].cpu())
        runs[arch] = dict(
            params=cfg.param_count(), layers=cfg.n_layers, wall_s=secs,
            prefill_s=out["prefill_s"], decode_s=out["decode_s"],
            tok_per_s=out["tok_per_s"], peak_gib=peak / 2 ** 30,
            launches=counts, first_tokens=toks[0, :8].tolist())
        log(f"serve {arch} (full config: {cfg.n_layers} layers, "
            f"d_model {cfg.d_model}, {cfg.param_count() / 1e9:.2f} B "
            f"params, bf16): {b} x {SERVE['prompt_len']} prompt tokens, "
            f"{n} greedy tokens each; prefill {out['prefill_s']:.3f} s "
            f"({b * SERVE['prompt_len'] / out['prefill_s']:.0f} tok/s), "
            f"decode {out['decode_s']:.3f} s for {n - 1} steps "
            f"({out['tok_per_s']:.1f} tok/s, "
            f"{out['decode_s'] / (n - 1) * 1e3:.2f} ms/step); peak memory "
            f"{peak / 2 ** 30:.2f} GiB; logits finite; launches "
            + ", ".join(f"{k}={v}" for k, v in sorted(counts.items())))
        del out
        gc.collect()
        torch.cuda.empty_cache()
        runs[arch]["breakdown"] = serving_breakdown(arch, seed, dev)
    return runs


def _kernel_class(name: str) -> str:
    for key, cls in (("flash_", "flash_attention"),
                     ("rglru_scan", "rglru_scan"),
                     ("selective_scan", "selective_scan"),
                     ("segment_sum", "segment_sum"), ("forest", "forest"),
                     ("gemm", "matmul"), ("xmma", "matmul"),
                     ("nvjet", "matmul"), ("cutlass", "matmul"),
                     ("reduce", "reduction"), ("softmax", "reduction"),
                     ("index", "indexing"), ("scatter", "indexing"),
                     ("gather", "indexing"), ("elementwise", "elementwise"),
                     ("copy", "copy"), ("cat", "copy")):
        if key in name:
            return cls
    return "other"


def serving_breakdown(arch: str, seed: int, dev) -> dict:
    """Where one prefill and 8 decode steps of ``arch`` (full
    config, fresh weights from the seed) spend the device's time: each
    span once on the host clock (synchronized), once more under
    ``torch.profiler``; device time summed by kernel class."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = get_config(arch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = lm.init_params(cfg, gen, dev)
    b, s = SERVE["batch"], SERVE["prompt_len"]
    prompts = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                            device=dev)
    max_len = s + SERVE["gen_tokens"]
    steps = min(8, SERVE["gen_tokens"] - 1)
    out = {}
    with torch.inference_mode():
        logits, cache = lm.prefill(params, prompts, cfg, max_len)  # warm
        tok = logits.argmax(dim=-1)

        def decode():
            # re-decodes the same positions from the same prefill cache
            c, t = cache, tok
            for i in range(steps):
                lg, c = lm.decode_step(params, t, c, s + i, cfg)
                t = lg.argmax(dim=-1)

        spans = {"prefill": lambda: lm.prefill(params, prompts, cfg, max_len),
                 f"decode x{steps}": decode}
        for name, fn in spans.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            ops = [a for a in prof.key_averages()
                   if a.device_type == DeviceType.CUDA]
            by = {}
            for a in ops:
                cls = _kernel_class(a.key)
                by[cls] = by.get(cls, 0.0) + a.device_time_total / 1e3
            busy = sum(by.values())
            out[name] = dict(wall_ms=wall_ms, device_busy_ms=busy,
                             launches=sum(a.count for a in ops),
                             device_ms_by_class=by)
            log(f"breakdown {arch} {name}: wall {wall_ms:.2f} ms, device "
                + (f"busy {busy:.2f} ms ({busy / wall_ms:.1%} of the "
                   "unprofiled wall time, two runs), "
                   f"{sum(a.count for a in ops)} device operations; "
                   + ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(
                       by.items(), key=lambda kv: -kv[1]))
                   if ops else "not measured (the profiler recorded no "
                   "device activity)"))
    del params, cache
    return out


def _band_pairs(sq: int, skv: int, window) -> int:
    """(query, key) pairs inside the causal (and window) band."""
    q = np.arange(sq) + (skv - sq)
    hi = np.minimum(q + 1, skv)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros_like(q)
    return int(np.maximum(hi - lo, 0).sum())


def _close(got, want, atol: float, rtol: float) -> float:
    """max |got - want|; raises past atol + rtol |want|."""
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if bool(bad.any()):
        raise AssertionError(f"max |diff| {float(err.max())} over "
                             f"atol {atol} + rtol {rtol}")
    return float(err.max())


def _close_rows(got, want, rel: float) -> float:
    """max over (batch, head, query) rows of max |got - want| / RMS(want
    row); raises past ``rel`` (a row whose ``want`` is 0 must be 0)."""
    err = (got.float() - want.float()).abs().amax(-1)
    rms = want.float().square().mean(-1).sqrt()
    if bool((err > rel * rms).any()):
        raise AssertionError(f"a row's max |diff| over {rel} x its RMS: "
                             f"{float((err / rms.clamp_min(1e-30)).max())}")
    return float((err / rms.clamp_min(1e-30)).max())


def check_flash_attention(dev) -> dict:
    """The attention kernel at one layer's prefill shapes of the serve
    runs (recurrentgemma-9b: the headline; gemma2-2b local and global;
    then each head layout phase 13 serves: stablelm-12b at D = 160, the
    MHA of olmoe-1b-7b / qwen2-moe-a2.7b, qwen1.5-32b and musicgen-large
    (D = 64), and the GQA groups of 12 of starcoder2-15b and of 7 of
    llava-next-34b over its image prefix) and at the decode step after
    each (Sq = 1 on a cache view), at the batch phases 8 and 13 serve,
    and at rank 3's first decode step of gemma2-2b's 4 x 1 sequence-sharded
    serve (the four-card check: its 4,096 live keys of a local layer are
    positions 4,065-8,160 of that rank's 8,192-position cache shard), in
    bf16 and float32 (each shape through the form the wrapper picks for
    it), against the plain version, timed beside SDPA where it applies
    (no softcap).  bf16 is held at atol 3e-2 and, so that a dropped or
    doubled key split or tile shows, each row within BF16_ROW_REL of its
    RMS.  The rows' log-sum-exp, which a sequence-sharded decode merges
    by: the float32 form's at every shape, the decode form's at Sq = 1,
    the output bit-equal to the call without it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import \
        attention_form, flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref

    b, s = SERVE["batch"], SERVE["prompt_len"]
    img = 2880           # llava-next-34b's image positions before its text
    # (what, batch, Hq, Hkv, prompt positions, decode, window, softcap, D)
    # a decode step is the last of the serve run's, on a cache of the
    # prompt and the generated tokens; an eleventh field (cache positions,
    # the view's end) places it in a shard
    shapes = [("recurrentgemma-9b prefill", b, 16, 1, s, False, 2048, 0.0,
               256),
              ("gemma2-2b local prefill", b, 8, 4, s, False, 4096, 50.0, 256),
              ("gemma2-2b global prefill", b, 8, 4, s, False, None, 50.0,
               256),
              ("recurrentgemma-9b decode", b, 16, 1, s, True, 2048, 0.0, 256),
              ("gemma2-2b global decode", b, 8, 4, s, True, None, 50.0, 256)]
    for what, bf, hq, hkv, sp, d in (
            ("stablelm-12b", b, 32, 8, s, 160),
            ("olmoe-1b-7b / qwen2-moe-a2.7b", b, 16, 16, s, 128),
            ("qwen1.5-32b", 1, 40, 40, s, 128),
            ("musicgen-large", b, 32, 32, s, 64),
            ("starcoder2-15b", b, 48, 4, s, 128),
            ("llava-next-34b", 1, 56, 8, img + s, 128)):
        shapes += [(f"{what} prefill", bf, hq, hkv, sp, False, None, 0.0, d),
                   (f"{what} decode", bf, hq, hkv, sp, True, None, 0.0, d)]
    shapes.append(("gemma2-2b 4 x 1 decode, rank 3's shard", 1, 8, 4, None,
                   True, 4096, 50.0, 256, (8192, 8161)))
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    cases = []
    for what, b, hq, hkv, sp, decode, window, cap, d, *shard in shapes:
        smax, end = shard[0] if shard else (sp + SERVE["gen_tokens"],) * 2
        cur = end - 1        # the decode step's position in the view
        sq = 1 if decode else sp
        skv = min(cur + 1, window or smax) if decode else sp
        q = torch.randn((b, sq, hq, d), generator=g, device=dev,
                        dtype=torch.bfloat16).transpose(1, 2)
        if sq == 1:       # the live slice of a (B, Hkv, Smax, D) cache
            cache = torch.randn((2, b, hkv, smax, d), generator=g,
                                device=dev, dtype=torch.bfloat16)
            k = cache[0, :, :, cur + 1 - skv:cur + 1]
            v = cache[1, :, :, cur + 1 - skv:cur + 1]
        else:
            kv = torch.randn((2, b, skv, hkv, d), generator=g, device=dev,
                             dtype=torch.bfloat16)
            k, v = kv[0].transpose(1, 2), kv[1].transpose(1, 2)
        opts = dict(causal=True, window=window, softcap=cap)
        run = lambda: flash_attention_cuda(q, k, v, **opts)  # noqa: E731
        got = run()
        if not torch.equal(got, run()):
            raise AssertionError(f"flash_attention {what}: two launches "
                                 "differ")
        plain = lambda: attention_ref(q, k, v, **opts)  # noqa: E731
        want = plain()
        err = _close(got, want, 3e-2, 0.0)
        rel = _close_rows(got, want, BF16_ROW_REL)
        del want
        qf, kf, vf = (t.float() for t in (q, k, v))
        run32 = lambda: flash_attention_cuda(qf, kf, vf, **opts)  # noqa: E731
        got32 = run32()
        if not torch.equal(got32, run32()):
            raise AssertionError(f"flash_attention {what} float32: two "
                                 "launches differ")
        want32, want_lse32 = attention_ref(qf, kf, vf, return_lse=True,
                                           **opts)
        err32 = _close(got32, want32, 2e-5, 0.0)
        del want32
        run32_lse = lambda: flash_attention_cuda(  # noqa: E731
            qf, kf, vf, return_lse=True, **opts)
        o_l32, lse32 = run32_lse()
        if not torch.equal(o_l32, got32):
            raise AssertionError(f"flash_attention {what} float32: the "
                                 "output with the log-sum-exp differs")
        lse_err32 = _close(lse32, want_lse32, F32_LSE_ATOL, 0.0)
        del o_l32, lse32, want_lse32
        lse_err = None
        if sq == 1:    # the decode form's optional row log-sum-exp
            o_l, lse = flash_attention_cuda(q, k, v, return_lse=True, **opts)
            if not torch.equal(o_l, got):
                raise AssertionError(f"flash_attention {what}: the output "
                                     "with the log-sum-exp differs")
            lse_err = _close(lse, attention_ref(q, k, v, return_lse=True,
                                                **opts)[1], LSE_ATOL, 0.0)
        # decode calls are shorter than their launch cost: their device
        # time comes from a CUDA graph, the eager loop's beside it
        timed = time_ms_graph if sq == 1 else lambda fn: time_ms(fn, 3)
        ms32 = timed(run32)
        ms32_lse = time_ms_graph(run32_lse) if sq == 1 else None
        del qf, kf, vf, got32
        pairs = _band_pairs(sq, skv, window)
        n_ops = 4 * d * pairs * b * hq
        nbytes = 2 * (2 * b * hq * sq * d + 2 * b * hkv * skv * d)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, n_ops / BF16_OPS_PER_S
        # float32 with the log-sum-exp: twice the bytes and one float per
        # row, the same operations at the float32 rate
        t32_bytes = (2 * nbytes + 4 * b * hq * sq) / HBM_BYTES_PER_S
        t32_ops = n_ops / F32_OPS_PER_S
        library_ms = None
        if cap == 0.0:
            qi = torch.arange(sq, device=dev)[:, None] + (skv - sq)
            kj = torch.arange(skv, device=dev)[None, :]
            mask = (kj <= qi) & ((kj > qi - window) if window else True)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=mask, enable_gqa=True)
            lib_err = _close(lib(), plain(), 3e-2, 0.0)
            library_ms = time_ms_graph(lib) if sq == 1 else time_ms(lib, 5)
        case = dict(shape=what, b=b, hq=hq, hkv=hkv, sq=sq, skv=skv, d=d,
                    window=window, softcap=cap, pairs=pairs,
                    form=attention_form(sq, q.dtype),
                    form_f32=attention_form(sq, torch.float32), ms_f32=ms32,
                    ms=time_ms_graph(run) if sq == 1 else time_ms(run, 5),
                    eager_ms=time_ms(run, 50) if sq == 1 else None,
                    plain_ms=time_ms(plain, 2 if sq > 1 else 20),
                    library_ms=library_ms,
                    bound_ms=max(t_bytes, t_ops) * 1e3,
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    ms_f32_lse=ms32_lse,
                    bound_ms_f32_lse=max(t32_bytes, t32_ops) * 1e3,
                    bound_by_f32_lse="bytes" if t32_bytes >= t32_ops
                    else "operations",
                    max_abs_err=err, max_row_rel_err=rel,
                    max_abs_err_f32=err32, lse_max_abs_err=lse_err,
                    lse_max_abs_err_f32=lse_err32)
        cases.append(case)
        log(f"flash_attention[{what}] B={b} Hq={hq} Hkv={hkv} Sq={sq} "
            f"Skv={skv} D={d} window={window} softcap={cap}: bf16 "
            f"|kernel - plain| {err:.3e} (a row's max over its RMS "
            f"{rel:.3e}), float32 {err32:.3e}; kernel "
            f"bf16 ({case['form']}) {case['ms']:.4f} ms, float32 "
            f"({case['form_f32']}) {ms32:.4f} ms"
            + (f" ({ms32_lse:.4f} ms with the log-sum-exp, bound "
               f"{case['bound_ms_f32_lse']:.4f} ms "
               f"({case['bound_by_f32_lse']}))" if ms32_lse is not None
               else "")
            + f", float32 log-sum-exp |kernel - plain| {lse_err32:.3e}"
            + (f", bf16 log-sum-exp |kernel - plain| {lse_err:.3e}"
               if lse_err is not None else "")
            + (f" (CUDA graph; eager bf16 {case['eager_ms']:.4f} ms a call)"
               if sq == 1 else "") + f", plain bf16 "
            f"{case['plain_ms']:.4f} ms, SDPA "
            + (f"{library_ms:.4f} ms (|SDPA - plain| {lib_err:.3e})"
               if library_ms is not None else "n/a (softcap)")
            + f", bound {case['bound_ms']:.4f} ms ({case['bound_by']})")
        del q, k, v, got
        torch.cuda.empty_cache()
    head = cases[0]
    lse_f32 = max(c["lse_max_abs_err_f32"] for c in cases)
    lse_bf16 = max(c["lse_max_abs_err"] for c in cases
                   if c["lse_max_abs_err"] is not None)
    log(f"flash_attention: the rows' log-sum-exp, worst |kernel - plain| "
        f"float32 {lse_f32:.3e} (atol {F32_LSE_ATOL}, {len(cases)} shapes), "
        f"bf16 decode {lse_bf16:.3e} (atol {LSE_ATOL})")
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:31",
                max_abs_err=head["max_abs_err"],
                lse_max_abs_err_f32=lse_f32, lse_max_abs_err=lse_bf16,
                tolerance="bf16 atol 3e-2 and each row within "
                f"{BF16_ROW_REL} of its RMS, float32 atol 2e-5, the rows' "
                f"log-sum-exp atol {F32_LSE_ATOL} (float32 form) and "
                f"{LSE_ATOL} (bf16 decode form), vs the plain version on "
                "the same inputs; two launches bit-equal",
                ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=head["library_ms"], shape=head["shape"],
                cases=cases)


def check_rglru(dev) -> dict:
    """The RG-LRU kernel at one recurrentgemma-9b layer's prefill shape."""
    import torch
    from repro_torch.kernels.rglru_scan.kernel import rglru_cuda
    from repro_torch.kernels.rglru_scan.ref import rglru_ref

    b, s, w = SERVE["batch"], SERVE["prompt_len"], 4096
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    x = torch.randn((b, s, w), generator=g, device=dev)
    # gates as the layer makes them: a = exp(-8 softplus(lam) r)
    lam = torch.log(torch.expm1(torch.linspace(0.35, 0.9, w, device=dev)))
    r = torch.rand((b, s, w), generator=g, device=dev)
    a = torch.exp(-8.0 * torch.nn.functional.softplus(lam) * r)
    run = lambda: rglru_cuda(x, a)  # noqa: E731
    got = run()
    if not torch.equal(got, run()):
        raise AssertionError("rglru_scan: two launches differ")
    plain = lambda: rglru_ref(x, a)  # noqa: E731
    err = _close(got, plain(), 1e-4, 1e-4)
    nbytes = 3 * b * s * w * 4
    n_ops = 6 * b * s * w
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    entry = dict(name="rglru_scan", route="cuda",
                 source="src/repro_torch/csrc/rglru_scan.cu",
                 replaces="src/repro/kernels/rglru_scan/kernel.py:20",
                 max_abs_err=err, tolerance="atol 1e-4 + rtol 1e-4 vs the "
                 "plain version; two launches bit-equal",
                 ms=time_ms(run, 20), plain_ms=time_ms(plain, 1),
                 bound_ms=max(t_bytes, t_ops) * 1e3,
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 library_ms=None, shape=[b, s, w])
    log(f"rglru_scan B={b} S={s} W={w}: |kernel - plain| {err:.3e}; kernel "
        f"{entry['ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms, bound "
        f"{entry['bound_ms']:.4f} ms ({entry['bound_by']})")
    return entry


def check_selective_scan(dev) -> dict:
    """The selective-scan kernel at one falcon-mamba-7b layer's prefill
    shape, bf16 inputs as the layer passes them."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.mamba_scan.kernel import selective_scan_cuda
    from repro_torch.kernels.mamba_scan.ref import selective_scan_ref

    b, s, dm, n = SERVE["batch"], SERVE["prompt_len"], 8192, 16
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
    run = lambda: selective_scan_cuda(u, delta, A, B, C, D)  # noqa: E731
    y, h = run()
    y2, h2 = run()
    if not (torch.equal(y, y2) and torch.equal(h, h2)):
        raise AssertionError("selective_scan: two launches differ")
    plain = lambda: selective_scan_ref(u, delta, A, B, C, D)  # noqa: E731
    py, ph = plain()
    err = max(_close(y, py, 1e-4, 1e-4), _close(h, ph, 1e-4, 1e-4))
    nbytes = (2 * b * s * dm * 2 + 2 * b * s * n * 2 + dm * n * 4 + dm * 4
              + b * s * dm * 4 + b * dm * n * 4)
    n_ops = b * s * dm * (7 * n + 3)
    # one exponential a (batch, step, channel, state) on the SFU, 16 a
    # clock an SM, at the card's highest SM clock
    n_exp = b * s * dm * n
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_mhz = max_sm_clock_mhz()
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    t_sfu = n_exp / (SFU_PER_CLOCK_PER_SM * sms * clock_mhz * 1e6)
    entry = dict(name="selective_scan", route="cuda",
                 source="src/repro_torch/csrc/mamba_scan.cu",
                 replaces="src/repro/kernels/mamba_scan/kernel.py:29",
                 max_abs_err=err, tolerance="atol 1e-4 + rtol 1e-4 on y and "
                 "the final state vs the plain version; two launches "
                 "bit-equal",
                 ms=time_ms(run, 20), plain_ms=time_ms(plain, 1),
                 bound_ms=max(t_bytes, t_ops, t_sfu) * 1e3,
                 bound_by="bytes" if t_bytes >= max(t_ops, t_sfu)
                 else "operations",
                 bytes_bound_ms=t_bytes * 1e3, flops_bound_ms=t_ops * 1e3,
                 sfu_bound_ms=t_sfu * 1e3, sfu_clock_mhz=clock_mhz, sms=sms,
                 library_ms=None, shape=[b, s, dm, n])
    log(f"selective_scan B={b} S={s} Di={dm} N={n} (bf16 in): |kernel - "
        f"plain| {err:.3e}; kernel {entry['ms']:.4f} ms, plain "
        f"{entry['plain_ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms "
        f"({entry['bound_by']}: bytes {t_bytes * 1e3:.4f}, float32 flops "
        f"{t_ops * 1e3:.4f}, {n_exp:.3e} exponentials at "
        f"{SFU_PER_CLOCK_PER_SM} a clock on {sms} SMs at {clock_mhz:g} MHz "
        f"{t_sfu * 1e3:.4f} ms)")
    return entry


def smoke_card_vs_cpu(dev) -> None:
    """The smoke configs in float32, the same weights and prompts on the
    card and on the CPU: identical greedy tokens, logits within 1e-4."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm

    for arch in SERVE_ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  param_dtype="float32")
        gen = torch.Generator().manual_seed(0)
        params = lm.init_params(cfg, gen, "cpu")
        prompts = torch.randint(0, cfg.vocab_size, (4, 48), generator=gen)
        cpu = generate(params, prompts, cfg, 16, 64)
        card = generate(lm.to_device(params, dev), prompts.to(dev), cfg, 16,
                        64)
        if not np.array_equal(card["tokens"], cpu["tokens"]):
            raise AssertionError(f"smoke {arch}: greedy tokens differ, card "
                                 "vs CPU")
        err = max(float((card[k].cpu() - cpu[k]).abs().max())
                  for k in ("prefill_logits", "logits"))
        if not err <= 1e-4:
            raise AssertionError(f"smoke {arch}: logits differ by {err}")
        log(f"reference check: {arch} smoke (float32) on the card == CPU "
            f"plain versions: 4 x 16 greedy tokens identical, logits within "
            f"{err:.3e}")


def serving_phase(seed: int, dev) -> list:
    """Phase 8; returns the new kernels' result dicts."""
    import torch

    runs = serving_path(seed, dev)
    torch.cuda.empty_cache()
    kernels = [check_flash_attention(dev), check_rglru(dev),
               check_selective_scan(dev)]
    for k in kernels:
        uses = SERVE_KERNELS[k["name"]]
        per_arch = {a: r["launches"].get(k["name"], 0)
                    for a, r in runs.items()}
        k["path"] = "serve (" + ", ".join(
            a for a, c in per_arch.items() if c) + ")"
        k["launches"] = sum(per_arch.values())
        k["launches_by_arch"] = per_arch
        if k["launches"] <= 0:
            raise AssertionError(f"serve never launched {k['name']} "
                                 f"(layers {sorted(uses)})")
    kernels[0]["serve"] = runs
    kernels[0]["launches_combine"] = sum(
        r["launches"].get("flash_attention_combine", 0) for r in runs.values())
    torch.cuda.empty_cache()
    smoke_card_vs_cpu(dev)
    return kernels


# ---------------------------------------------------------------------- #
# phase 9: the Scenario Lab
# ---------------------------------------------------------------------- #
# the catalog's seconds cut from the CLI's 10 s to 5 s to keep the smoke
# inside its limit beside phase 15, then to 2.5 s (5 intervals, 2 of them
# deciding) beside phase 16
LAB_SECONDS, LAB_INTERVAL = 2.5, 0.5
WIDE_VARIANTS = 1024                      # x 8 interfaces = 8,192
WIDE_SECONDS = 5.0                        # 10 tuned intervals (cut from 20)
CAMPAIGN_SECONDS = 7.5                    # the smoke campaign's 15 s, cut
LAB_ROOT = os.path.join(ROOT, "build", "lab_campaign")


def add_path(kernel: dict, path: str, count: int) -> None:
    """Count a lab path's launches into a kernel's row; a path that ran
    the kernel no time fails the phase."""
    if count <= 0:
        raise AssertionError(f"{path} never launched {kernel['name']}")
    by = kernel.setdefault("launches_by_path",
                           {kernel["path"]: kernel["launches"]})
    by[path] = count
    kernel["launches"] += count
    kernel["path"] += ", " + path


def _first_row_diff(a: list, b: list) -> str:
    for ra, rb in zip(a, b):
        for key in ra:
            if ra[key] != rb.get(key):
                return (f"{ra['scenario']}.{key}: {ra[key]!r} vs "
                        f"{rb.get(key)!r}")
    return f"{len(a)} vs {len(b)} rows"


def lab_catalog(model, dev, card: str) -> dict:
    """The catalog evaluate (12 scenarios x 25 arms, 4 padded buckets) on
    the host path, the fused loop eager and on CUDA graphs, then on
    graphs once more: rows identical, launches counted per run."""
    from repro_torch.lab import batch as LB
    from repro_torch.lab.evaluate import evaluate

    ways = (("host", False, None), ("fused eager", True, False),
            ("fused graph", True, None), ("fused graph again", True, None))
    runs = {}
    for name, fused, graph in ways:
        LB.reset_loop_cache_stats()
        report, secs, counts = counted(lambda: evaluate(
            model=model, seconds=LAB_SECONDS, interval=LAB_INTERVAL,
            fused=fused, graph=graph, device=dev))
        stats = LB.loop_cache_stats()
        s = report["summary"]
        if (s["n_scenarios"], s["n_buckets"], s["n_dispatches"]) != (12, 4, 4):
            raise AssertionError(f"evaluate ({name}): {s['n_scenarios']} "
                                 f"scenarios, {s['n_buckets']} buckets, "
                                 f"{s['n_dispatches']} dispatches")
        for r in report["scenarios"]:
            if not all(np.isfinite(r[k]) and r[k] > 0 for k in r
                       if k.endswith("_mbs")):
                raise AssertionError(f"evaluate ({name}): {r['scenario']} "
                                     "MB/s not finite and positive")
        runs[name] = dict(report=report, seconds=secs, counts=counts,
                          stats=stats)
        log(f"{card} | lab evaluate ({name}): 12 scenarios x 25 arms, "
            f"{LAB_SECONDS:g} s at {LAB_INTERVAL} s intervals, 4 buckets, 4 "
            f"dispatches, in {secs:.3f} s; loop cache hits "
            f"{stats['hits']}, misses {stats['misses']}; captures "
            f"{stats['captures']} in {stats['capture_s']:.3f} s; replays "
            f"{stats['replays']} (device span {stats['replay_device_ms']:.2f} "
            f"ms); launches counted " + ", ".join(
                f"{k}={v}" for k, v in counts.items())
            + ("; replayed " + ", ".join(
                f"{k}={v}" for k, v in stats["replayed_launches"].items())
               if stats["replays"] else ""))
    rows = runs["host"]["report"]["scenarios"]
    for name in ("fused eager", "fused graph", "fused graph again"):
        other = runs[name]["report"]["scenarios"]
        if other != rows:
            raise AssertionError(
                f"evaluate ({name}) rows differ from the host path's: "
                f"{_first_row_diff(rows, other)}")
    again = runs["fused graph again"]["stats"]
    if again["captures"] or again["misses"]:
        raise AssertionError(f"second graphed evaluate: {again['captures']} "
                             f"captures, {again['misses']} cache misses")
    s = runs["host"]["report"]["summary"]
    log(f"{card} | lab evaluate: rows identical across the host path, the "
        f"fused loop eager and replayed, and a second replayed run (θ, "
        f"changes, best static θ, MB/s bit for bit); mean DIAL vs default "
        f"{s['mean_dial_vs_default']:.4f}x, mean fraction of best static "
        f"{s['mean_dial_frac_of_best_static']:.4f}; changes "
        + ", ".join(f"{r['scenario']}={r['changes']}" for r in rows))
    return runs


def lab_wide_batch(model, seed: int, dev, card: str) -> tuple:
    """1,024 variants of noisy_neighbor (8,192 interfaces) through
    ``run_batch(fused=True)`` for 10 intervals, every element tuned:
    eager, on graphs (capture), and on graphs again (replays only);
    graph bit-equal to eager; one replayed interval profiled."""
    import torch

    from repro_torch.lab import batch as LB
    from repro_torch.lab.scenarios import build, get_scenario, variants

    built = [build(s) for s in variants(get_scenario("noisy_neighbor"),
                                        WIDE_VARIANTS, seed=seed)]
    runs = {}
    for name, graph in (("eager", False), ("graph", None),
                        ("graph again", None)):
        batch = LB.stack_scenarios(built, device=dev)
        LB.reset_loop_cache_stats()
        res, secs, counts = counted(lambda: LB.run_batch(
            batch, model, seconds=WIDE_SECONDS, interval=LAB_INTERVAL,
            fused=True, graph=graph))
        check_state(batch.state, f"wide batch ({name})")
        runs[name] = dict(batch=batch, result=res, seconds=secs,
                          counts=counts, stats=LB.loop_cache_stats())
    n_int = int(round(WIDE_SECONDS / LAB_INTERVAL))
    eager = runs["eager"]
    for name in ("graph", "graph again"):
        got = runs[name]
        for key, v in eager["result"].trace.items():
            if not torch.equal(v, got["result"].trace[key]):
                raise AssertionError(f"wide batch ({name}): record {key} "
                                     "differs from the eager run's")
        for f in dataclasses.fields(eager["batch"].state):
            a = getattr(eager["batch"].state, f.name)
            b = getattr(got["batch"].state, f.name)
            if not (torch.equal(a, b) if torch.is_tensor(a) else a == b):
                raise AssertionError(f"wide batch ({name}): {f.name} "
                                     "differs from the eager run's")
    decided = int(eager["result"].trace["decided"].sum())
    changed = int((eager["result"].trace["changed"]
                   & eager["result"].trace["decided"]).sum())
    if not changed:
        raise AssertionError("wide batch: no θ changed")
    again = runs["graph again"]["stats"]
    if again["captures"]:
        raise AssertionError("wide batch: the second graphed run captured")
    per_replay = {k: v // again["replays"]
                  for k, v in again["replayed_launches"].items()}
    ms_replay = again["replay_device_ms"] / again["replays"]
    batch = runs["graph again"]["batch"]
    steps = max(int(round(LAB_INTERVAL / batch.params.tick)), 1)
    loop = LB._cached_loop(batch.params, batch.fleet, steps, model, None)
    t_one, ops = profile_replay(loop, batch.table, lambda: loop.prepare(
        batch.state, batch.wstate, 1, schedule=batch.schedule(0, steps)))
    busy = sum(a.device_time_total for a in ops) / 1e3 if ops else None
    out = dict(elements=len(batch), interfaces=batch.fleet.n_osc,
               intervals=n_int, eager_s=eager["seconds"],
               eager_ms_per_interval=eager["seconds"] / n_int * 1e3,
               graph_run_s=runs["graph"]["seconds"],
               capture_s=runs["graph"]["stats"]["capture_s"],
               replayed_run_s=runs["graph again"]["seconds"],
               replayed_run_ms_per_interval=(
                   runs["graph again"]["seconds"] / n_int * 1e3),
               ms_per_replayed_interval=ms_replay,
               launches_per_replay=per_replay,
               one_replay_wall_ms=t_one * 1e3, busy_ms=busy,
               busy_share=None if busy is None else busy / (t_one * 1e3),
               decided_rows=decided, changes=changed,
               eager_counts=eager["counts"],
               graph_replayed_launches=runs["graph"]["stats"][
                   "replayed_launches"])
    log(f"{card} | lab wide batch: {len(batch)} variants of noisy_neighbor "
        f"= {batch.fleet.n_osc} interfaces, {n_int} tuned intervals; eager "
        f"{eager['seconds']:.3f} s ({out['eager_ms_per_interval']:.2f} "
        f"ms/interval); graphed {runs['graph']['seconds']:.3f} s with the "
        f"warm-up and capture ({out['capture_s']:.3f} s); replayed run "
        f"{out['replayed_run_s']:.3f} s "
        f"({out['replayed_run_ms_per_interval']:.2f} ms/interval, wall, "
        f"copy-in and records included), {ms_replay:.2f} ms per replayed "
        f"interval (CUDA events); launches per replayed interval "
        + ", ".join(f"{k}={v}" for k, v in per_replay.items())
        + f"; one replayed interval {t_one * 1e3:.2f} ms wall, device busy "
        + ("not measured (no device rows)" if busy is None else
           f"{busy:.2f} ms ({busy / (t_one * 1e3):.1%}) in "
           f"{sum(a.count for a in ops)} device operations")
        + f"; graph bit-equal to eager ({decided} decided rows, {changed} "
        "θ changes)")
    return out, batch


def lab_campaign(dev, card: str) -> dict:
    """``smoke_campaign()`` at :data:`CAMPAIGN_SECONDS` through
    ``run_campaign`` on the card and on
    the CPU: the collected rows and labels identical (the datasets'
    fingerprints: row counts and a hash of X and y), the forests equal."""
    import shutil

    from repro_torch.lab.campaign import (load_versioned, run_campaign,
                                          smoke_campaign)
    from repro_torch.pfs.state import READ, WRITE

    cfg, gbdt = smoke_campaign()
    cfg = dataclasses.replace(cfg, seconds=CAMPAIGN_SECONDS)
    shutil.rmtree(LAB_ROOT, ignore_errors=True)
    (d, model, info), secs, counts = counted(lambda: run_campaign(
        cfg, out_root=os.path.join(LAB_ROOT, "card"), gbdt_params=gbdt,
        smoke=True, device=dev))
    t0 = time.perf_counter()
    _, model_cpu, info_cpu = run_campaign(
        cfg, out_root=os.path.join(LAB_ROOT, "cpu"), gbdt_params=gbdt,
        smoke=True, device="cpu")
    t_cpu = time.perf_counter() - t0
    fp, fp_cpu = (i["train_meta"]["dataset"] for i in (info, info_cpu))
    if fp != fp_cpu or info["positive_rate"] != info_cpu["positive_rate"]:
        raise AssertionError(f"campaign: the card's collected rows differ "
                             f"from the CPU's ({fp} vs {fp_cpu})")
    loaded = load_versioned(os.path.join(LAB_ROOT, "card"), device=dev)
    for op, name in ((READ, "read"), (WRITE, "write")):
        assert_forests_match(model.forest(op), model_cpu.forest(op),
                             f"campaign {name} forest, card vs CPU")
        assert_forests_match(loaded.forest(op), model.forest(op),
                             f"campaign {name} forest, saved vs trained")
    g = cfg.grid
    cells = 2 * len(g.req_sizes) * len(g.patterns) * len(g.threads)
    log(f"{card} | lab campaign (smoke grid, {cfg.seconds:g} s, {cells} "
        f"cells): card {secs:.3f} s, CPU {t_cpu:.3f} s; {info['samples']} "
        f"samples, rows and labels identical on the card and the CPU "
        f"(dataset {fp['sha256']}), forests equal, the saved artifact "
        f"{os.path.relpath(d, ROOT)} loads back; launches "
        + ", ".join(f"{k}={v}" for k, v in counts.items()))
    return dict(card_s=secs, cpu_s=t_cpu, samples=info["samples"],
                dataset=fp, counts=counts)


def lab_kernels(model, batch, rng) -> tuple:
    """``segment_sum`` on the four maps of the wide batch and of each
    catalog bucket's fleet (one column and the engine's and demand
    step's batched forms), and the paired forest on each one's rows
    (every interface x Θ under its own op), against their plain
    versions, timed as phase 4 times them."""
    import torch

    from repro_torch.kernels.gbdt_forest.ops import pair_forests
    from repro_torch.lab.batch import bucket_scenarios
    from repro_torch.lab.evaluate import catalog_arms
    from repro_torch.lab.scenarios import SCENARIOS, get_scenario

    dev = batch.device
    fleets = [("wide", batch)] + [
        (f"bucket {len(idxs)}x{b.n_osc}", b) for idxs, b in bucket_scenarios(
            catalog_arms([get_scenario(n) for n in SCENARIOS])[0],
            device=dev)]
    maps = {}
    for tag, b in fleets:
        maps.update({f"{tag} osc_ost": (b.fleet.ost_map, 1),
                     f"{tag} osc_ost x2": (b.fleet.ost_map, 2),
                     f"{tag} osc_client": (b.fleet.client_map, 1),
                     f"{tag} entry_row": (b.table.row_map, 1),
                     f"{tag} entry_osc x8": (b.table.osc_map, 8)})
    seg = check_segment_sum(maps, rng)
    feature, threshold, leaf, base, _, n_features = pair_forests(
        model.read_forest, model.write_forest)
    to = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    forests = []
    for tag, b in fleets:
        n_osc = b.fleet.n_osc
        x = to((rng.standard_normal((n_osc * 24, n_features)) * 10.0
                ** rng.uniform(-1, 3, n_features)).astype(np.float32))
        op = to(np.repeat(rng.integers(0, 2, n_osc), 24).astype(np.int32))
        forests.append(dict(fleet=tag, **check_forest(
            "paired_forest_margin",
            "src/repro/kernels/gbdt_forest/kernel.py:96", x, op,
            *map(to, (feature, threshold, leaf, base)),
            label=f" (lab {tag} rows)")))
    return seg, forests


def lab_phase(model, seed: int, dev, kernels: list, card: str) -> None:
    """Phase 9, the Scenario Lab, on the model phase 3 trained: the
    catalog evaluate, the wide batch, the smoke campaign, and the two
    kernels at the wide batch's and every catalog bucket's shapes;
    launches go into the kernels' rows by path."""
    import torch

    rng = np.random.default_rng(seed + 9)
    by_name = {k["name"]: k for k in kernels}
    catalog = lab_catalog(model, dev, card)
    torch.cuda.empty_cache()
    wide, batch = lab_wide_batch(model, seed, dev, card)
    seg, forests = lab_kernels(model, batch, rng)
    del batch
    torch.cuda.empty_cache()
    campaign = lab_campaign(dev, card)
    by_name["segment_sum"]["lab_shapes"] = seg["cases"]
    by_name["paired_forest_margin"]["lab_shapes"] = [
        {k: f[k] for k in ("fleet", "ms", "eager_ms", "plain_ms", "bound_ms",
                           "bound_by", "max_abs_err", "shape")}
        for f in forests]

    for name in ("host", "fused eager"):
        for kname in ("segment_sum", "paired_forest_margin"):
            add_path(by_name[kname], f"lab evaluate {name}",
                     catalog[name]["counts"].get(kname, 0))
    graphed = catalog["fused graph"]["stats"]["replayed_launches"]
    for kname in ("segment_sum", "paired_forest_margin"):
        add_path(by_name[kname], "lab evaluate graph (captured x replays)",
                 graphed.get(kname, 0))
        add_path(by_name[kname], "lab wide batch eager",
                 wide["eager_counts"].get(kname, 0))
        add_path(by_name[kname], "lab wide batch graph (captured x replays)",
                 wide["graph_replayed_launches"].get(kname, 0))
    add_path(by_name["segment_sum"], "lab campaign",
             campaign["counts"].get("segment_sum", 0))
    add_path(by_name["tree_histogram"], "lab campaign",
             campaign["counts"].get("tree_histogram", 0))
    by_name["paired_forest_margin"]["lab"] = dict(
        catalog={name: dict(seconds=r["seconds"], **{
            k: r["stats"][k] for k in ("hits", "misses", "captures",
                                       "capture_s", "replays",
                                       "replay_device_ms")})
            for name, r in catalog.items()},
        wide_batch={k: v for k, v in wide.items()
                    if k not in ("eager_counts", "graph_replayed_launches")},
        campaign=campaign)


# ---------------------------------------------------------------------- #
# phase 10: observability and the loss-finding pipeline
# ---------------------------------------------------------------------- #
TRACE_STRIDE = 20
AB_ORDER = ("untraced", "traced", "traced", "untraced", "untraced",
            "traced")                     # replayed runs, alternated
FUZZ_SCENARIOS = 8                        # FuzzConfig's 512, cut (was 32)
CUT_SCENARIOS = 4                         # SMOKE's 64, cut: card vs CPU (was 16)
EAGER_AB_INTERVALS = 3                    # the eager A/B's runs (cut from 10)
OBS_ROOT = os.path.join(ROOT, "build", "obs")


def _records_equal(a: dict, b: dict, keys) -> str | None:
    """The first record of ``keys`` (``timeline.<f>`` for the timeline's)
    that differs between two fused traces, or ``None``."""
    import torch

    for k in keys:
        x = a["timeline"][k[9:]] if k.startswith("timeline.") else a[k]
        y = b["timeline"][k[9:]] if k.startswith("timeline.") else b[k]
        if not torch.equal(x, y):
            return k
    return None


def obs_traced_fleet(model, dev, card: str) -> dict:
    """The 8,192-interface fleet of phase 6 through a traced fused loop
    (stride 20): eager, on a graph, and an untraced graph beside it; the
    replayed θ and state equal to the untraced run's, the replayed
    records (provenance and timeline) equal to the eager run's, all bit
    for bit; then replayed runs of both loops alternated in this process
    for the traced-vs-untraced span, and eager runs alternated for the
    host-bound eager interval's wall time."""
    import torch

    from repro_torch.obs.schema import TraceConfig
    from repro_torch.pfs.loop_torch import FusedLoop
    from repro_torch.pfs.workloads import table_from_sim

    sim = build_sim(CLIENTS, OSTS, dev)
    table, wstate = table_from_sim(sim)
    n = int(round(SECONDS / INTERVAL))
    steps = fleet_ticks(sim, INTERVAL)
    cfg = TraceConfig(stride=TRACE_STRIDE)
    loops = {"traced": FusedLoop(sim.params, sim.topo, steps, model,
                                 trace=cfg),
             "untraced": FusedLoop(sim.params, sim.topo, steps, model)}
    runs = {}
    for name, which, graph in (("traced eager", "traced", False),
                               ("traced graph", "traced", None),
                               ("untraced graph", "untraced", None)):
        loop = loops[which]
        res, secs, counts = counted(lambda: loop.run(
            table, sim.state, wstate, n, graph=graph))
        check_state(res.state, f"traced fleet ({name})")
        runs[name] = dict(result=res, seconds=secs, counts=counts,
                          run=dict(loop.last_run))
    eager, graph, plain = (runs[k]["result"] for k in (
        "traced eager", "traced graph", "untraced graph"))
    keys = list(eager.trace.keys() - {"timeline"}) + [
        "timeline." + k for k in eager.trace["timeline"]]
    bad = _records_equal(eager.trace, graph.trace, keys)
    if bad:
        raise AssertionError(f"traced fleet: replayed record {bad} differs "
                             "from the eager run's")
    bad = _records_equal(plain.trace, graph.trace, plain.trace.keys())
    if bad:
        raise AssertionError(f"traced fleet: decision record {bad} differs "
                             "from the untraced run's")
    for f in dataclasses.fields(plain.state):
        a, b = getattr(plain.state, f.name), getattr(graph.state, f.name)
        if not (torch.equal(a, b) if torch.is_tensor(a) else a == b):
            raise AssertionError(f"traced fleet: state {f.name} differs "
                                 "from the untraced run's")
    trace = loops["traced"].run_trace(graph)
    trace.validate()
    spans = {"traced": [], "untraced": []}
    for which in AB_ORDER:
        loop = loops[which]
        _, secs, _ = counted(lambda: loop.run(table, sim.state, wstate, n))
        if loop.last_run["captured_now"]:
            raise AssertionError("traced fleet: a replayed run captured")
        spans[which].append((loop.last_run["device_ms_per_interval"],
                             secs / n * 1e3))
    med = {k: float(np.median([s[0] for s in v])) for k, v in spans.items()}
    # the eager interval, host-bound: wall ms per interval, alternated
    eager_ms = {"traced": [], "untraced": []}
    for which in AB_ORDER[:4]:
        loop = loops[which]
        _, secs, _ = counted(lambda: loop.run(
            table, sim.state, wstate, EAGER_AB_INTERVALS, graph=False))
        eager_ms[which].append(secs / EAGER_AB_INTERVALS * 1e3)
    g = runs["traced graph"]["run"]
    out = dict(
        interfaces=sim.n_osc, intervals=n, stride=TRACE_STRIDE,
        samples=int(trace.timeline["t"].shape[0]),
        decided_rows=int(trace.decisions["decided"].sum()),
        changes=int(trace.decisions["changed"].sum()),
        eager_s=runs["traced eager"]["seconds"],
        eager_device_ms_per_interval=runs["traced eager"]["run"][
            "device_ms_per_interval"],
        graph_run_s=runs["traced graph"]["seconds"],
        capture_s=g["capture_s"], instantiate_s=g["instantiate_s"],
        setup_s=g["setup_s"],
        launches_per_replay=g["launches_per_replay"],
        untraced_launches_per_replay=runs["untraced graph"]["run"][
            "launches_per_replay"],
        spans_ms={k: [s[0] for s in v] for k, v in spans.items()},
        run_ms_per_interval={k: [s[1] for s in v] for k, v in spans.items()},
        traced_ms=med["traced"], untraced_ms=med["untraced"],
        overhead=med["traced"] / med["untraced"] - 1.0,
        eager_ms=eager_ms,
        eager_counts=runs["traced eager"]["counts"],
        graph_replayed={k: v * g["replays"]
                        for k, v in g["launches_per_replay"].items()})
    log(f"{card} | traced fleet: {sim.n_osc} interfaces, {n} intervals, "
        f"stride {TRACE_STRIDE} ({out['samples']} timeline samples of "
        f"{sim.n_osts} OSTs, {out['decided_rows']} decided rows, "
        f"{out['changes']} θ changes): replayed records bit-equal to the "
        f"eager run's, θ, decisions and state bit-equal to the untraced "
        f"replay's; eager {out['eager_s']:.3f} s, graphed "
        f"{out['graph_run_s']:.3f} s (capture {g['capture_s']:.3f} s"
        + (f" + instantiate {g['instantiate_s']:.3f} s"
           if g["instantiate_s"] is not None else "")
        + f"); launches per replay traced " + ", ".join(
            f"{k}={v}" for k, v in g["launches_per_replay"].items())
        + ", untraced " + ", ".join(
            f"{k}={v}" for k, v in out["untraced_launches_per_replay"].items())
        + "; replayed span per interval (CUDA events, runs alternated "
        + " ".join(AB_ORDER) + "): traced " + ", ".join(
            f"{s:.2f}" for s in out["spans_ms"]["traced"])
        + " ms, untraced " + ", ".join(
            f"{s:.2f}" for s in out["spans_ms"]["untraced"])
        + f" ms; medians {med['traced']:.2f} / {med['untraced']:.2f} ms = "
        f"{100 * out['overhead']:+.1f}%; eager wall per interval (runs of "
        f"{EAGER_AB_INTERVALS} intervals alternated "
        + " ".join(AB_ORDER[:4]) + "): traced " + ", ".join(
            f"{s:.2f}" for s in eager_ms["traced"]) + " ms, untraced "
        + ", ".join(f"{s:.2f}" for s in eager_ms["untraced"]) + " ms")
    return out


def _sweep(cfg, model, dev, out_dir: str, graph=None) -> dict:
    """One ``run_sweep`` with diagnosis, its report written to
    ``out_dir``; wall time, launches, the loop cache's accounting."""
    from repro_torch.lab import batch as LB
    from repro_torch.lab.fuzz import run_sweep, write_fuzz_report

    LB.reset_loop_cache_stats()
    report, secs, counts = counted(lambda: run_sweep(
        cfg, model, diagnose=True, graph=graph, device=dev))
    stats = LB.loop_cache_stats()
    jpath, mpath = write_fuzz_report(report, out_dir)
    with open(jpath, "rb") as f, open(mpath, "rb") as g:
        files = (f.read(), g.read())
    return dict(report=report, seconds=secs, counts=counts, stats=stats,
                files=files, jpath=jpath)


def _sweep_line(name: str, r: dict) -> str:
    s, st = r["report"]["summary"], r["stats"]
    return (f"{name}: {s['n_scenarios']} scenarios in {s['n_buckets']} "
            f"buckets, {s['n_dispatches']} fused runs, {s['n_losses']} "
            f"losses ({s.get('n_diagnosed', 0)} diagnosed: "
            + ", ".join(f"{c}={k}" for c, k in s.get("loss_causes",
                                                    {}).items())
            + f") in {r['seconds']:.3f} s; captures {st['captures']} in "
            f"{st['capture_s']:.3f} s, replays {st['replays']} (device span "
            f"{st['replay_device_ms']:.2f} ms); loop cache hits "
            f"{st['hits']}, misses {st['misses']}; launches counted "
            + ", ".join(f"{k}={v}" for k, v in r["counts"].items())
            + ("; replayed " + ", ".join(
                f"{k}={v}" for k, v in st["replayed_launches"].items())
               if st["replays"] else ""))


def obs_fuzz(model, dev, card: str) -> dict:
    """The fuzz sweep at ``FuzzConfig``'s defaults (the 24-point Θ grid,
    6 s, four topologies, 0-3 events) cut to 8 scenarios, diagnosis on,
    twice on graphs: the two reports byte-identical."""
    import shutil

    from repro_torch.lab.fuzz import FuzzConfig

    cfg = FuzzConfig(n_scenarios=FUZZ_SCENARIOS)
    out_dir = os.path.join(OBS_ROOT, "fuzz")
    shutil.rmtree(out_dir, ignore_errors=True)
    runs = [_sweep(cfg, model, dev, out_dir) for _ in range(2)]
    if runs[0]["files"] != runs[1]["files"]:
        raise AssertionError("fuzz sweep: two runs wrote different reports")
    for r in runs[0]["report"]["scenarios"]:
        if not all(np.isfinite(r[k]) and r[k] >= 0 for k in (
                "dial_mbs", "best_static_mbs", "dial_frac_of_best_static")):
            raise AssertionError(f"fuzz sweep: {r['name']} MB/s malformed")
    for name, r in zip(("fuzz sweep", "fuzz sweep again"), runs):
        log(f"{card} | " + _sweep_line(name, r))
    return dict(runs=runs, config=cfg)


def obs_cut_sweep(model, model_cpu, dev, card: str) -> dict:
    """The CI-sized sweep (``SMOKE``: 6 static θ, 3 s, two topologies)
    cut to 4 scenarios, diagnosis on, on the card on graphs and eager
    and on the CPU (plain versions, one torch thread, their fastest at
    these sizes): the three reports byte-identical.  Then its losers
    through ``diagnose_many`` on graphs and eager: identical, and equal
    to the sweep's diagnoses."""
    import importlib

    import torch

    from repro_torch.lab import batch as LB
    from repro_torch.lab.diagnose import specs_from_report
    from repro_torch.lab.fuzz import SMOKE

    # the module (``repro_torch.obs`` exports a function ``diagnose``)
    D = importlib.import_module("repro_torch.obs.diagnose")
    cfg = dataclasses.replace(SMOKE, n_scenarios=CUT_SCENARIOS)
    out_dir = os.path.join(OBS_ROOT, "fuzz_cut")
    runs = {"graphs": _sweep(cfg, model, dev, out_dir),
            "eager": _sweep(cfg, model, dev, out_dir, graph=False)}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    try:
        runs["cpu"] = _sweep(cfg, model_cpu, "cpu", out_dir)
    finally:
        torch.set_num_threads(threads)
    runs["cpu"]["seconds"] = time.perf_counter() - t0
    for name in ("eager", "cpu"):
        if runs[name]["files"] != runs["graphs"]["files"]:
            raise AssertionError(f"cut sweep: the {name} report differs from "
                                 "the card's on graphs")
    for name, r in runs.items():
        log(f"{card} | " + _sweep_line(f"cut sweep ({name})", r))
    log(f"{card} | cut sweep: reports byte-identical on the card (graphs, "
        "eager) and the CPU")
    report = runs["graphs"]["report"]
    pairs = specs_from_report(runs["graphs"]["jpath"], None, True)
    diag = {}
    if pairs:
        dcfg = D.DiagnoseConfig.from_fuzz(cfg)
        for name, graph in (("graphs", None), ("graphs again", None),
                            ("eager", False)):
            if name == "graphs":
                LB._FUSED_LOOPS.clear()      # the sweep's graphs are these
            LB.reset_loop_cache_stats()
            diags, secs, counts = counted(lambda: D.diagnose_many(
                pairs, model, dcfg, graph=graph, device=dev))
            diag[name] = dict(diagnoses=diags, seconds=secs, counts=counts,
                              stats=LB.loop_cache_stats())
        for name in ("graphs again", "eager"):
            if diag[name]["diagnoses"] != diag["graphs"]["diagnoses"]:
                raise AssertionError(f"diagnose_many: {name} differs from "
                                     "the first run on graphs")
        stamped = {r["fingerprint"]: r.get("diagnosis")
                   for r in report["triage"]["losses"]}
        for d in diag["graphs"]["diagnoses"]:
            if stamped[d["fingerprint"]] != {
                    k: v for k, v in d.items()
                    if k not in ("name", "fingerprint")}:
                raise AssertionError("diagnose_many differs from the "
                                     "sweep's diagnosis of "
                                     f"{d['fingerprint']}")
        g, a, e = (diag[k] for k in ("graphs", "graphs again", "eager"))
        log(f"{card} | diagnose_many of the cut sweep's {len(pairs)} losers "
            f"(one traced, intervened fused run per padded bucket): on "
            f"graphs {g['seconds']:.3f} s (captures {g['stats']['captures']}"
            f" in {g['stats']['capture_s']:.3f} s, replays "
            f"{g['stats']['replays']}), again {a['seconds']:.3f} s "
            f"({a['stats']['captures']} captures), eager {e['seconds']:.3f} "
            "s; diagnoses identical, and equal to the sweep's")
    return dict(runs=runs, diag=diag)


def obs_trace_loser(model, dev, fuzz: dict, card: str) -> dict:
    """``trace`` of the sweep's worst triaged loser: decisions equal to the
    sweep's DIAL arm, written as JSONL, Chrome and markdown, and read
    back."""
    from repro_torch.lab.trace import (load_spec_from_report,
                                       trace_scenario, write_trace)
    from repro_torch.obs.schema import TraceConfig
    from repro_torch.obs.sinks import read_jsonl, read_jsonl_diagnosis

    report = fuzz["runs"][0]["report"]
    losses = report["triage"]["losses"]
    if not losses:
        log(f"{card} | trace: the sweep triaged no loser; traced its "
            "worst scenario instead")
        worst = min(report["scenarios"],
                    key=lambda r: r["dial_frac_of_best_static"])
        from repro_torch.lab.fuzz import generate_spec
        spec = generate_spec(fuzz["config"], worst["index"])
    else:
        worst = losses[0]
        spec = load_spec_from_report(fuzz["runs"][0]["jpath"],
                                     worst["fingerprint"])
    trace, secs, counts = counted(lambda: trace_scenario(
        spec, model, seconds=fuzz["config"].seconds,
        config=TraceConfig(stride=TRACE_STRIDE), device=dev))
    if int(trace.decisions["changed"].sum()) != worst["changes"]:
        raise AssertionError("trace: θ changes differ from the sweep's")
    diagnosis = worst.get("diagnosis")
    paths = write_trace(trace, os.path.join(OBS_ROOT, "trace"),
                        title=spec.name, diagnosis=diagnosis)
    back = read_jsonl(paths["jsonl"])
    back.validate()
    for f in ("decided", "theta", "changed", "warm"):
        if not np.array_equal(back.decisions[f], trace.decisions[f]):
            raise AssertionError(f"trace: JSONL {f} differs on reading back")
    np.testing.assert_allclose(back.timeline["read_bytes"],
                               trace.timeline["read_bytes"], rtol=1e-12)
    if (read_jsonl_diagnosis(paths["jsonl"]) is None) != (diagnosis is None):
        raise AssertionError("trace: the diagnosis record did not round-trip")
    with open(paths["chrome"]) as f:
        n_events = len(json.load(f)["traceEvents"])
    sizes = {k: os.path.getsize(p) for k, p in paths.items()}
    log(f"{card} | trace of {spec.name} ({worst['fingerprint']}, DIAL at "
        f"{100 * worst['dial_frac_of_best_static']:.1f}% of best static): "
        f"{trace.n_intervals} intervals x {trace.n_interfaces} interfaces, "
        f"{len(trace.timeline['t'])} samples in {secs:.3f} s; JSONL "
        f"{sizes['jsonl']} B read back, Chrome {n_events} events, markdown "
        f"{sizes['md']} B; launches " + ", ".join(
            f"{k}={v}" for k, v in counts.items()))
    return dict(seconds=secs, counts=counts, sizes=sizes, events=n_events)


def obs_kernels(model, fuzz_cfg, rng) -> tuple:
    """``segment_sum`` as the timeline tap launches it (five columns on
    the fleet's OST map) and on the four maps of each fuzz bucket's first
    chunk, the paired forest on each chunk's rows, against their plain
    versions, timed as phase 4 times them."""
    import dataclasses as dc

    import torch

    from repro_torch.core.config_space import SPACE
    from repro_torch.kernels.gbdt_forest.ops import pair_forests
    from repro_torch.lab.batch import pad_class, stack_scenarios
    from repro_torch.lab.fuzz import generate_specs
    from repro_torch.lab.scenarios import build

    dev = model.device
    sim = build_sim(CLIENTS, OSTS, dev)
    maps = {"timeline tap, osc_ost x5": (sim.topo.ost_map, 5)}
    groups: dict = {}
    for spec in generate_specs(fuzz_cfg):
        groups.setdefault(pad_class(build(spec)), []).append(spec)
    arms = len(SPACE) + 1
    fleets = []
    for key in sorted(groups, key=lambda k: tuple(k[1:])):
        chunk = groups[key][:max(1, fuzz_cfg.max_batch_elems // arms)]
        built = [build(dc.replace(s, initial_theta=th))
                 for s in chunk for th in SPACE.configs() + [s.initial_theta]]
        b = stack_scenarios(built, device=dev)
        tag = "fuzz " + "x".join(str(int(x)) for x in key[1:])
        fleets.append((tag, b))
        maps.update({f"{tag} osc_ost x2": (b.fleet.ost_map, 2),
                     f"{tag} osc_client": (b.fleet.client_map, 1),
                     f"{tag} entry_row": (b.table.row_map, 1),
                     f"{tag} entry_osc x8": (b.table.osc_map, 8)})
    seg = check_segment_sum(maps, rng)
    feature, threshold, leaf, base, _, n_features = pair_forests(
        model.read_forest, model.write_forest)
    to = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    forests = []
    for tag, b in fleets:
        n_osc = b.fleet.n_osc
        x = to((rng.standard_normal((n_osc * 24, n_features)) * 10.0
                ** rng.uniform(-1, 3, n_features)).astype(np.float32))
        op = to(np.repeat(rng.integers(0, 2, n_osc), 24).astype(np.int32))
        forests.append(dict(fleet=tag, **check_forest(
            "paired_forest_margin",
            "src/repro/kernels/gbdt_forest/kernel.py:96", x, op,
            *map(to, (feature, threshold, leaf, base)),
            label=f" ({tag} rows)")))
    return seg, forests


def obs_phase(model, seed: int, dev, kernels: list, card: str) -> str:
    """Phase 10, observability and the loss-finding pipeline, on the
    model phase 3 trained: the traced fleet, the fuzz sweep (twice) and
    ``diagnose_many`` of its losers, the cut sweep on the card and the
    CPU, the worst loser's trace, and the two kernels at the tap's and
    the fuzz buckets' shapes; launches go into the kernels' rows.
    Returns the cut sweep's ``report.json`` (phase 11's curriculum)."""
    import torch

    from repro_torch.convert import forest_to_numpy, model_from_numpy
    from repro_torch.pfs.state import READ, WRITE

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 10)
    by_name = {k["name"]: k for k in kernels}
    traced = obs_traced_fleet(model, dev, card)
    torch.cuda.empty_cache()
    fuzz = obs_fuzz(model, dev, card)
    model_cpu = model_from_numpy(*(forest_to_numpy(model.forest(op))
                                   for op in (READ, WRITE)), device="cpu")
    cut = obs_cut_sweep(model, model_cpu, dev, card)
    tr = obs_trace_loser(model, dev, fuzz, card)
    seg, forests = obs_kernels(model, fuzz["config"], rng)
    torch.cuda.empty_cache()
    by_name["segment_sum"]["obs_shapes"] = seg["cases"]
    by_name["paired_forest_margin"]["obs_shapes"] = [
        {k: f[k] for k in ("fleet", "ms", "eager_ms", "plain_ms", "bound_ms",
                           "bound_by", "max_abs_err", "shape")}
        for f in forests]
    sweeps = [("fuzz sweep", fuzz["runs"][0]),
              ("fuzz sweep again", fuzz["runs"][1]),
              ("cut sweep graphs", cut["runs"]["graphs"]),
              ("cut sweep eager", cut["runs"]["eager"])]
    for kname in ("segment_sum", "paired_forest_margin"):
        add_path(by_name[kname], "traced fleet eager",
                 traced["eager_counts"].get(kname, 0))
        add_path(by_name[kname], "traced fleet graph (captured x replays)",
                 traced["graph_replayed"].get(kname, 0))
        for name, r in sweeps:
            add_path(by_name[kname], f"{name} (counted + replayed)",
                     r["counts"].get(kname, 0)
                     + r["stats"]["replayed_launches"].get(kname, 0))
        if cut["diag"]:
            for name in ("graphs", "graphs again", "eager"):
                d = cut["diag"][name]
                add_path(by_name[kname], f"diagnose_many {name} (counted + "
                         "replayed)", d["counts"].get(kname, 0)
                         + d["stats"]["replayed_launches"].get(kname, 0))
        add_path(by_name[kname], "trace", tr["counts"].get(kname, 0))
    summary = lambda r: dict(seconds=r["seconds"], **{  # noqa: E731
        k: r["stats"][k] for k in ("captures", "capture_s", "replays",
                                   "replay_device_ms", "hits", "misses")},
        **{k: r["report"]["summary"][k] for k in (
            "n_buckets", "n_dispatches", "n_losses")})
    by_name["paired_forest_margin"]["obs"] = dict(
        traced_fleet={k: v for k, v in traced.items()
                      if k not in ("eager_counts", "graph_replayed")},
        fuzz=[summary(r) for r in fuzz["runs"]],
        diagnose_many={k: dict(seconds=v["seconds"], n=len(v["diagnoses"]),
                               captures=v["stats"]["captures"])
                       for k, v in cut["diag"].items()},
        cut_sweep={k: summary(v) for k, v in cut["runs"].items()},
        trace=tr, phase_s=time.perf_counter() - t_phase)
    log(f"{card} | phase 10: {time.perf_counter() - t_phase:.1f} s")
    return cut["runs"]["graphs"]["jpath"]


# ---------------------------------------------------------------------- #
# phase 11: continual refit, the hard-case curriculum, overhead, the mesh
# ---------------------------------------------------------------------- #
CONT_SCENARIO = "failing_ost"             # run_comparison's default
# run_comparison's 45 s cut (the OST fails at 3 s) to keep the smoke
# inside its 1,200 s: to 22.5 s beside phase 14, to 10 s (20 intervals x 2
# arms, refits at 7 and 14) beside phase 16
CONT_SECONDS = 10.0
DIAL_ROOT = os.path.join(ROOT, "build", "dial")
TRAIN_ROOT = os.path.join(ROOT, "build", "train")

# A child process's run, its result, seconds and launches into
# ``<out>/run.json``: the second card comparison and the curriculum run
# beside the first card comparison, each process a host loop on its own
# cores (the paths are host-bound), and the CPU comparison (plain
# versions, one torch thread) beside them too.
CHILD_RUN = r"""
import json, os, sys, time
import torch
from repro_torch.kernels import LAUNCHES
from repro_torch.lab import batch as LB
what, prefix, out, arg, seconds = sys.argv[1:6]
dev = torch.device("cpu" if what == "cpu" else "cuda")
if dev.type == "cpu":
    torch.set_num_threads(1)
sync = (lambda: torch.cuda.synchronize()) if dev.type == "cuda" else (
    lambda: None)
sync()
LAUNCHES.clear()
t0 = time.perf_counter()
if what == "curriculum":
    from repro_torch.lab.__main__ import main
    main(["continual", "--hard-from", arg, "--smoke", "--model", prefix,
          "--out", out])
else:
    from repro_torch.core.model import DIALModel
    from repro_torch.lab.continual import run_comparison, write_report
    model = DIALModel.load(prefix, device=dev)
    write_report(run_comparison(arg, model, seconds=float(seconds),
                                device=dev), out)
sync()
secs = time.perf_counter() - t0
os.makedirs(out, exist_ok=True)
with open(os.path.join(out, "run.json"), "w") as f:
    json.dump({"seconds": secs, "counts": dict(LAUNCHES),
               "loop_cache": LB.loop_cache_stats()}, f)
"""


def _child(what: str, prefix: str, out: str, arg: str):
    """Start one of ``CHILD_RUN``'s runs (the CPU one sees no card)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    if what == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.Popen([sys.executable, "-c", CHILD_RUN, what, prefix,
                             out, arg, str(CONT_SECONDS)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish_child(proc, out: str, what: str) -> dict:
    """Wait for a child; its ``run.json``, and the seconds waited."""
    t0 = time.perf_counter()
    log_text, _ = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"{what} (child process) failed: "
                             f"{log_text[-2000:]}")
    with open(os.path.join(out, "run.json")) as f:
        return dict(json.load(f), wait_s=time.perf_counter() - t0,
                    log=log_text)


def _first_diff(a: list, b: list):
    """Index of the first differing entry of two series (None: equal)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def dial_comparison(model, dev, card: str, children: dict) -> dict:
    """``run_comparison("failing_ost")`` at its defaults but
    :data:`CONT_SECONDS` on the card, here
    and in a child process (the two reports byte-identical), and in a
    child on the CPU: the frozen arm bit-equal, the online arm bit-equal
    through its first refit; a later difference is stated, not hidden.
    The first refit's buffer rows are kept for the ``tree_histogram``
    check."""
    from repro_torch.lab.continual import run_comparison, write_report
    from repro_torch.learn import online as O

    first = {}
    orig = O.OnlineTrainer._refit

    def refit(self, ops, reason, tput):        # keep the first refit's rows
        if "data" not in first:
            first["data"] = [self.buffers[op].dataset() for op in ops]
        return orig(self, ops, reason, tput)

    O.OnlineTrainer._refit = refit
    try:
        rep, secs, counts = counted(lambda: run_comparison(
            CONT_SCENARIO, model, seconds=CONT_SECONDS, device=dev))
    finally:
        O.OnlineTrainer._refit = orig
    with open(write_report(rep, os.path.join(DIAL_ROOT, "card"))) as f:
        text = f.read()
    runs = {name: _finish_child(children[name], os.path.join(
        DIAL_ROOT, name), f"continual on the {name}")
        for name in ("card_again", "cpu")}
    with open(os.path.join(DIAL_ROOT, "card_again", "continual.json")) as f:
        if f.read() != text:
            raise AssertionError("continual: two card runs wrote different "
                                 "reports")
    with open(os.path.join(DIAL_ROOT, "cpu", "continual.json")) as f:
        cpu = json.load(f)
    rep = json.loads(text)
    fr, on, cfr, con = (rep["frozen"], rep["online"], cpu["frozen"],
                        cpu["online"])
    if fr != cfr:
        diff = _first_diff(fr["tput_mbs"], cfr["tput_mbs"])
        raise AssertionError(f"continual: the frozen arm differs card vs "
                             f"CPU (first differing interval {diff})")
    if not on["refits"] or on["refits"][0] != con["refits"][0]:
        raise AssertionError(f"continual: first refit card {on['refits'][:1]}"
                             f" vs CPU {con['refits'][:1]}")
    i = on["refits"][0]["interval"]
    for k in ("tput_mbs", "theta_trace"):
        if on[k][:i] != con[k][:i]:
            raise AssertionError(f"continual: online {k} differs card vs CPU "
                                 f"before the first refit (interval "
                                 f"{_first_diff(on[k], con[k])})")
    after = _first_diff(on["tput_mbs"], con["tput_mbs"])
    again, on_cpu = runs["card_again"], runs["cpu"]
    out = dict(
        card_s=secs, card_again_s=again["seconds"], cpu_s=on_cpu["seconds"],
        intervals=len(fr["tput_mbs"]), refits=rep["refits"],
        refit_intervals=[r["interval"] for r in on["refits"]],
        first_refit=i, online_first_difference=after,
        post_fail_gain=rep["post_fail_gain"],
        post_tail_gain=rep["post_tail_gain"],
        frozen_post_fail_mbs=fr["post_fail_mbs"],
        online_post_fail_mbs=on["post_fail_mbs"],
        counts=counts, again_counts=again["counts"],
        refit_rows=first.get("data"))
    log(f"{card} | continual {CONT_SCENARIO} at run_comparison's defaults "
        f"but {CONT_SECONDS:g} s ({len(fr['tput_mbs'])} intervals x 2 arms, "
        f"refits of 40 x 5 trees): card {secs:.3f} s here and {again['seconds']:.3f} s in a "
        f"child process beside it (reports byte-identical), the CPU "
        f"{on_cpu['seconds']:.3f} s in another child (plain versions, one "
        f"thread); frozen arm card == CPU bit for bit; online arm: "
        f"{rep['refits']} refit(s) at intervals {out['refit_intervals']}, "
        f"card == CPU through the first (interval {i}), "
        + ("identical to the end" if after is None else
           f"first differing interval {after} (card "
           f"{on['tput_mbs'][after]!r} vs CPU {con['tput_mbs'][after]!r} "
           "MB/s)")
        + f"; post-failure gain {rep['post_fail_gain']:.4f}x (tail "
        f"{rep['post_tail_gain']:.4f}x), frozen {fr['post_fail_mbs']:.3f} "
        f"vs online {on['post_fail_mbs']:.3f} MB/s; launches "
        + ", ".join(f"{k}={v}" for k, v in counts.items()))
    return out


def dial_curriculum(proc, card: str) -> dict:
    """``continual --hard-from`` on the cut sweep's report with the
    ``--smoke`` settings, through the CLI in a child process on the
    card: a well-formed report; when a replay refit the model, the
    after races captured their loops anew (a miss for each bucket's
    before and after race)."""
    out = os.path.join(DIAL_ROOT, "curriculum")
    run = _finish_child(proc, out, "continual --hard-from")
    stats = run["loop_cache"]
    with open(os.path.join(out, "curriculum.json")) as f:
        rep = json.load(f)
    if rep["schema"] != "dial-curriculum-v1" or not rep["n_losers"]:
        raise AssertionError("curriculum: malformed report")
    for c in rep["cases"]:
        for side in ("before", "after"):
            if not all(np.isfinite(c[side][k]) and c[side][k] >= 0 for k in (
                    "dial_mbs", "best_static_mbs")):
                raise AssertionError(f"curriculum: {c['name']} {side} "
                                     "MB/s malformed")
    if rep["n_refits"] and stats["misses"] < 2:
        raise AssertionError("curriculum: the after races did not capture "
                             "their loops anew")
    o = rep["overall"]
    log(f"{card} | continual --hard-from (cut sweep, --smoke, a child "
        f"process): {rep['n_losers']} losers, {rep['n_replays']} replays, "
        f"{rep['n_refits']} refits in {run['seconds']:.3f} s; loss rate "
        f"{o['before_loss_rate']:.4f} -> {o['after_loss_rate']:.4f}; loop "
        f"cache misses {stats['misses']}, hits {stats['hits']}, captures "
        f"{stats['captures']} ({stats['capture_s']:.3f} s); launches "
        + ", ".join(f"{k}={v}" for k, v in run["counts"].items())
        + ("; replayed " + ", ".join(
            f"{k}={v}" for k, v in stats["replayed_launches"].items())
           if stats["replays"] else ""))
    return dict(seconds=run["seconds"], counts=run["counts"], stats=stats,
                n_losers=rep["n_losers"], n_replays=rep["n_replays"],
                n_refits=rep["n_refits"], overall=o)


def dial_overhead(model, dev, card: str) -> dict:
    """``FleetAgent(measure_overhead=True)`` on phase 6's 8,192-interface
    fleet for its 10 intervals: θ identical to phase 6's unmeasured host
    loop; the per-interface Table III figures."""
    from repro_torch.core.fleet import run_fleet
    from repro_torch.pfs.state import READ, WRITE

    sim = build_sim(CLIENTS, OSTS, dev)
    fleet, secs, counts = counted(lambda: run_fleet(
        sim, model, seconds=SECONDS, interval=INTERVAL, device=dev,
        measure_overhead=True))
    if trajectory(fleet) != MAIN_PATH["trajectory"]:
        raise AssertionError("measure_overhead: θ differs from the "
                             "unmeasured host loop's")
    out = {name: fleet.timings[op].summary()
           for op, name in ((READ, "read"), (WRITE, "write"))}
    n = {name: len(fleet.timings[op].end_to_end_ms)
         for op, name in ((READ, "read"), (WRITE, "write"))}
    log(f"{card} | overhead (measure_overhead=True, each stage boundary "
        f"synchronized): {sim.n_osc} interfaces, "
        f"{int(round(SECONDS / INTERVAL))} intervals in {secs:.3f} s, θ "
        "identical to phase 6's host loop; per interface, ms: " + "; ".join(
            f"{name} snapshot {r['snapshot_ms']:.6f}, inference "
            f"{r['inference_ms']:.6f}, end to end {r['end_to_end_ms']:.6f} "
            f"({n[name]} decided ticks)" for name, r in out.items())
        + "; launches " + ", ".join(f"{k}={v}" for k, v in counts.items()))
    return dict(seconds=secs, counts=counts, timings=out, ticks=n)


def dial_mesh(model, seed: int, dev, card: str) -> dict:
    """The wide batch (1,024 noisy_neighbor variants, 8,192 interfaces)
    through ``run_batch(fused=True)`` on graphs, unsharded and over
    ``fleet_mesh()`` (every visible card), alternated U M M U: the mesh
    bit-equal to the unsharded run; ms per replayed interval of each."""
    import torch

    from repro_torch.distributed.sharding import fleet_mesh
    from repro_torch.lab import batch as LB
    from repro_torch.lab.scenarios import build, get_scenario, variants

    built = [build(s) for s in variants(get_scenario("noisy_neighbor"),
                                        WIDE_VARIANTS, seed=seed)]
    mesh = fleet_mesh()
    runs = []
    for name, m in (("unsharded", None), ("mesh", mesh),
                    ("mesh again", mesh), ("unsharded again", None)):
        batch = LB.stack_scenarios(built, device=dev)
        LB.reset_loop_cache_stats()
        res, secs, counts = counted(lambda: LB.run_batch(
            batch, model, seconds=WIDE_SECONDS, interval=LAB_INTERVAL,
            fused=True, mesh=m))
        stats = LB.loop_cache_stats()
        runs.append(dict(name=name, batch=batch, result=res, seconds=secs,
                         counts=counts, stats=stats,
                         ms=(stats["replay_device_ms"] / stats["replays"]
                             if stats["replays"] else None)))
    base = runs[0]
    for r in runs[1:]:
        for key, v in base["result"].trace.items():
            if not torch.equal(v, r["result"].trace[key]):
                raise AssertionError(f"mesh ({r['name']}): record {key} "
                                     "differs from the unsharded run's")
        for f in dataclasses.fields(base["batch"].state):
            a = getattr(base["batch"].state, f.name)
            b = getattr(r["batch"].state, f.name)
            if not (torch.equal(a, b) if torch.is_tensor(a) else a == b):
                raise AssertionError(f"mesh ({r['name']}): {f.name} differs "
                                     "from the unsharded run's")
    log(f"{card} | mesh: {len(built)} variants = {base['batch'].fleet.n_osc} "
        f"interfaces over fleet_mesh() = {len(mesh)} device(s), "
        f"{int(round(WIDE_SECONDS / LAB_INTERVAL))} intervals on graphs, bit-"
        "equal to the unsharded run; ms per replayed interval (CUDA "
        "events), wall s, captures: " + "; ".join(
            f"{r['name']} " + ("not measured" if r["ms"] is None
                               else f"{r['ms']:.2f} ms")
            + f", {r['seconds']:.3f} s, "
            f"{r['stats']['captures']}" for r in runs))
    for r in runs:
        del r["batch"], r["result"]
    return dict(devices=len(mesh), runs=runs)


def dial_kernels(model, refit_rows, rng) -> tuple:
    """The three kernels at the continual path's shapes, against their
    plain versions: ``segment_sum`` on the 4 x 4 scenario's maps, the
    paired forest on its 16 interfaces x 24 rows, ``tree_histogram`` on
    the first refit's buffer rows."""
    import torch

    from repro_torch.kernels.gbdt_forest.ops import pair_forests
    from repro_torch.lab.batch import stack_scenarios
    from repro_torch.lab.scenarios import build, get_scenario

    dev = model.device
    b = stack_scenarios([build(get_scenario(CONT_SCENARIO))], device=dev)
    tag = CONT_SCENARIO
    seg = check_segment_sum({f"{tag} osc_ost x2": (b.fleet.ost_map, 2),
                             f"{tag} osc_client": (b.fleet.client_map, 1),
                             f"{tag} entry_row": (b.table.row_map, 1),
                             f"{tag} entry_osc x8": (b.table.osc_map, 8)},
                            rng)
    feature, threshold, leaf, base, _, n_features = pair_forests(
        model.read_forest, model.write_forest)
    to = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    n_osc = b.fleet.n_osc
    x = to((rng.standard_normal((n_osc * 24, n_features)) * 10.0
            ** rng.uniform(-1, 3, n_features)).astype(np.float32))
    op = to(np.repeat(rng.integers(0, 2, n_osc), 24).astype(np.int32))
    forest = check_forest("paired_forest_margin",
                          "src/repro/kernels/gbdt_forest/kernel.py:96", x, op,
                          *map(to, (feature, threshold, leaf, base)),
                          label=f" ({tag} rows)")
    hist = check_tree_histogram(refit_rows, rng, dev)
    return seg, forest, hist


def dial_phase(model, seed: int, dev, kernels: list, card: str,
               cut_report: str) -> None:
    """Phase 11, the rest of DIAL's side, on the model phase 3 trained:
    continual refit (frozen vs online) on the card here and in a child
    process, and on the CPU in another; the hard-case curriculum over
    phase 10's cut sweep in a third (the three children run beside the
    first comparison); then Table III's overhead timing on phase 6's
    fleet, the wide batch over a fleet mesh, and the three kernels at
    the continual path's shapes.  Launches go into rows 1, 2 and 4."""
    import shutil

    import torch

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 11)
    by_name = {k["name"]: k for k in kernels}
    shutil.rmtree(DIAL_ROOT, ignore_errors=True)
    os.makedirs(DIAL_ROOT)
    prefix = os.path.join(DIAL_ROOT, "model")
    model.save(prefix)
    children = {
        "card_again": _child("card", prefix,
                             os.path.join(DIAL_ROOT, "card_again"),
                             CONT_SCENARIO),
        "cpu": _child("cpu", prefix, os.path.join(DIAL_ROOT, "cpu"),
                      CONT_SCENARIO),
        "curriculum": _child("curriculum", prefix,
                             os.path.join(DIAL_ROOT, "curriculum"),
                             cut_report)}
    try:
        comparison = dial_comparison(model, dev, card, children)
        curriculum = dial_curriculum(children["curriculum"], card)
    finally:
        for proc in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    log(f"{card} | phase 11: the three child processes done at "
        f"{time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    overhead = dial_overhead(model, dev, card)
    torch.cuda.empty_cache()
    mesh = dial_mesh(model, seed, dev, card)
    torch.cuda.empty_cache()
    if comparison["refit_rows"] is None:
        raise AssertionError("continual: no refit's rows to check")
    seg, forest, hist = dial_kernels(model, comparison.pop("refit_rows"), rng)
    by_name["segment_sum"]["dial_shapes"] = seg["cases"]
    by_name["paired_forest_margin"]["dial_shapes"] = [
        {k: forest[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                "bound_by", "max_abs_err", "shape")}]
    by_name["tree_histogram"]["dial_shapes"] = {
        k: hist[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                             "bound_by", "max_abs_err", "shape")}

    # a curriculum whose replays never refit launches no tree_histogram
    cur_kernels = ("segment_sum", "paired_forest_margin") + (
        ("tree_histogram",) if curriculum["n_refits"] else ())
    for kname in ("segment_sum", "paired_forest_margin", "tree_histogram"):
        add_path(by_name[kname], "continual card",
                 comparison["counts"].get(kname, 0))
        add_path(by_name[kname], "continual card, child process",
                 comparison["again_counts"].get(kname, 0))
    for kname in cur_kernels:
        add_path(by_name[kname], "continual --hard-from (counted + "
                 "replayed)", curriculum["counts"].get(kname, 0)
                 + curriculum["stats"]["replayed_launches"].get(kname, 0))
    for kname in ("segment_sum", "paired_forest_margin"):
        add_path(by_name[kname], "measure_overhead fleet",
                 overhead["counts"].get(kname, 0))
        for r in mesh["runs"]:
            if r["name"].startswith("mesh"):
                add_path(by_name[kname], f"{r['name']} (counted + replayed)",
                         r["counts"].get(kname, 0)
                         + r["stats"]["replayed_launches"].get(kname, 0))
    by_name["paired_forest_margin"]["dial"] = dict(
        comparison={k: v for k, v in comparison.items()
                    if k not in ("counts", "again_counts")},
        curriculum={k: v for k, v in curriculum.items()
                    if k not in ("counts", "stats")},
        overhead={k: v for k, v in overhead.items() if k != "counts"},
        mesh=dict(devices=mesh["devices"], runs=[
            {k: r[k] for k in ("name", "seconds", "ms")}
            for r in mesh["runs"]]),
        phase_s=time.perf_counter() - t_phase)
    log(f"{card} | phase 11: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------- #
# phase 12: LM training with DIAL in its data path
# ---------------------------------------------------------------------- #
TRAIN_ARCH = "gemma2-2b"                  # the family that fits: 2.61 B
TRAIN_FULL = dict(steps=6, batch=4, seq_len=2048, n_hosts=4)
# each smoke step's quota (800 MB a host) takes two probe intervals of
# the 520 MB a host reads in one, so DIAL decides from the third step on
TRAIN_SMOKE = dict(steps=3, batch=4, seq_len=64, n_hosts=4,
                   bytes_per_token=800e6 * 4 / (4 * 64))
# Adam's eps in the card-vs-CPU runs: at the default 1e-8 an element
# whose gradient is at rounding level (~1e-9) steps by about +-lr on its
# sign, whichever device computed it (2.65e-4 of a leaf's largest |value|
# after 3 steps, on the card); 1e-3 bounds that gain at 1/eps
TRAIN_SMOKE_EPS = 1e-3
BF16_OPS_PER_S = 989e12                   # H100 SXM bf16 dense
LM_KERNELS = ("flash_attention", "rglru_scan", "selective_scan")
# the families whose smoke training runs through the DIAL pipeline here;
# phase 13 holds the other seven's training steps card vs CPU
TRAIN_SMOKE_ARCHS = ("gemma2-2b", "recurrentgemma-9b", "falcon-mamba-7b")
CHECK_SCENARIO = "degraded_ost"           # ROADMAP Queue 3: pow_cr


def train_full(model, dev, card: str) -> dict:
    """``train`` of gemma2-2b at its full published config for 6 steps
    of 4 x 2,048 tokens, DIAL (phase 3's model) tuning the pipeline's 4
    host clients; no checkpoint.  Every loss and grad norm finite; the
    two DIAL kernels launched, the LM kernels not (training runs the
    plain forms)."""
    import torch

    from repro_torch.launch.train import train
    from repro_torch.train.optimizer import tree_leaves

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out, secs, counts = counted(lambda: train(
        TRAIN_ARCH, smoke=False, dial_model=model, dial_model_path=None,
        device=dev, log_every=1, **TRAIN_FULL))
    recs = out["records"]
    if not all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in recs) or len(recs) != TRAIN_FULL["steps"]:
        raise AssertionError("train (full): a loss or grad norm is not "
                             "finite")
    for k in LM_KERNELS:
        if counts.get(k, 0):
            raise AssertionError(f"train (full): {k} launched {counts[k]} "
                                 "times on the training path")
    n_params = sum(p.numel() for p in tree_leaves(out["params"]))
    tokens = TRAIN_FULL["batch"] * TRAIN_FULL["seq_len"]
    for r in recs:
        s = r["step_ms"] / 1e3
        r["tokens_per_s"] = tokens / s
        r["mfu"] = 6 * n_params * tokens / s / BF16_OPS_PER_S
        log(f"{card} | train {TRAIN_ARCH} full step {r['step']}: loss "
            f"{r['loss']:.4f}, grad norm {r['grad_norm']:.4f}, next_batch "
            f"{r['next_batch_ms']:.2f} ms, train step {r['step_ms']:.2f} ms, "
            f"{r['tokens_per_s']:.1f} tokens/s, MFU {r['mfu']:.4f} (6 N T "
            f"over the step at bf16 989 TFLOP/s), peak "
            f"{r['peak_gib']:.2f} GiB, DIAL decisions {r['decisions']}, "
            f"ingest {r['ingest_mbs']:.3f} MB/s")
    log(f"{card} | train {TRAIN_ARCH} full: {n_params / 1e9:.3f} B "
        f"parameters, {len(recs)} steps in {secs:.3f} s; launches "
        + ", ".join(f"{k}={v}" for k, v in counts.items()))
    keep = ("step", "loss", "grad_norm", "next_batch_ms", "step_ms",
            "tokens_per_s", "mfu", "peak_gib", "decisions", "ingest_mbs")
    return dict(seconds=secs, counts=counts, n_params=n_params,
                steps=[{k: r[k] for k in keep} for r in recs], out=out)


def train_breakdown(out: dict, dev, card: str) -> dict:
    """Where one more full-width train step and one more ``next_batch``
    spend the card's time: each span on the host clock (synchronized),
    then once more under ``torch.profiler``, device time summed by
    kernel class."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.steps import make_train_step

    cfg = get_config(TRAIN_ARCH)
    step_fn = make_train_step(cfg, AdamWConfig(
        total_steps=TRAIN_FULL["steps"], warmup_steps=5))
    pipe, state = out["pipeline"], [out["params"], out["opt_state"]]
    batch = {k: torch.as_tensor(v, device=dev).long()
             for k, v in pipe.next_batch().items()}

    def train_step():
        state[:2] = step_fn(state[0], state[1], batch)[:2]

    res = {}
    for name, fn in (("train step", train_step),
                     ("next_batch", pipe.next_batch)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = [a for a in prof.key_averages()
               if a.device_type == DeviceType.CUDA]
        by = {}
        for a in ops:
            cls = _kernel_class(a.key)
            by[cls] = by.get(cls, 0.0) + a.device_time_total / 1e3
        busy = sum(by.values())
        res[name] = dict(wall_ms=wall, device_busy_ms=busy,
                         launches=sum(a.count for a in ops),
                         device_ms_by_class=by)
        log(f"{card} | train breakdown, {name}: wall {wall:.2f} ms; "
            + (f"device busy {busy:.2f} ms ({busy / wall:.1%}) in "
               f"{res[name]['launches']} operations; by class " + ", ".join(
                   f"{k} {v:.2f} ms" for k, v in sorted(
                       by.items(), key=lambda kv: -kv[1]))
               if ops else "busy share not measured (the profiler "
               "recorded no device activity)"))
    return res


def _smoke_run(arch: str, tree, model, dev) -> dict:
    """``train``'s loop at a float32 smoke config on ``dev`` from the
    parameters ``tree`` (the reference's layout, numpy): 3 steps through
    the DIAL-tuned pipeline; losses, grad norms, the final parameters,
    the knobs and the decisions."""
    import dataclasses as dc

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.steps import make_train_step

    cfg = dc.replace(get_smoke_config(arch), param_dtype="float32")
    c = TRAIN_SMOKE
    pipe = DataPipeline(PipelineConfig(
        global_batch=c["batch"], seq_len=c["seq_len"],
        vocab_size=cfg.vocab_size, n_hosts=c["n_hosts"],
        bytes_per_token=c["bytes_per_token"]), dial_model=model, device=dev)
    params = lm_params_from_numpy(cfg, tree, dev)
    state = init_opt_state(params)
    step = make_train_step(cfg, AdamWConfig(peak_lr=1e-2, min_lr=1e-3,
                                            warmup_steps=1, total_steps=4,
                                            eps=TRAIN_SMOKE_EPS))
    losses, norms = [], []
    for _ in range(c["steps"]):
        batch = {k: torch.as_tensor(v, device=dev).long()
                 for k, v in pipe.next_batch().items()}
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return dict(losses=losses, norms=norms,
                params=lm_params_to_numpy(cfg, params),
                theta=(pipe.sim.window_pages.tolist(),
                       pipe.sim.rpcs_in_flight.tolist()),
                decisions=[[(osc, op, tuple(d.theta), bool(d.changed))
                            for osc, op, d in a.decisions]
                           for a in pipe.agents])


def train_card_vs_cpu(model, model_cpu, card: str) -> dict:
    """The three smoke configs in float32, the same parameters (one
    seeded tree through ``lm_params_from_numpy``) and the same pipeline
    on the card and the CPU: losses and grad norms within 1e-4
    (relative), every parameter after the last step within 1e-4 of the
    largest |leaf| (Adam's eps ``TRAIN_SMOKE_EPS``; a zero-initialized
    leaf such as a gate bias reaches only ~lr in 3 steps, so its own
    largest |value| is no scale for float32 rounding), the pipeline's θ
    and decisions bit-equal."""
    import dataclasses as dc

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import lm_params_to_numpy
    from repro_torch.models import lm

    out = {}
    for arch in TRAIN_SMOKE_ARCHS:
        cfg = dc.replace(get_smoke_config(arch), param_dtype="float32")
        tree = lm_params_to_numpy(cfg, lm.init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"))
        t0 = time.perf_counter()
        card_run = _smoke_run(arch, tree, model, torch.device("cuda"))
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu_run = _smoke_run(arch, tree, model_cpu, "cpu")
        t_cpu = time.perf_counter() - t0
        def leaves(t):
            if isinstance(t, np.ndarray):
                return [t]
            return [x for v in (t.values() if isinstance(t, dict) else t)
                    for x in leaves(v)]

        pairs = list(zip(leaves(card_run["params"]),
                         leaves(cpu_run["params"])))
        scale = max(float(np.abs(b).max()) for _, b in pairs)
        err = [float(np.abs(a - b).max()) for a, b in pairs]
        worst = max(err) / scale
        # beside it, against each leaf's own largest |value|
        own = max(e / max(float(np.abs(b).max()), 1e-30)
                  for e, (_, b) in zip(err, pairs))
        for k in ("losses", "norms"):
            if not np.allclose(card_run[k], cpu_run[k], rtol=1e-4, atol=0):
                raise AssertionError(f"train card vs CPU ({arch}): {k} "
                                     f"{card_run[k]} vs {cpu_run[k]}")
        if worst > 1e-4:
            raise AssertionError(f"train card vs CPU ({arch}): parameters "
                                 f"differ by {worst} of the largest |leaf|")
        for k in ("theta", "decisions"):
            if card_run[k] != cpu_run[k]:
                raise AssertionError(f"train card vs CPU ({arch}): the "
                                     f"pipeline's {k} differ")
        dl = max(abs(a - b) / abs(b) for a, b in zip(card_run["losses"],
                                                      cpu_run["losses"]))
        out[arch] = dict(card_s=t_card, cpu_s=t_cpu, loss_rel=dl,
                         param_rel=worst, param_rel_own_leaf=own,
                         losses=card_run["losses"],
                         decisions=sum(map(len, card_run["decisions"])))
        log(f"{card} | train card vs CPU, {arch} SMOKE float32, "
            f"{TRAIN_SMOKE['steps']} steps of {TRAIN_SMOKE['batch']} x "
            f"{TRAIN_SMOKE['seq_len']}: losses {card_run['losses']} (max "
            f"relative difference {dl:.3g}), parameters within {worst:.3g} "
            f"of the largest |leaf| ({own:.3g} of a leaf's own largest), θ "
            f"and {out[arch]['decisions']} decisions "
            f"bit-equal; card {t_card:.3f} s, CPU {t_cpu:.3f} s")
    return out


def train_resume(model, dev, card: str) -> dict:
    """gemma2-2b SMOKE on the card: ``train`` 6 steps straight against 3
    steps, a checkpoint, and 3 resumed (losses within 1e-5: the
    embedding's backward sums with atomics on the card).  Then
    ``pfs_write`` of that checkpoint's bytes on the card and the CPU
    (2 clients x 4 OSTs, hosts 0 and 1): flush times within 1e-9
    relative."""
    import shutil

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.launch.train import train
    from repro_torch.pfs.engine import PFSSim

    d = os.path.join(TRAIN_ROOT, "ckpt")
    shutil.rmtree(TRAIN_ROOT, ignore_errors=True)
    kw = dict(batch=4, seq_len=64, seed=3, log_every=100, device=dev,
              dial_model=model, ckpt_through_pfs=False)
    t0 = time.perf_counter()
    full = train(TRAIN_ARCH, steps=6, **kw)
    train(TRAIN_ARCH, steps=3, ckpt_dir=d, ckpt_every=3, **kw)
    resumed = train(TRAIN_ARCH, steps=6, ckpt_dir=d, ckpt_every=3, **kw)
    secs = time.perf_counter() - t0
    diff = np.abs(np.array(resumed["losses"]) - full["losses"][3:])
    if len(resumed["losses"]) != 3 or not (diff <= 1e-5).all():
        raise AssertionError(f"train resume: {resumed['losses']} vs "
                             f"{full['losses'][3:]}")
    with np.load(os.path.join(d, "ckpt_00000003.npz")) as z:
        nbytes = sum(z[k].nbytes for k in z.files)
    flush = {}
    for name, where in (("card", dev), ("cpu", "cpu")):
        mgr = CheckpointManager(os.path.join(TRAIN_ROOT, name),
                                sim=PFSSim(2, 4, device=where), hosts=[0, 1])
        t0 = time.perf_counter()
        flush[name] = (mgr.pfs_write(nbytes), time.perf_counter() - t0)
    rel = abs(flush["card"][0] - flush["cpu"][0]) / flush["cpu"][0]
    if not rel <= 1e-9:
        raise AssertionError(f"pfs_write: card {flush['card'][0]!r} vs CPU "
                             f"{flush['cpu'][0]!r} sim s")
    log(f"{card} | train resume ({TRAIN_ARCH} SMOKE, 6 steps vs 3 + a "
        f"checkpoint + 3 resumed, {secs:.3f} s): losses "
        f"{resumed['losses']} vs {full['losses'][3:]}, max |difference| "
        f"{diff.max():.3g}; pfs_write of the checkpoint's {nbytes} bytes: "
        f"flush {flush['card'][0]!r} sim s on the card ({flush['card'][1]:.3f}"
        f" s wall), {flush['cpu'][0]!r} on the CPU ({flush['cpu'][1]:.3f} s"
        f" wall), relative difference {rel:.3g}")
    return dict(seconds=secs, loss_diff=float(diff.max()), nbytes=nbytes,
                flush_sim_s=flush["card"][0], flush_wall_s=flush["card"][1],
                cpu_flush_wall_s=flush["cpu"][1])


def kernels_refuse_grad(dev) -> None:
    """Each LM kernel's wrapper raises on a CUDA input that requires a
    gradient (and launches nothing)."""
    import torch

    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_cuda
    from repro_torch.kernels.mamba_scan.kernel import selective_scan_cuda
    from repro_torch.kernels.rglru_scan.kernel import rglru_cuda

    t = lambda *s: torch.rand(s, device=dev, requires_grad=True)  # noqa: E731
    calls = {"flash_attention": lambda: flash_attention_cuda(
                 t(1, 2, 8, 16), t(1, 1, 8, 16), t(1, 1, 8, 16)),
             "rglru_scan": lambda: rglru_cuda(t(1, 8, 32), t(1, 8, 32)),
             "selective_scan": lambda: selective_scan_cuda(
                 t(1, 8, 32), t(1, 8, 32), -t(32, 8), t(1, 8, 8),
                 t(1, 8, 8), t(32))}
    for name, call in calls.items():
        before = LAUNCHES[name]
        try:
            call()
        except RuntimeError as e:
            if "gradient" not in str(e) or LAUNCHES[name] != before:
                raise
        else:
            raise AssertionError(f"{name}: a requires_grad input launched")


def continual_check(model, model_cpu, card: str) -> dict:
    """ROADMAP Queue 3's degraded_ost check: ``run_continual`` of it,
    frozen, for 10 intervals on the card and on the CPU, each with phase
    3's model on its own device.  Held: the card bit-equal to the CPU
    engine with the card's congestion ``pow`` (``pow_cr``'s plain
    version in place of numpy's ``power``).  Reported: the first interval
    where the card differs from the CPU as it runs (numpy's ``power``,
    the reference's, is SVML's on an AVX-512 host and rounds ~5% of
    values otherwise; no card kernel reproduces it)."""
    import torch

    from repro_torch.lab.continual import run_continual
    from repro_torch.lab.scenarios import get_scenario

    def run(dev, m):
        t0 = time.perf_counter()
        row = json.loads(json.dumps(run_continual(
            get_scenario(CHECK_SCENARIO), m, online=False, seconds=5.0,
            device=dev).row()))
        return row, time.perf_counter() - t0

    got, t_card = run(torch.device("cuda"), model)
    cpu, t_cpu = run("cpu", model_cpu)
    with cpu_pow_cr():
        cpu_cr, t_cpu_cr = run("cpu", model_cpu)
    if got != cpu_cr:
        first = {k: _first_diff(got[k], cpu_cr[k]) for k in got
                 if isinstance(got[k], list) and got[k] != cpu_cr[k]}
        raise AssertionError(f"continual {CHECK_SCENARIO}: the card differs "
                             f"from the CPU with the card's pow, first "
                             f"differing interval per field {first}")
    first_numpy = _first_diff(got["tput_mbs"], cpu["tput_mbs"])
    log(f"{card} | open check: run_continual({CHECK_SCENARIO}, frozen, 5 s = "
        f"{len(got['tput_mbs'])} intervals): card == CPU with the card's "
        f"pow (pow_cr's plain version) bit for bit; against the CPU as it "
        f"runs (numpy's power) "
        + ("identical" if first_numpy is None and got == cpu else
           f"first differing interval {first_numpy} (MB/s "
           f"{got['tput_mbs'][first_numpy]!r} vs "
           f"{cpu['tput_mbs'][first_numpy]!r})")
        + f"; card {t_card:.3f} s, CPU {t_cpu:.3f} s and {t_cpu_cr:.3f} s")
    return dict(card_s=t_card, cpu_s=t_cpu, intervals=len(got["tput_mbs"]),
                numpy_first_difference=first_numpy)


def train_phase(model, dev, kernels: list, card: str) -> None:
    """Phase 12, LM training with DIAL in its data path: gemma2-2b at full
    width, the smoke configs card vs CPU, resume, the kernels refusing
    gradients, and Queue 3's degraded_ost check.  The full-width run's
    launches go into the ``segment_sum``, ``pow_cr`` and paired-forest
    rows under a ``train`` path."""
    import torch

    from repro_torch.convert import forest_to_numpy, model_from_numpy
    from repro_torch.pfs.state import READ, WRITE

    t_phase = time.perf_counter()
    by_name = {k["name"]: k for k in kernels}
    model_cpu = model_from_numpy(*(forest_to_numpy(model.forest(op))
                                   for op in (READ, WRITE)), device="cpu")
    full = train_full(model, dev, card)
    full["breakdown"] = train_breakdown(full.pop("out"), dev, card)
    torch.cuda.empty_cache()
    for kname in ("segment_sum", "pow_cr", "paired_forest_margin"):
        add_path(by_name[kname], f"train {TRAIN_ARCH} full",
                 full["counts"].get(kname, 0))
    torch.cuda.empty_cache()
    smoke = train_card_vs_cpu(model, model_cpu, card)
    resume = train_resume(model, dev, card)
    kernels_refuse_grad(dev)
    log(f"{card} | the three LM kernels refuse requires_grad inputs")
    check = continual_check(model, model_cpu, card)
    for k in LM_KERNELS:
        by_name[k]["train_launches"] = full["counts"].get(k, 0)
    by_name["paired_forest_margin"]["train"] = dict(
        full={k: v for k, v in full.items() if k != "counts"},
        card_vs_cpu=smoke, resume=resume, continual_check=check,
        phase_s=time.perf_counter() - t_phase)
    log(f"{card} | phase 12: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------- #
# phase 13: the other seven families (MoE, codebooks, image prefix)
# ---------------------------------------------------------------------- #
FAMILY_ARCHS = ("olmoe-1b-7b", "qwen2-moe-a2.7b", "musicgen-large",
                "stablelm-12b", "starcoder2-15b", "qwen1.5-32b",
                "llava-next-34b")
MOE_ARCHS = ("olmoe-1b-7b", "qwen2-moe-a2.7b")
# batch 1 where batch 4 does not fit the card: qwen1.5-32b's 70.4 GB of
# bf16 weights and llava-next-34b's 68.8 GB leave no room for batch 4's
# caches (qwen1.5-32b's MHA cache alone 16.3 GB)
FAMILY_BATCH = {"qwen1.5-32b": 1, "llava-next-34b": 1}
MOE_LAYER_TOKENS = 512
# bf16 layer outputs, card vs the CPU's plain path: test_torch_lm.py's
# bar for bf16 states
BF16_ATOL, BF16_RTOL = 0.05, 0.02


def _moe_spy():
    """Record, without a host sync, each ``route`` call's token count and
    its kept and routed assignments; returns (records, undo)."""
    from repro_torch.models import moe

    records, route = [], moe.route

    def spy(xt, *a, **k):
        r = route(xt, *a, **k)
        records.append((xt.shape[0] * xt.shape[1], r["keep"].sum(),
                        r["keep"].numel()))
        return r

    moe.route = spy
    return records, lambda: setattr(moe, "route", route)


def family_serving(seed: int, dev, card: str) -> dict:
    """Full-config ``serve`` of each of the seven families, one at a time,
    launches counted per run; an MoE model's share of routed assignments
    dropped at prefill."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve

    runs = {}
    for arch in FAMILY_ARCHS:
        cfg = get_config(arch)
        b = FAMILY_BATCH.get(arch, SERVE["batch"])
        n = SERVE["gen_tokens"]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        records, undo = _moe_spy() if cfg.n_experts else ([], lambda: None)
        try:
            out, secs, counts = counted(lambda: serve(
                arch, smoke=False, seed=seed, device=dev, batch=b,
                prompt_len=SERVE["prompt_len"], gen_tokens=n))
        finally:
            undo()
        peak = torch.cuda.max_memory_allocated(dev)
        toks = out["tokens"]
        cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
        if toks.shape != (b, n) + cb or toks.min() < 0 \
                or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"serve {arch}: tokens malformed "
                                 f"{toks.shape}")
        for key in ("prefill_logits", "logits"):
            lg = out[key]
            if tuple(lg.shape) != (b, 1) + cb + (cfg.vocab_size,) \
                    or not bool(torch.isfinite(lg).all()):
                raise AssertionError(f"serve {arch}: {key} not finite or "
                                     "malformed")
        if counts.get("flash_attention", 0) <= 0:
            raise AssertionError(f"serve {arch} never launched "
                                 "flash_attention")
        prompt = b * SERVE["prompt_len"]
        drop, drop_by_layer = None, None
        if records:
            t_pre = b * (SERVE["prompt_len"] + cfg.img_tokens)
            pre = [(int(k), m) for t, k, m in records if t == t_pre]
            drop = 1.0 - sum(k for k, _ in pre) / sum(m for _, m in pre)
            drop_by_layer = [1.0 - k / m for k, m in pre]
        runs[arch] = dict(
            params=cfg.param_count(), layers=cfg.n_layers, batch=b,
            img_tokens=cfg.img_tokens, wall_s=secs,
            prefill_s=out["prefill_s"], decode_s=out["decode_s"],
            tok_per_s=out["tok_per_s"],
            ms_per_step=out["decode_s"] / (n - 1) * 1e3,
            peak_gib=peak / 2 ** 30, launches=counts,
            moe_prefill_drop_share=drop,
            moe_prefill_drop_by_layer=drop_by_layer,
            first_tokens=toks[0, :8].tolist())
        log(f"{card} | serve {arch} (full config: {cfg.n_layers} layers, "
            f"d_model {cfg.d_model}, {cfg.param_count() / 1e9:.2f} B params, "
            f"bf16): {b} x {SERVE['prompt_len']} prompt tokens"
            + (f" after {cfg.img_tokens} image positions"
               if cfg.img_tokens else "")
            + (f" x {cfg.num_codebooks} codebooks" if cb else "")
            + f", {n} greedy tokens each; prefill {out['prefill_s']:.3f} s "
            f"({prompt / out['prefill_s']:.0f} tok/s), decode "
            f"{out['decode_s']:.3f} s for {n - 1} steps "
            f"({out['tok_per_s']:.1f} tok/s, "
            f"{runs[arch]['ms_per_step']:.2f} ms/step); peak memory "
            f"{peak / 2 ** 30:.2f} GiB; logits finite; launches "
            + ", ".join(f"{k}={v}" for k, v in sorted(counts.items()))
            + (f"; routed assignments dropped at prefill {drop:.4%} (by "
               "layer " + ", ".join(f"{x:.1%}" for x in drop_by_layer) + ")"
               if drop is not None else "") + f"; {secs:.1f} s in all")
        del out
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def moe_layer_check(seed: int, dev, card: str) -> dict:
    """One full-width MoE layer of each MoE family at 1 x 512 tokens, bf16,
    on the card and through the CPU's plain path on the same weights and
    input: the tokens routed otherwise (near-ties of float32
    probabilities computed by two libraries), and every token of a group
    routed alike within the bf16 bar."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    out = {}
    for arch in MOE_ARCHS:
        cfg = get_config(arch)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        p = moe.init_moe(cfg, gen, dev, torch.bfloat16)
        if "shared_gate" in p:      # zeros at init: make the gate matter
            p["shared_gate"] = (torch.randn(cfg.d_model, generator=gen,
                                            device=dev) * 0.05).bfloat16()
        x = torch.randn((1, MOE_LAYER_TOKENS, cfg.d_model), generator=gen,
                        device=dev).bfloat16()
        t0 = time.perf_counter()
        with torch.inference_mode():
            got, aux = moe.moe_mlp(x, p, cfg)
            torch.cuda.synchronize()
            t_card = time.perf_counter() - t0
            pc = {k: (v.cpu() if torch.is_tensor(v) else
                      {kk: vv.cpu() for kk, vv in v.items()})
                  for k, v in p.items()}
            t0 = time.perf_counter()
            want, aux_cpu = moe.moe_mlp(x.cpu(), pc, cfg)
            t_cpu = time.perf_counter() - t0
            g = moe.n_groups(cfg, MOE_LAYER_TOKENS)
            tl = MOE_LAYER_TOKENS // g
            cap = int(moe.CAPACITY_FACTOR * cfg.top_k * tl
                      / cfg.n_experts) + 1
            routes = [moe.route(xx.reshape(g, tl, -1), pp["router"],
                                cfg.top_k, cfg.n_experts, cap)
                      for xx, pp in ((x, p), (x.cpu(), pc))]
        idx = [r["idx"].cpu() for r in routes]
        diff_tok = (idx[0] != idx[1]).any(-1)          # (g, tl)
        same_group = ~diff_tok.any(-1)                  # (g,)
        rows = same_group[:, None].expand(g, tl).reshape(-1)
        err = _close(got.cpu()[0][rows], want[0][rows], BF16_ATOL, BF16_RTOL)
        aux_err = abs(float(aux) - float(aux_cpu))
        if aux_err > 1e-3:
            raise AssertionError(f"MoE layer {arch}: aux {float(aux)} vs "
                                 f"{float(aux_cpu)}")
        out[arch] = dict(tokens=MOE_LAYER_TOKENS, groups=g, capacity=cap,
                         routed_otherwise=int(diff_tok.sum()),
                         groups_compared=int(same_group.sum()),
                         max_abs_err=err, aux_err=aux_err, card_s=t_card,
                         cpu_s=t_cpu)
        log(f"{card} | MoE layer {arch} (full width, bf16, 1 x "
            f"{MOE_LAYER_TOKENS} tokens, {g} groups, capacity {cap}): "
            f"{int(diff_tok.sum())} token(s) routed otherwise on the card "
            f"than on the CPU; the {int(same_group.sum())} groups routed "
            f"alike within |diff| {err:.3e} (bar {BF16_ATOL} + "
            f"{BF16_RTOL} |x|); aux {float(aux):.6f} vs {float(aux_cpu):.6f}"
            f"; card {t_card:.3f} s, CPU {t_cpu:.3f} s")
        del p, pc, got, want
        torch.cuda.empty_cache()
    return out


def _family_inputs(cfg, b, s, gen):
    """Tokens (B, S[, K]) and, for a VLM, float32 image embeddings."""
    import torch
    shape = (b, s) + ((cfg.num_codebooks,) if cfg.num_codebooks else ())
    tok = torch.randint(0, cfg.vocab_size, shape, generator=gen)
    img = (torch.randn((b, cfg.img_tokens, cfg.d_model), generator=gen)
           if cfg.family == "vlm" else None)
    return tok, img


def family_smoke_card_vs_cpu(card: str) -> dict:
    """The seven smoke configs in float32 on the card and the CPU from the
    same weights and inputs: ``generate``'s greedy tokens identical and
    logits within 1e-4; the loss and every gradient leaf (within 1e-4 of
    its largest |value|; an MoE backward sums with atomics on the card)
    and one AdamW step (parameters within 1e-4 of the largest |leaf|)."""
    import dataclasses as dc

    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm
    from repro_torch.train.optimizer import (AdamWConfig, init_opt_state,
                                             tree_leaves, tree_map)
    from repro_torch.train.steps import make_train_step

    dev = torch.device("cuda")
    out = {}
    for arch in FAMILY_ARCHS:
        cfg = dc.replace(get_smoke_config(arch), param_dtype="float32")
        gen = torch.Generator().manual_seed(0)
        params = lm.init_params(cfg, gen, "cpu")
        prompts, img = _family_inputs(cfg, 4, 48, gen)
        max_len = 64 + cfg.img_tokens
        res = {}
        for where in ("cpu", dev):
            res[str(where)] = generate(
                lm.to_device(params, where), prompts.to(where), cfg, 16,
                max_len, img_embeds=None if img is None else img.to(where))
        cpu, crd = res["cpu"], res[str(dev)]
        if not np.array_equal(crd["tokens"], cpu["tokens"]):
            raise AssertionError(f"smoke {arch}: greedy tokens differ, card "
                                 "vs CPU")
        lg_err = max(float((crd[k].cpu() - cpu[k]).abs().max())
                     for k in ("prefill_logits", "logits"))
        if not lg_err <= 1e-4:
            raise AssertionError(f"smoke {arch}: logits differ by {lg_err}")
        tok, timg = _family_inputs(cfg, 4, 64, torch.Generator().manual_seed(1))
        batch = {"tokens": tok, "labels": tok}
        if timg is not None:
            batch["img_embeds"] = timg
        ocfg = AdamWConfig(peak_lr=1e-2, min_lr=1e-3, warmup_steps=1,
                           total_steps=4, eps=TRAIN_SMOKE_EPS)
        tr = {}
        for where in ("cpu", dev):       # the step updates p in place
            p = tree_map(lambda t: t.to(where, copy=True), params)
            leaves = tree_leaves(p)
            for x in leaves:
                x.requires_grad_(True)
            b = {k: v.to(where) for k, v in batch.items()}
            loss = lm.loss_fn(p, b, cfg, seq_chunk=32)
            grads = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
            for x in leaves:
                x.requires_grad_(False)
            p, _, m = make_train_step(cfg, ocfg)(p, init_opt_state(p), b)
            tr[str(where)] = (float(loss.detach()), grads, float(m["loss"]),
                              [x.cpu() for x in tree_leaves(p)])
        (lc, gc_, mc, pc), (lg, gg, mg, pg) = tr["cpu"], tr[str(dev)]
        grad_rel = max(float((a - b_).abs().max())
                       / max(float(b_.abs().max()), 1e-30)
                       for a, b_ in zip(gg, gc_))
        scale = max(float(b_.abs().max()) for b_ in pc)
        param_rel = max(float((a - b_).abs().max()) for a, b_ in zip(pg, pc)) \
            / scale
        loss_rel = abs(lg - lc) / abs(lc)
        if not (loss_rel <= 1e-4 and grad_rel <= 1e-4 and param_rel <= 1e-4
                and abs(mg - mc) / abs(mc) <= 1e-4):
            raise AssertionError(f"train card vs CPU ({arch}): loss "
                                 f"{lg} vs {lc}, gradients {grad_rel}, "
                                 f"parameters {param_rel}")
        out[arch] = dict(logits_err=lg_err, loss_rel=loss_rel,
                         grad_rel=grad_rel, param_rel=param_rel)
        log(f"{card} | smoke {arch} (float32) card == CPU: 4 x 16 greedy "
            f"tokens identical, logits within {lg_err:.3e}; loss "
            f"{lg:.6f} vs {lc:.6f} (relative {loss_rel:.3g}), gradients "
            f"within {grad_rel:.3g} of a leaf's largest |value|, one AdamW "
            f"step's parameters within {param_rel:.3g} of the largest |leaf|")
    return out


def family_phase(seed: int, dev, kernels: list, card: str) -> None:
    """Phase 13, the seven other families: full-width serving, a device
    breakdown of olmoe-1b-7b and stablelm-12b, one full-width MoE layer
    card vs CPU, the smoke configs card vs CPU (serving and training), an
    MoE smoke config served twice.  Launches go into the attention row
    under each family's path."""
    import gc

    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{card} | phase 13 starts with "
        f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.2f} GiB allocated")
    runs = family_serving(seed, dev, card)
    by_name = {k["name"]: k for k in kernels}
    attn = by_name["flash_attention"]
    for arch, r in runs.items():
        add_path(attn, f"serve {arch}", r["launches"].get("flash_attention",
                                                          0))
    breakdown = {a: serving_breakdown(a, seed, dev)
                 for a in ("olmoe-1b-7b", "stablelm-12b")}
    torch.cuda.empty_cache()
    layers = moe_layer_check(seed, dev, card)
    smoke = family_smoke_card_vs_cpu(card)
    repeat = {}
    for arch in MOE_ARCHS:
        cfg = get_smoke_config(arch)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = lm.init_params(cfg, gen, dev)
        prompts = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen,
                                device=dev)
        a, b = (generate(params, prompts, cfg, 16, 80) for _ in range(2))
        if not (np.array_equal(a["tokens"], b["tokens"])
                and torch.equal(a["logits"], b["logits"])):
            raise AssertionError(f"{arch} smoke on the card: two runs differ")
        repeat[arch] = True
        log(f"{card} | {arch} smoke (bf16) served twice on the card: tokens "
            "and logits bit-equal")
    attn["families"] = dict(serve=runs, breakdown=breakdown, moe_layer=layers,
                            smoke_card_vs_cpu=smoke, moe_repeat=repeat,
                            phase_s=time.perf_counter() - t_phase)
    log(f"{card} | phase 13: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------- #
# phase 14: the LM over a mesh (DTensor over NCCL, one process a card)
# ---------------------------------------------------------------------- #
MESH_ARCH = "gemma2-2b"
MESH_RUN = dict(steps=2, batch=4, seq_len=2048)     # phase 12's shape
# warmup 1: the lr is at its peak from the first step, so the two steps'
# updates are large enough for bf16 parameters to show them
MESH_OPT = dict(warmup_steps=1, total_steps=2)
# the sharded step against the one-card step, bf16, with bars a fault
# cannot pass.  The loss within MESH_LOSS_BAR absolute (the plain loss
# moves ~1.1e-2 from step 1 to step 2, so a step that updates nothing
# fails it) and the grad norm within MESH_NORM_BAR relative.  Each
# gradient leaf of the first batch within MESH_GRAD_BAR of its norm (a
# leaf left partial over two data ranks, or a half batch, is ~0.5 off).
# The parameters after the last step within MESH_UPDATE_BAR of the plain
# run's own update, in norm: Adam moves an element by about lr in its
# gradient's sign, so two runs part only where that sign flips, while no
# update, or one from another gradient, is ~1 off.  On one card (a 1 x 1
# mesh, every placement trivial) every gradient leaf is bit-equal
MESH_LOSS_BAR = 2e-3
MESH_NORM_BAR = 5e-3
MESH_GRAD_BAR = 0.1
MESH_UPDATE_BAR = 0.5
MESH_REPS = 5                              # timed reductions per mode


def mesh_shape(n: int) -> tuple:
    """(data, model) of the mesh over ``n`` cards: 2-way tensor parallel
    from 4 cards up, data parallel over the rest."""
    m = 2 if n >= 4 and n % 2 == 0 else 1
    return n // m, m


def _mesh_rank(rank: int, world: int, job: dict) -> None:
    """One rank of phase 14: its card, NCCL, the work, rank 0's result."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import end_run_on_error

    torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl", init_method=job["init"], rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=600),
        device_id=torch.device("cuda", rank))
    with end_run_on_error(rank):
        res = _mesh_work(rank, job)
        if rank == 0:
            with open(job["out"], "w") as f:
                json.dump(res, f)


def _sync_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _mesh_train(cfg, params, state, batches) -> tuple:
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.steps import make_train_step

    step = make_train_step(cfg, AdamWConfig(**MESH_OPT))
    recs = []
    for batch in batches:
        (params, state, m), ms = _sync_ms(lambda b=batch: step(
            params, state, b))
        recs.append(dict(loss=float(m["loss"]),
                         grad_norm=float(m["grad_norm"]), step_ms=ms))
    return params, state, recs


def _grads(cfg, params, batch) -> list:
    """The loss's gradients at ``params`` (plain tensors or DTensors) on
    ``batch``, in ``tree_leaves`` order."""
    import torch

    from repro_torch.models import lm
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.steps import _on_mesh

    leaves = tree_leaves(params)
    with _on_mesh(leaves[0]), torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        try:
            return list(torch.autograd.grad(lm.loss_fn(params, batch, cfg),
                                            leaves))
        finally:
            for p in leaves:
                p.requires_grad_(False)


def _leaf_names(tree, path=()) -> list:
    """The parameter tree's leaf paths in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k],
                                                             path + (k,))]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, path + (str(i),))]
    return ["/".join(path)]


def _mesh_work(rank: int, job: dict) -> dict:
    """Phase 14's work on one rank (see :func:`mesh_phase`)."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.ckpt.manager import CheckpointManager, reshard_checkpoint
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.compression import (init_error_bufs,
                                                     make_dp_train_grads,
                                                     wire_bytes)
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import lm
    from repro_torch.train.optimizer import (AdamWConfig, init_opt_state,
                                             tree_leaves)

    dev = torch.device("cuda", rank)
    cfg = (get_smoke_config if job["smoke"] else get_config)(job["arch"])
    n_data, n_model = job["shape"]
    mesh = make_test_mesh(n_data, n_model)
    world = n_data * n_model
    gib = 2 ** 30

    def fresh():
        return lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
            job["seed"]), dev)
    gen = torch.Generator(device=dev).manual_seed(job["seed"] + 1)
    tokens = [torch.randint(0, cfg.vocab_size, (job["batch"], job["seq_len"]),
                            generator=gen, device=dev)
              for _ in range(job["steps"])]
    res = dict(shape=[n_data, n_model], world=world)

    def gathered(x):
        out = [None] * world
        dist.all_gather_object(out, x)
        return out

    parts = res["part_s"] = {}
    t_part = time.perf_counter()

    def part(name):
        nonlocal t_part
        parts[name] = time.perf_counter() - t_part
        t_part = time.perf_counter()

    names = _leaf_names(lm.abstract_params(cfg))

    # 1. the same two steps unsharded on card 0, after the first batch's
    #    gradients (kept on the host) and before the update's size
    if rank == 0:
        params = fresh()
        plain_g = [g.cpu() for g in _grads(
            cfg, params, {"tokens": tokens[0], "labels": tokens[0]})]
        torch.cuda.reset_peak_memory_stats(dev)
        params, state, recs = _mesh_train(
            cfg, params, init_opt_state(params),
            [{"tokens": t, "labels": t} for t in tokens])
        res["plain"] = dict(
            steps=recs, peak_gib=torch.cuda.max_memory_allocated(dev) / gib)
        del state
        moved = [float(((p.float() - q.float()) ** 2).sum()) for p, q in
                 zip(tree_leaves(params), tree_leaves(fresh()))]
        plain = [p.cpu() for p in tree_leaves(params)]
        del params
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    part("plain")

    # 2. the sharded steps: params by param_pspecs, moments by ZeRO-1, the
    #    batch over the data axes; first the first batch's gradients,
    #    leaf by leaf against the plain ones on card 0
    LAUNCHES.clear()
    params = fresh()
    specs = shd.validate_pspecs(shd.param_pspecs(params), params, mesh)
    params = shd.distribute(params, mesh, specs)
    zspecs = shd.validate_pspecs(shd.zero1_pspecs(params, specs, mesh),
                                 params, mesh)
    state = init_opt_state(params, zspecs)
    bspec = shd.P(*shd.batch_pspec(mesh), None)
    batches = [shd.distribute({"tokens": t, "labels": t}, mesh,
                              {"tokens": bspec, "labels": bspec})
               for t in tokens]
    rel, n_equal = [], 0
    for a in _grads(cfg, params, batches[0]):
        a = a.full_tensor()
        if rank == 0:
            b = plain_g[len(rel)].to(dev)
            n_equal += bool(torch.equal(a, b))
            norm = float(torch.linalg.vector_norm(b.float()))
            rel.append(float(torch.linalg.vector_norm(
                a.float() - b.float())) / max(norm, 1e-30))
        del a
    if rank == 0:
        del plain_g, b
        res["grads"] = dict(
            bit_equal=n_equal, n_leaves=len(rel), worst=max(rel),
            most=sorted(zip(rel, names), reverse=True)[:4])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params, state, recs = _mesh_train(cfg, params, state, batches)
    peak = gathered(torch.cuda.max_memory_allocated(dev) / gib)
    res["sharded"] = dict(steps=recs, peak_gib=peak, launches=dict(LAUNCHES))
    n_moment = sum(1 for s in shd.spec_leaves(zspecs)
                   if any(a is not None and "data" in (a if isinstance(
                       a, tuple) else (a,)) for a in s))
    res["sharded"]["moments_data_sharded"] = n_moment
    full = [p.full_tensor() for p in tree_leaves(params)]
    if rank == 0:                     # leaf by leaf on the card
        err, n_off, n_all, n_equal, apart = 0.0, 0, 0, 0, []
        for a, b in zip(full, plain):
            b = b.to(dev)
            d = (a.float() - b.float()).abs()
            err = max(err, float(d.max()))
            n_off += int((d > 0).sum())
            n_all += d.numel()
            n_equal += bool(torch.equal(a, b))
            apart.append(float((d ** 2).sum()))
            del b, d
        res["params"] = dict(
            abs_err=err, err_in_lr=err / AdamWConfig(**MESH_OPT).peak_lr,
            share_off=n_off / n_all, bit_equal=n_equal, n_leaves=len(plain),
            over_update=(sum(apart) / sum(moved)) ** 0.5,
            most=sorted(((x / max(m, 1e-30)) ** 0.5, n) for x, m, n in zip(
                apart, moved, names))[-4:][::-1])
        del plain
    del full, state, batches
    gc.collect()
    torch.cuda.empty_cache()
    part("sharded")

    # 3. a save under the mesh, restored and re-placed on the transpose
    ck = CheckpointManager(job["ckpt"], keep=1, cfg=cfg)
    _, res["save_ms"] = _sync_ms(lambda: ck.save(2, params,
                                                through_pfs=False))
    restored, res["restore_ms"] = _sync_ms(
        lambda: ck.restore(2, params)[0])
    tmesh = make_test_mesh(n_model, n_data) if (n_model, n_data) != (
        n_data, n_model) else mesh
    tspecs = shd.validate_pspecs(shd.param_pspecs(restored), restored, tmesh)
    moved = reshard_checkpoint(restored, tmesh, tspecs)
    equal = all(torch.equal(a.full_tensor(), b.full_tensor())
                for a, b in zip(tree_leaves(moved), tree_leaves(params)))
    res["remesh"] = dict(onto=list(tmesh.shape), bit_equal=all(
        gathered(equal)))
    del moved, restored, params
    gc.collect()
    torch.cuda.empty_cache()
    part("checkpoint")

    # 4. pure DP over the data axis: EF-int8 compressed and plain
    params = fresh()
    loss_fn = lambda p, b: lm.loss_fn(p, b, cfg)          # noqa: E731
    batch = {"tokens": tokens[0], "labels": tokens[0]}
    group = mesh.get_group("data")
    dp = {}
    for compress in (True, False):
        fn = make_dp_train_grads(loss_fn, mesh, compress=compress)
        bufs = init_error_bufs(params, n_data, mesh) if compress else None
        (loss, grads, _), ms = _sync_ms(lambda: fn(params, batch, bufs))
        dp[compress] = dict(loss=float(loss), grads_fn_ms=ms,
                            wire_bytes=wire_bytes(grads, compress))
        del grads, bufs
    grads = [torch.randn(p.shape, generator=gen, device=dev).to(p.dtype)
             for p in tree_leaves(params)]
    from repro_torch.distributed.compression import compressed_psum

    bufs = [torch.zeros(g.shape, dtype=torch.float32, device=dev)
            for g in grads]

    def plain_reduce():
        for g in grads:
            t = g.clone()
            dist.all_reduce(t, group=group)
            t.div_(n_data)

    for compress, fn in ((True, lambda: compressed_psum(grads, bufs, group)),
                         (False, plain_reduce)):
        fn()
        times = [_sync_ms(fn)[1] for _ in range(MESH_REPS)]
        dp[compress]["reduce_ms"] = times
    res["dp"] = {("compressed" if k else "plain"): v for k, v in dp.items()}
    res["launches_total"] = dict(LAUNCHES)
    part("dp")
    return res


def run_mesh(build: str, seed: int, *, arch: str = MESH_ARCH,
             smoke: bool = False, **run) -> dict:
    """Phase 14's work (:func:`_mesh_work`) on every visible card, one
    process each; rank 0's result.  ``run`` overrides :data:`MESH_RUN`.
    A failed rank raises here."""
    import shutil

    import torch
    import torch.multiprocessing as mp

    world = torch.cuda.device_count()
    shutil.rmtree(build, ignore_errors=True)
    os.makedirs(build)
    job = dict(MESH_RUN, **run, seed=seed, arch=arch, smoke=smoke,
               shape=list(mesh_shape(world)),
               init="file://" + os.path.join(build, "init"),
               out=os.path.join(build, "result.json"),
               ckpt=os.path.join(build, "ckpt"))
    try:
        mp.spawn(_mesh_rank, args=(world, job), nprocs=world, join=True)
        with open(job["out"]) as f:
            return json.load(f)
    finally:
        shutil.rmtree(job["ckpt"], ignore_errors=True)


def check_mesh(res: dict, card: str, what: str) -> None:
    """Log :func:`run_mesh`'s result, then hold it to the bars above."""
    shape = "x".join(map(str, res["shape"]))
    plain, sh, gr, pa = res["plain"], res["sharded"], res["grads"], \
        res["params"]
    head = f"{card} | mesh {shape} ({res['world']} card(s)) {what}"
    faults = []
    for i, (a, b) in enumerate(zip(plain["steps"], sh["steps"])):
        log(f"{head} step {i + 1}: loss {b['loss']:.6f} (one card "
            f"{a['loss']:.6f}, {abs(b['loss'] - a['loss']):.3g} apart), grad "
            f"norm {b['grad_norm']:.6f} (one card {a['grad_norm']:.6f}, "
            f"{abs(b['grad_norm'] / a['grad_norm'] - 1):.3g} relative), step "
            f"{b['step_ms']:.1f} ms (one card {a['step_ms']:.1f} ms)")
        if not (abs(b["loss"] - a["loss"]) <= MESH_LOSS_BAR and abs(
                b["grad_norm"] - a["grad_norm"]) <= MESH_NORM_BAR * abs(
                    a["grad_norm"])):
            faults.append(f"step {i + 1}'s loss or grad norm")
    log(f"{head}: first-batch gradients {gr['bit_equal']} of "
        f"{gr['n_leaves']} leaves bit-equal, worst leaf {gr['worst']:.3g} "
        "of its norm apart; most: " + "; ".join(
            f"{n} {r:.3g}" for r, n in gr["most"]))
    if not gr["worst"] <= MESH_GRAD_BAR:
        faults.append("a gradient leaf")
    if res["world"] == 1 and gr["bit_equal"] != gr["n_leaves"]:
        faults.append("a gradient leaf on the 1 x 1 mesh")
    log(f"{head}: parameters after the last step {pa['over_update']:.3g} "
        f"of the plain update apart (most: " + "; ".join(
            f"{n} {r:.3g}" for r, n in pa["most"])
        + f"); at most {pa['abs_err']:.3g} ({pa['err_in_lr']:.2f} lr); "
        f"{pa['share_off']:.3%} of elements differ, {pa['bit_equal']} of "
        f"{pa['n_leaves']} leaves bit-equal; peak GiB per card "
        + ", ".join(f"{g:.2f}" for g in sh["peak_gib"])
        + f" (one card unsharded {plain['peak_gib']:.2f}); "
        f"{sh['moments_data_sharded']} moment leaves sharded over data")
    if not pa["over_update"] <= MESH_UPDATE_BAR:
        faults.append("the parameters")
    log(f"{head}: seconds by part (rank 0) "
        + ", ".join(f"{k} {v:.1f}" for k, v in res["part_s"].items()))
    log(f"{head}: save under the mesh {res['save_ms']:.0f} ms, restore "
        f"{res['restore_ms']:.0f} ms, re-placed on "
        f"{'x'.join(map(str, res['remesh']['onto']))} "
        f"bit-equal {res['remesh']['bit_equal']}")
    if not res["remesh"]["bit_equal"]:
        faults.append("the checkpoint re-placed on the transposed mesh")
    for mode, d in res["dp"].items():
        log(f"{head}: DP grads over data ({mode}): loss {d['loss']:.6f}, "
            f"grads_fn {d['grads_fn_ms']:.1f} ms, wire bytes "
            f"{d['wire_bytes']:.6g} (analytic), reduction ms "
            + ", ".join(f"{t:.2f}" for t in d["reduce_ms"])
            + (" (int32 carrier)" if mode == "compressed" else ""))
    faults += [f"{k} launched on the training path" for k in LM_KERNELS
               if res["launches_total"].get(k, 0)]
    if faults:
        raise AssertionError(f"mesh {shape} {what}: " + ", ".join(faults)
                             + " off the one-card step")


def mesh_phase(seed: int, kernels: list, card: str) -> dict:
    """Phase 14, the LM over a mesh, one process per visible card (NCCL,
    ``torch.cuda.set_device(rank)`` before init; one card is a 1 x 1
    mesh, still through DTensor and NCCL): gemma2-2b at its full config
    on phase 12's shape, two sharded train steps (parameters by
    ``param_pspecs``, moments by ZeRO-1, the batch over the data axes)
    against the same two steps unsharded on card 0 -- loss, grad norm,
    the first batch's gradients and the parameters within the bars
    (:data:`MESH_GRAD_BAR` and its neighbours) -- with each card's peak
    GiB and the step ms; a save under the mesh restored and re-placed on
    the transposed mesh, bit-equal; ``make_dp_train_grads`` over the
    data axis compressed and plain, their ``wire_bytes`` and the
    reductions' ms.  No kernel launches on this path (training runs the
    plain forms): the counters, zeroed before the sharded steps, are
    read after the phase's last run."""
    t_phase = time.perf_counter()
    res = run_mesh(os.path.join(ROOT, "build", "mesh"), seed)
    check_mesh(res, card, f"{MESH_ARCH} full")
    by_name = {k["name"]: k for k in kernels}
    for k in LM_KERNELS:
        by_name[k]["mesh_launches"] = res["launches_total"].get(k, 0)
    res["phase_s"] = time.perf_counter() - t_phase
    by_name["flash_attention"]["mesh"] = res
    log(f"{card} | phase 14: {res['phase_s']:.1f} s")
    return res


# ---------------------------------------------------------------------- #
# phase 15: sharded serving (DTensor over NCCL, one process a card) and
# the roofline dry-run on the production mesh (a CPU child)
# ---------------------------------------------------------------------- #
DRYRUN_ARCH = "gemma2-2b"
DRYRUN_OUT = os.path.join(ROOT, "build", "dryrun")
DRYRUN_TIMEOUT_S = 900
DRYRUN_KEYS = ("flops_per_chip", "hbm_bytes_per_chip", "collective_counts",
               "collective_bytes_by_kind", "wire_bytes_per_chip",
               "torch_flops_raw", "argument_bytes_per_chip", "trace_s",
               "roofline")


def start_dryrun():
    """``launch/dryrun.py`` for gemma2-2b's four shapes on both
    production meshes at its full config, in a CPU child (no card
    visible; two cells at a time), its log and records under
    ``build/dryrun/``; phase 15 waits for it.  The child and its workers
    are held to the last two of this process's cores (where it has four
    or more), so the phases' host work keeps the others."""
    import shutil

    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    os.makedirs(DRYRUN_OUT)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    log_f = open(os.path.join(DRYRUN_OUT, "dryrun.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         DRYRUN_ARCH, "--both-meshes", "--jobs", "2", "--out", DRYRUN_OUT],
        env=env, stdout=log_f, stderr=subprocess.STDOUT, cwd=ROOT,
        start_new_session=True)      # its workers die with it: stop_dryrun
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) >= 4:              # before the child spawns its workers
        os.sched_setaffinity(proc.pid, cores[-2:])
    proc.cores = cores[-2:] if len(cores) >= 4 else cores
    proc.t0 = time.perf_counter()
    return proc


def stop_dryrun(proc) -> None:
    """Kill the dry-run child and its worker processes, if still running."""
    import signal

    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def finish_dryrun(proc, card: str) -> dict:
    """Wait for :func:`start_dryrun`'s child; every cell's record whole."""
    from repro_torch.configs.shapes import applicable_shapes

    t_wait = time.perf_counter()
    try:
        rc = proc.wait(timeout=DRYRUN_TIMEOUT_S)
    finally:
        stop_dryrun(proc)
    wall = time.perf_counter() - proc.t0
    wait_s = time.perf_counter() - t_wait
    with open(os.path.join(DRYRUN_OUT, "dryrun.log")) as f:
        text = f.read()
    if rc != 0:
        raise AssertionError(f"dry-run exited {rc}: {text[-3000:]}")
    recs = {}
    for shape in applicable_shapes(DRYRUN_ARCH):
        for tag in ("pod", "multipod"):
            with open(os.path.join(DRYRUN_OUT, f"{DRYRUN_ARCH}__{shape}__"
                                   f"{tag}.json")) as f:
                rec = json.load(f)
            missing = [k for k in DRYRUN_KEYS if k not in rec]
            if missing:
                raise AssertionError(f"dry-run {shape} {tag}: no {missing}")
            r = rec["roofline"]
            log(f"dry-run {DRYRUN_ARCH} {shape} {tag} ({rec['chips']} ranks, "
                f"CPU, fake group): trace {rec['trace_s']:.1f} s; per rank "
                f"{rec['flops_per_chip']:.4g} FLOPs, "
                f"{rec['hbm_bytes_per_chip']:.4g} HBM bytes, "
                f"{rec['wire_bytes_per_chip']:.4g} wire bytes "
                f"({rec['collective_counts']}); at the H100 SXM peaks "
                f"compute {r['compute_s']:.4g} s, memory {r['memory_s']:.4g} "
                f"s, collective {r['collective_s']:.4g} s: {r['dominant']}")
            recs[f"{shape}__{tag}"] = rec
    log(f"{card} | dry-run child: {len(recs)} cells in {wall:.1f} s (wall, "
        f"beside the card's phases, on cores {proc.cores}; phase 15 waited "
        f"{wait_s:.1f} s for it)")
    return dict(wall_s=wall, wait_s=wait_s, cells=recs)


def _serve_mesh_rank(rank: int, world: int, job: dict) -> None:
    """One rank of phase 15: its card, NCCL, the three serves."""
    import datetime
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.mesh import end_run_on_error, make_test_mesh
    from repro_torch.launch.serve import serve

    torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl", init_method=job["init"], rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=600),
        device_id=torch.device("cuda", rank))
    with end_run_on_error(rank):
        dev = torch.device("cuda", rank)
        mesh = make_test_mesh(*job["shape"])
        res = {}
        for arch in job["archs"]:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            torch.cuda.synchronize()
            LAUNCHES.clear()
            t0 = time.perf_counter()
            out = serve(arch, smoke=False, seed=job["seed"], device=dev,
                        mesh=mesh, **SERVE)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(LAUNCHES)
            peak = [None] * world
            dist.all_gather_object(
                peak, torch.cuda.max_memory_allocated(dev) / 2 ** 30)
            res[arch] = dict(prefill_s=out["prefill_s"],
                             decode_s=out["decode_s"], wall_s=wall,
                             peak_gib=peak, launches=counts)
            if rank == 0:
                torch.save(dict(tokens=out["tokens"],
                                prefill_logits=out["prefill_logits"].cpu(),
                                logits=out["logits"].cpu()),
                           os.path.join(job["dir"], f"{arch}.pt"))
            del out
        if rank == 0:
            with open(job["out"], "w") as f:
                json.dump(res, f)


def run_serve_mesh(build: str, seed: int, archs=SERVE_ARCHS) -> tuple:
    """Phase 15's serves on every visible card, one process each; rank
    0's result and its outputs by arch (tokens, prefill and last logits).
    A failed rank raises here."""
    import shutil

    import torch
    import torch.multiprocessing as mp

    world = torch.cuda.device_count()
    shutil.rmtree(build, ignore_errors=True)
    os.makedirs(build)
    job = dict(seed=seed, archs=list(archs), shape=list(mesh_shape(world)),
               dir=build, init="file://" + os.path.join(build, "init"),
               out=os.path.join(build, "result.json"))
    mp.spawn(_serve_mesh_rank, args=(world, job), nprocs=world, join=True)
    with open(job["out"]) as f:
        res = json.load(f)
    outs = {a: torch.load(os.path.join(build, f"{a}.pt"), weights_only=False)
            for a in archs}
    return res, outs, mesh_shape(world)


# the four-card check (tests/test_torch_cuda.py): (arch, mesh, batch,
# prompt tokens, cache positions), each served in bf16 and, from the same
# weights upcast, in float32; batch 1 on 4 x 1 shards the cache's
# sequence over 'data'
_N = SERVE["prompt_len"] + SERVE["gen_tokens"]
SERVE_COMPARE = [(a, m, SERVE["batch"], SERVE["prompt_len"], _N)
                 for a in SERVE_ARCHS for m in ((2, 2), (1, 4))] + [
    ("gemma2-2b", (4, 1), 1, 32768 - SERVE["gen_tokens"], 32768)]
# logits compared per run: the prefill's and 8 decode steps'
COMPARE_STEPS = 9
# a float32 serve over the mesh against one card: each logit row within
# this share of its RMS (the sums' order differs, nothing else)
F32_ROW_REL = 1e-3


def _greedy_steps(params, prompts, cfg, max_len: int, n: int,
                  feed=None) -> list:
    """Prefill and ``n - 1`` greedy decode steps through the (sharded)
    steps -- or fed ``feed``'s tokens (step t's (B, 1) tokens) instead of
    its own; every step's logits, whole, float32 on the host."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.constrain import full, is_dtensor
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    prefill, decode = make_prefill_step(cfg, max_len), make_decode_step(cfg)
    logits, cache = prefill(params, prompts)
    out = [full(logits).cpu()]
    for i in range(n - 1):
        if feed is None:
            tok = logits.argmax(dim=-1)
        elif is_dtensor(prompts):     # laid out as the prompts are
            tok = distribute_tensor(feed[i].to(prompts.to_local().device),
                                    prompts.device_mesh, prompts.placements)
        else:
            tok = feed[i].to(prompts.device)
        logits, cache = decode(params, tok, cache, prompts.shape[1] + i)
        out.append(full(logits).cpu())
    del cache
    torch.cuda.empty_cache()
    return out


def _compare_inputs(arch: str, b: int, s: int, seed: int, dev, dtype: str):
    """bf16 weights and prompts from ``seed`` on ``dev`` (the same on
    every rank); for float32 the same weights upcast."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config(arch), param_dtype="bfloat16")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = lm.init_params(cfg, gen, dev)
    prompts = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                            device=dev)
    if dtype == "float32":
        params = _tree_float(params)
        cfg = dataclasses.replace(cfg, param_dtype="float32")
    return params, prompts, cfg


def _serve_compare_rank(rank: int, world: int, job: dict) -> None:
    """One rank of the four-card check.  Per (arch, batch, prompt) card 0
    alone serves greedily in bf16, then in float32 from the same weights
    upcast, fed the bf16 run's tokens; per case the mesh serves in both
    dtypes, fed the same tokens, so every step's logits of all four runs
    follow one token sequence.  Rank 0 saves the logits."""
    import datetime
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.mesh import end_run_on_error, make_test_mesh
    from repro_torch.launch.serve import place_on_mesh

    torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl", init_method=job["init"], rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=900),
        device_id=torch.device("cuda", rank))
    dev = torch.device("cuda", rank)
    n, seed = job["steps"], job["seed"]
    with end_run_on_error(rank):
        for i, (arch, shape, b, s, max_len) in enumerate(job["cases"]):
            one = os.path.join(job["dir"], f"one_{arch}_{b}x{s}.pt")
            t0 = time.perf_counter()
            if rank == 0 and not os.path.exists(one):
                with torch.no_grad():
                    params, prompts, cfg = _compare_inputs(
                        arch, b, s, seed, dev, "bfloat16")
                    lg = _greedy_steps(params, prompts, cfg, max_len, n)
                    feed = [t.argmax(-1) for t in lg[:-1]]
                    del params
                    params, prompts, cfg = _compare_inputs(
                        arch, b, s, seed, dev, "float32")
                    lg32 = _greedy_steps(params, prompts, cfg, max_len, n,
                                         feed=feed)
                torch.save(dict(bfloat16=lg, float32=lg32, feed=feed), one)
                del params, prompts, lg, lg32
                gc.collect()
                torch.cuda.empty_cache()
                log(f"rank 0: case {i} ({arch}, batch {b}, {s} prompt "
                    f"tokens) on one card, bf16 and float32: "
                    f"{time.perf_counter() - t0:.1f} s")
            dist.barrier()
            feed = torch.load(one)["feed"]
            mesh = make_test_mesh(*shape)
            res = {}
            for dt in ("bfloat16", "float32"):
                params, prompts, cfg = _compare_inputs(arch, b, s, seed, dev,
                                                       dt)
                params, prompts, _ = place_on_mesh(params, prompts, None,
                                                   mesh)
                LAUNCHES.clear()
                t0 = time.perf_counter()
                with torch.no_grad():
                    res[dt] = _greedy_steps(params, prompts, cfg, max_len, n,
                                            feed=feed)
                log(f"rank {rank}: case {i} ({arch}, "
                    f"{'x'.join(map(str, shape))}) {dt} on the mesh: "
                    f"{time.perf_counter() - t0:.1f} s; launches "
                    + (", ".join(f"{k}={v}" for k, v in LAUNCHES.items())
                       or "none"))
                del params, prompts
                gc.collect()
                torch.cuda.empty_cache()
            if rank == 0:
                torch.save(res, os.path.join(job["dir"], f"case{i}.pt"))
            del res
            dist.barrier()


def _tree_float(tree):
    if isinstance(tree, dict):
        return {k: _tree_float(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_float(v) for v in tree]
    return tree.float()


def _row_rel(a, w, b: int) -> float:
    """The worst row's max |a - w| over w's RMS."""
    a, w = a.reshape(b, -1), w.reshape(b, -1)
    rms = w.square().mean(-1).sqrt()
    return float(((a - w).abs().amax(-1) / rms).max())


def _compare_steps(mesh: list, one: list, b: int, bars: list) -> dict:
    """Every step's worst logit row over its RMS against the step's bar,
    and the greedy tokens: a row's argmax may differ from one card's
    only where one card's top two lie within that bar of its RMS (a near
    tie: moving each logit by less than half the bar can swap them)."""
    import torch

    rels, over, ties, flips = [], [], [], []
    for t, (a, w) in enumerate(zip(mesh, one)):
        rels.append(_row_rel(a, w, b))
        if rels[-1] > bars[t]:
            over.append(t)
        ww = w.reshape(b, -1)
        rms = ww.square().mean(-1).sqrt()
        top = ww.topk(2, dim=-1).values
        tie = top[:, 0] - top[:, 1] <= bars[t] * rms
        if bool(tie.any()):
            ties.append(t)
        differ = a.reshape(b, -1).argmax(-1) != ww.argmax(-1)
        if bool((differ & ~tie).any()):
            flips.append(t)
    return dict(row_rel_by_step=rels, worst_row_rel=max(rels),
                steps_over_bar=over, near_tie_steps=ties,
                first_near_tie=ties[0] if ties else None,
                flips_without_tie=flips)


def run_serve_compare(build: str, seed: int, cases=None) -> list:
    """The full-width serves of :data:`SERVE_COMPARE` (or ``cases``) on
    four cards against card 0 alone, :data:`COMPARE_STEPS` steps each,
    every run fed one card's bf16 greedy tokens, so that every step is
    compared.  float32: each logit row within :data:`F32_ROW_REL` of its
    RMS.  bf16: within :data:`BF16_ROW_REL`, or twice one card's own
    bf16-vs-float32 distance at that step (the ``floor``) where bf16's
    rounding alone moves one card further than that.  The greedy tokens
    identical at every step but where one card's top two lie within the
    step's bar (a near tie); the first such step is reported.  Logs
    every case, then raises past the bars."""
    import shutil

    import torch
    import torch.multiprocessing as mp

    cases = cases or SERVE_COMPARE
    build = os.path.abspath(build)
    shutil.rmtree(build, ignore_errors=True)
    os.makedirs(build)
    job = dict(seed=seed, cases=[list(c) for c in cases], dir=build,
               steps=COMPARE_STEPS,
               init="file://" + os.path.join(build, "init"))
    log("four-card check on: " + "; ".join(nvidia_smi().splitlines()))
    t0 = time.perf_counter()
    mp.spawn(_serve_compare_rank, args=(4, job), nprocs=4, join=True)
    log(f"four-card check: {len(cases)} cases served in "
        f"{time.perf_counter() - t0:.1f} s")
    out, faults = [], []
    for i, (arch, shape, b, s, max_len) in enumerate(cases):
        r = torch.load(os.path.join(build, f"case{i}.pt"))
        one = torch.load(os.path.join(build, f"one_{arch}_{b}x{s}.pt"))
        floors = [_row_rel(w, w32, b) for w, w32 in zip(one["bfloat16"],
                                                        one["float32"])]
        bars = {"bfloat16": [max(BF16_ROW_REL, 2 * f) for f in floors],
                "float32": [F32_ROW_REL] * len(floors)}
        for dt in ("bfloat16", "float32"):
            c = _compare_steps(r[dt], one[dt], b, bars[dt])
            what = (f"{arch} {dt} on {'x'.join(map(str, shape))} (batch "
                    f"{b}, {s} prompt tokens, cache {max_len})")
            log(f"serve {what} vs one card, fed one card's tokens: worst "
                "logit row over its RMS by step " + ", ".join(
                    f"{x:.3g}" for x in c["row_rel_by_step"])
                + ("; one card bf16 vs float32 " + ", ".join(
                    f"{x:.3g}" for x in floors) if dt == "bfloat16" else "")
                + "; near ties (top two within the step's bar of the RMS) "
                f"at steps {c['near_tie_steps']}, first "
                f"{c['first_near_tie']}; tokens differ without a near tie "
                f"at steps {c['flips_without_tie']}")
            if c["flips_without_tie"]:
                faults.append(f"{what}: greedy tokens differ without a near "
                              f"tie at steps {c['flips_without_tie']}")
            if c["steps_over_bar"]:
                faults.append(f"{what}: a logit row past the bar at steps "
                              f"{c['steps_over_bar']}")
            out.append(dict(arch=arch, mesh=list(shape), batch=b, dtype=dt,
                            floor_by_step=floors if dt == "bfloat16"
                            else None, **c))
    if faults:
        raise AssertionError("; ".join(faults))
    return out


def serve_mesh_phase(seed: int, kernels: list, card: str, dryrun) -> dict:
    """Phase 15: ``serve(..., mesh=...)`` of phase 8's three models at
    their full configs on phase 8's shape, one process a visible card
    (NCCL; one card is a 1 x 1 mesh, still through DTensor), the weights
    by ``param_pspecs``, the prompts over the data axes, each step
    through the sharded prefill and decode steps whose regions run the
    kernels on local shards.  Counters are zeroed just before each serve
    and read just after: flash_attention, rglru_scan and selective_scan
    must each launch on the mesh path.  On 1 x 1 the prefill logits and
    greedy tokens must equal phase 8's bit for bit; on more cards the
    comparison is logged (``tests/test_torch_cuda.py``'s four-card test
    holds it).  Then the dry-run child's records (:func:`finish_dryrun`)."""
    import numpy as np

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    res, outs, shape = run_serve_mesh(os.path.join(ROOT, "build",
                                                   "serve_mesh"), seed)
    mesh = "x".join(map(str, shape))
    plain = {k["name"]: k for k in kernels}["flash_attention"]["serve"]
    totals = {}
    for arch in SERVE_ARCHS:
        r, o, want = res[arch], outs[arch], SERVED[arch]
        n = SERVE["gen_tokens"]
        same_tok = bool(np.array_equal(o["tokens"], want["tokens"]))
        same_lg = bool(torch_equal(o["prefill_logits"],
                                   want["prefill_logits"]))
        p8 = plain[arch]
        log(f"{card} | serve {arch} on a {mesh} mesh (full config, bf16, "
            f"{SERVE['batch']} x {SERVE['prompt_len']} prompt tokens, {n} "
            f"greedy tokens): prefill {r['prefill_s']:.3f} s (phase 8 "
            f"{p8['prefill_s']:.3f} s), decode "
            f"{r['decode_s'] / (n - 1) * 1e3:.2f} ms/step (phase 8 "
            f"{p8['decode_s'] / (n - 1) * 1e3:.2f}), peak GiB "
            + ", ".join(f"{g:.2f}" for g in r["peak_gib"])
            + f" (phase 8 {p8['peak_gib']:.2f}); prefill logits bit-equal "
            f"to phase 8: {same_lg}, tokens: {same_tok}; launches "
            + ", ".join(f"{k}={v}" for k, v in sorted(r["launches"].items())))
        if shape == (1, 1) and not (same_tok and same_lg):
            raise AssertionError(f"serve {arch} on 1 x 1 differs from "
                                 "phase 8's unsharded serve")
        kinds = set(get_config(arch).layer_types())
        for name, uses in SERVE_KERNELS.items():
            c = r["launches"].get(name, 0)
            if kinds & uses and c <= 0:
                raise AssertionError(f"serve {arch} on the mesh never "
                                     f"launched {name}")
            totals[name] = totals.get(name, 0) + c
    by_name = {k["name"]: k for k in kernels}
    for name in LM_KERNELS:
        add_path(by_name[name], f"serve on a {mesh} mesh", totals[name])
        by_name[name]["mesh_launches"] = totals[name]
    dr = finish_dryrun(dryrun, card)
    out = dict(mesh=list(shape), serve=res, dryrun=dr,
               phase_s=time.perf_counter() - t_phase)
    by_name["flash_attention"]["serve_mesh"] = out
    log(f"{card} | phase 15: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------- #
# phase 16: the paper's experiments (Table II, Fig. 3)
# ---------------------------------------------------------------------- #
# Table II's 20 s and Fig. 3's 25 s cut to 5 intervals (DIAL decides in
# the last 2), the grid of 24 to three configurations with Lustre's
# default first, Fig. 3's 8 cases to one of each kernel
PAPER_SECONDS = 2.5
PAPER_CONFIGS = [(256, 8), (16, 1), (1024, 32)]
PAPER_CASES = [("bert", 16, 2), ("megatron", 32, 4)]
PAPER_ROOT = os.path.join(ROOT, "build", "paper")
# CPU children beside the card's run, each one torch thread and a third
# of the workloads: the card's congestion pow (pow_cr's plain version,
# ~1,000 float64 ops a call) costs the CPU ~0.6 s an interval
PAPER_PARTS = 3

PAPER_CHILD = r"""
import json, sys
import torch
torch.set_num_threads(1)
import chip_smoke
from repro_torch.core.model import DIALModel
prefix, out, part = sys.argv[1], sys.argv[2], int(sys.argv[3])
with chip_smoke.cpu_pow_cr():
    runs = chip_smoke.paper_runs(DIALModel.load(prefix, device="cpu"), "cpu",
                                 part)
with open(out, "w") as f:
    json.dump(dict(chip_smoke.paper_record(runs), seconds=runs["seconds"]), f)
"""


class cpu_pow_cr:
    """Within: the CPU engine's congestion ``pow`` is the card's
    (``pow_cr``'s plain version) instead of numpy's ``power``."""

    def __enter__(self):
        from repro_torch.kernels.pow_cr.ref import pow_cr_ref
        from repro_torch.pfs import state

        self.numpy_pow = numpy_pow = state._pow
        state._pow = lambda x, e: (pow_cr_ref(x, e) if x.device.type == "cpu"
                                   else numpy_pow(x, e))
        return self

    def __exit__(self, *exc):
        from repro_torch.pfs import state

        state._pow = self.numpy_pow


def paper_runs(model, dev, part: int | None = None) -> dict:
    """Table II's six workloads over :data:`PAPER_CONFIGS` plus the DIAL
    arm, then Fig. 3's :data:`PAPER_CASES`, at :data:`PAPER_SECONDS`,
    through the two scripts' ``measure``; ``part`` of
    :data:`PAPER_PARTS` runs every ``PAPER_PARTS``-th of each."""
    import benchmarks.torch_fig3_dlio as fig3
    import benchmarks.torch_table2_h5bench as t2

    pick = (lambda xs: xs) if part is None else (  # noqa: E731
        lambda xs: xs[part::PAPER_PARTS])
    fig3.SECONDS = PAPER_SECONDS          # read when a run starts
    t0 = time.perf_counter()
    table = t2.measure(model, configs=PAPER_CONFIGS, seconds=PAPER_SECONDS,
                       workloads=pick(t2.WORKLOADS), device=dev)
    t1 = time.perf_counter()
    cases = fig3.measure(model, cases=pick(PAPER_CASES), device=dev)
    return dict(table=table, cases=cases,
                seconds=dict(table2=t1 - t0,
                             fig3=time.perf_counter() - t1))


def paper_record(runs: dict) -> dict:
    """What card and CPU must agree on, as JSON: the two scripts'
    ``detail`` (every arm's unrounded MB/s, the DIAL arms' delivered
    bytes and θ trajectories; the rows follow from them)."""
    import benchmarks.torch_fig3_dlio as fig3
    import benchmarks.torch_table2_h5bench as t2

    return json.loads(json.dumps({"table2": t2.detail(runs["table"]),
                                  "fig3": fig3.detail(runs["cases"])}))


def _first_record_diff(a, b, path="") -> str | None:
    """Where two JSON records first differ, or ``None``."""
    if isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys():
        for k in a:
            d = _first_record_diff(a[k], b[k], f"{path}.{k}")
            if d:
                return d
        return None
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        for i, (x, y) in enumerate(zip(a, b)):
            d = _first_record_diff(x, y, f"{path}[{i}]")
            if d:
                return d
        return None
    return None if a == b else f"{path}: {a!r} vs {b!r}"


def paper_kernels(model, rng) -> tuple:
    """``segment_sum`` on the Table II sim's maps and the paired forest
    on its 8 interfaces x 24 rows, against their plain versions."""
    import torch

    from repro_torch.kernels.gbdt_forest.ops import pair_forests
    from repro_torch.pfs.engine import PFSSim
    from repro_torch.pfs.workloads import bdcats_read, table_from_sim

    dev = model.device
    sim = PFSSim(1, 8, device=dev)
    sim.attach(bdcats_read(0, "full"))
    table, _ = table_from_sim(sim)
    seg = check_segment_sum({"paper 1x8 osc_ost x2": (sim.topo.ost_map, 2),
                             "paper 1x8 osc_client": (sim.topo.client_map, 1),
                             "paper 1x8 entry_row": (table.row_map, 1),
                             "paper 1x8 entry_osc x8": (table.osc_map, 8)},
                            rng)
    feature, threshold, leaf, base, _, n_features = pair_forests(
        model.read_forest, model.write_forest)
    to = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    x = to((rng.standard_normal((sim.n_osc * 24, n_features)) * 10.0
            ** rng.uniform(-1, 3, n_features)).astype(np.float32))
    op = to(np.repeat(rng.integers(0, 2, sim.n_osc), 24).astype(np.int32))
    forest = check_forest("paired_forest_margin",
                          "src/repro/kernels/gbdt_forest/kernel.py:96", x, op,
                          *map(to, (feature, threshold, leaf, base)),
                          label=" (paper 1x8 rows)")
    return seg, forest


def paper_children(model) -> list:
    """Start phase 16's CPU side: :data:`PAPER_PARTS` children, each a
    part of :func:`paper_runs` on the CPU with the card's congestion
    ``pow``, from ``model`` saved under :data:`PAPER_ROOT`.  They need
    nothing but the model, so they start before phase 13 and run beside
    the card's phases (~1 min each, one core each)."""
    import shutil

    shutil.rmtree(PAPER_ROOT, ignore_errors=True)
    os.makedirs(PAPER_ROOT)
    prefix = os.path.join(PAPER_ROOT, "model")
    model.save(prefix)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    children = []
    for i in range(PAPER_PARTS):
        out = os.path.join(PAPER_ROOT, f"cpu{i}.json")
        c = subprocess.Popen(
            [sys.executable, "-c", PAPER_CHILD, prefix, out, str(i)], env=env,
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        c.out = out
        children.append(c)
    return children


def stop_children(children: list) -> None:
    for c in children:
        if c.poll() is None:
            c.kill()
            c.communicate()


def paper_phase(model, seed: int, dev, kernels: list, card: str,
                children: list) -> dict:
    """Phase 16, the paper's experiments on the model phase 3 trained:
    Table II's six workloads (static arms over :data:`PAPER_CONFIGS`, the
    DIAL arm from Lustre's default) and two Fig. 3 cases, at
    :data:`PAPER_SECONDS`, on the card (every interval a CUDA-graph
    replay), held against :func:`paper_children`'s CPU runs: every arm's
    delivered bytes bit-equal, θ trajectories and rows (``optimal_cfg``
    included) identical.  Launches go into the ``segment_sum``,
    ``pow_cr`` and paired-forest rows."""
    import torch

    import benchmarks.torch_fig3_dlio as fig3
    import benchmarks.torch_table2_h5bench as t2

    t_phase = time.perf_counter()
    try:
        runs, secs, counts = counted(lambda: paper_runs(model, dev))
        t_wait = time.perf_counter()
        logs = [c.communicate(timeout=600)[0] for c in children]
        wait_s = time.perf_counter() - t_wait
    finally:
        stop_children(children)
    cpu, cpu_s = {"table2": [], "fig3": []}, []
    for c, text in zip(children, logs):
        if c.returncode != 0:
            raise AssertionError(f"paper runs on the CPU (child process) "
                                 f"failed: {text[-2000:]}")
        with open(c.out) as f:
            part = json.load(f)
        cpu_s.append(part.pop("seconds"))
        for k in cpu:
            cpu[k] += part[k]
    rec = paper_record(runs)
    # the parts in the card's order
    cpu["table2"].sort(key=lambda r: [m["workload"] for m in rec[
        "table2"]].index(r["workload"]))
    cpu["fig3"].sort(key=lambda r: [c["case"] for c in rec["fig3"]].index(
        r["case"]))
    diff = _first_record_diff(rec, cpu)
    if diff:
        raise AssertionError(f"paper runs: the card differs from the CPU at "
                             f"{diff}")
    arms = [a for m in runs["table"] for a in [g for _, g in m["grid"]]
            + [m["dial"]]] + [c[k] for c in runs["cases"]
                              for k in ("default", "dial")]
    dial = [m["dial"] for m in runs["table"]] + [c["dial"]
                                                 for c in runs["cases"]]
    on_card = torch.device(dev).type == "cuda"
    for a in arms:
        if not (np.isfinite(a.mbs) and a.mbs > 0) \
                or a.run["graph"] != on_card:
            raise AssertionError(f"paper runs: an arm ran off the graph or "
                                 f"delivered {a.mbs} MB/s")
    if not any(len(r) for a in dial for r in a.fleet.decisions):
        raise AssertionError("paper runs: no DIAL arm decided")
    rows = ([t2.row(m) for m in runs["table"]],
            [fig3.row(c) for c in runs["cases"]])
    for row in rows[0]:
        if tuple(row["optimal_cfg"]) not in PAPER_CONFIGS:
            raise AssertionError(f"{row['workload']}: optimal_cfg "
                                 f"{row['optimal_cfg']}")
    replayed = {}
    for a in arms:
        for k, v in a.run.get("launches_per_replay", {}).items():
            replayed[k] = replayed.get(k, 0) + v * a.run["replays"]
    captured = [a.run for a in arms if a.run.get("captured_now")]
    capture_s = sum(r["capture_s"] + (r["instantiate_s"] or 0.0)
                    for r in captured)
    n_int = int(round(PAPER_SECONDS / 0.5))
    ms = {name: float(np.mean([a.run.get("device_ms_per_interval", np.nan)
                               for a in xs]))
          for name, xs in (("static", [a for a in arms if a.fleet is None]),
                           ("DIAL", dial))}
    cpu_total = sum(p["table2"] + p["fig3"] for p in cpu_s)
    cpu_ms = cpu_total / (len(arms) * n_int) * 1e3
    by_name = {k["name"]: k for k in kernels}
    for kname in ("segment_sum", "pow_cr", "paired_forest_margin"):
        add_path(by_name[kname], "paper Table II + Fig. 3 (counted + "
                 "replayed)", counts.get(kname, 0) + replayed.get(kname, 0))
    rng = np.random.default_rng(seed + 16)
    seg, forest = paper_kernels(model, rng)
    by_name["segment_sum"]["paper_shapes"] = seg["cases"]
    by_name["paired_forest_margin"]["paper_shapes"] = [
        {k: forest[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                "bound_by", "max_abs_err", "shape")}]
    for row in rows[0]:
        log(f"{card} | Table II {row['workload']}: optimal "
            f"{row['optimal_mbs']} MB/s at {tuple(row['optimal_cfg'])} of "
            f"{len(PAPER_CONFIGS)}, DIAL {row['dial_mbs']} MB/s "
            f"({row['dial_frac_of_optimal']} of optimal)")
    for row in rows[1]:
        log(f"{card} | Fig. 3 {row['kernel']} t={row['threads']} "
            f"osts={row['osts']}: default {row['default_mbs']}, DIAL "
            f"{row['dial_mbs']} MB/s ({row['speedup']}x)")
    res = dict(
        seconds=PAPER_SECONDS, configs=PAPER_CONFIGS, cases=PAPER_CASES,
        arms=len(arms), card_s=secs, card_split_s=runs["seconds"],
        cpu_s=cpu_s, cpu_wait_s=wait_s, captures=len(captured),
        capture_s=capture_s, device_ms_per_interval=ms,
        cpu_ms_per_interval=cpu_ms, counts=counts, replayed=replayed,
        decided=sum(len(r) for a in dial for r in a.fleet.decisions),
        changes=sum(int(r.decisions.changed.sum()) for a in dial
                    for r in a.fleet.decisions))
    log(f"{card} | paper runs: Table II's 6 workloads x ({len(PAPER_CONFIGS)} "
        f"of 24 static configurations + DIAL) and Fig. 3's "
        f"{len(PAPER_CASES)} of 8 cases x 2 arms, {PAPER_SECONDS:g} s each "
        f"(cut from 20 and 25 s: {n_int} intervals): {len(arms)} arms on the "
        f"card in {secs:.3f} s (Table II {runs['seconds']['table2']:.3f}, "
        f"Fig. 3 {runs['seconds']['fig3']:.3f}), {len(captured)} captures in "
        f"{capture_s:.3f} s, replays {ms['static']:.2f} ms/interval static "
        f"and {ms['DIAL']:.2f} DIAL (device span); {PAPER_PARTS} CPU "
        f"children (the card's pow; started before phase 13), "
        + ", ".join(f"{p['table2'] + p['fig3']:.3f}" for p in cpu_s)
        + f" s ({cpu_ms:.2f} ms/interval; waited {wait_s:.3f} s): delivered "
        f"bytes bit-equal, θ trajectories ({res['decided']} decided rows, "
        f"{res['changes']} θ changes) and rows identical; launches counted "
        + ", ".join(f"{k}={v}" for k, v in counts.items()) + ", replayed "
        + ", ".join(f"{k}={v}" for k, v in replayed.items()))
    res["phase_s"] = time.perf_counter() - t_phase
    by_name["paired_forest_margin"]["paper"] = {
        k: v for k, v in res.items() if k not in ("counts", "replayed")}
    log(f"{card} | phase 16: {res['phase_s']:.1f} s")
    return res


def torch_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and bool(torch.equal(a, b))


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
    smi = nvidia_smi()
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

    t_start = time.perf_counter()
    dryrun = start_dryrun()    # a CPU child beside the card's phases
    try:
        return run_all(args, smi, t_start, dryrun)
    finally:
        stop_dryrun(dryrun)


def run_all(args, smi: str, t_start: float, dryrun) -> int:
    """Phases 3-16, then the result lines."""
    import torch

    t0 = time.perf_counter()
    kernels, model = run_phases(args.seed, args.model, torch.device("cuda"))
    log(f"{smi} | phases 3-7: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels += serving_phase(args.seed, torch.device("cuda"))
    log(f"{smi} | phase 8: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lab_phase(model, args.seed, torch.device("cuda"), kernels, smi)
    log(f"{smi} | phase 9: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    cut_report = obs_phase(model, args.seed, torch.device("cuda"), kernels,
                           smi)
    torch.cuda.empty_cache()
    dial_phase(model, args.seed, torch.device("cuda"), kernels, smi,
               cut_report)
    torch.cuda.empty_cache()
    train_phase(model, torch.device("cuda"), kernels, smi)
    log(f"{smi} | the phases before 13: {time.perf_counter() - t_start:.1f} s")
    children = paper_children(model)      # phase 16's CPU side, from here
    try:
        torch.cuda.empty_cache()
        family_phase(args.seed, torch.device("cuda"), kernels, smi)
        torch.cuda.empty_cache()
        mesh_phase(args.seed, kernels, smi)
        torch.cuda.empty_cache()
        # before phase 15, which waits for the dry-run child at its end
        paper_phase(model, args.seed, torch.device("cuda"), kernels, smi,
                    children)
    finally:
        stop_children(children)
    torch.cuda.empty_cache()
    serve_mesh_phase(args.seed, kernels, smi, dryrun)
    log(f"{smi} | the phases: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
