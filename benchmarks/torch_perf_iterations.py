"""The three roofline iterations of ``benchmarks/perf_iterations.py`` over
the port's dry-run: trace each cell on the production mesh (a fake
process group in this process, ``repro_torch.launch.dryrun``) with and
without the variant, and print the roofline terms at the H100 SXM's
peaks.

A. qwen2-moe-a2.7b train_4k -- expert padding 60 -> 64, so the experts
   shard the 16-way 'model' axis (baseline: replicated expert compute).
B. llava-next-34b train_4k -- q-head padding 56 -> 64, so attention is
   head-sharded (baseline: the replicated-attention fallback).
C. gemma2-2b long_500k and decode_32k -- the analytic cache term of a
   decode that reads only a window layer's live window (the port's
   decode always slices it; the baseline term reads the full cache).

    PYTHONPATH=src python benchmarks/torch_perf_iterations.py [--quick] \\
        [--json]

``--quick`` runs A only.  Records go to ``results/perf_torch/``.  Imports
neither JAX nor the reference package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from repro_torch.configs import get_config
from repro_torch.launch import dryrun as dr

OUT = "results/perf_torch"


def measure(arch: str, shape: str, override=None, window_cache=False,
            tag: str = "") -> dict:
    cfg = get_config(arch)
    if override:
        cfg = dataclasses.replace(cfg, **override)
    rec = dr.analyze(dr.trace_cell(arch, shape, False, cfg=cfg), cfg=cfg,
                     window_cache=window_cache)
    ro = rec["roofline"]
    print(f"[{tag}] {arch} x {shape}: dominant={ro['dominant']} "
          f"compute={ro['compute_s']:.4f} memory={ro['memory_s']:.4f} "
          f"collective={ro['collective_s']:.4f} "
          f"mfu_bound={ro['mfu_bound']:.3f} (trace {rec['trace_s']:.1f} s)",
          flush=True)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, f"{arch}__{shape}__{tag}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="iteration A only (baseline vs padded experts)")
    ap.add_argument("--json", action="store_true",
                    help="print a final machine-readable summary line")
    args = ap.parse_args(argv)

    recs = {"A_baseline": measure("qwen2-moe-a2.7b", "train_4k",
                                  tag="A_baseline"),
            "A_padded_ep": measure("qwen2-moe-a2.7b", "train_4k",
                                   override={"n_experts_pad": 64},
                                   tag="A_padded_ep")}
    if not args.quick:
        recs["B_baseline"] = measure("llava-next-34b", "train_4k",
                                     tag="B_baseline")
        recs["B_padded_heads"] = measure("llava-next-34b", "train_4k",
                                         override={"n_heads_pad": 64},
                                         tag="B_padded_heads")
        for shape in ("long_500k", "decode_32k"):
            recs[f"C_baseline_{shape}"] = measure(
                "gemma2-2b", shape, tag=f"C_baseline_{shape}")
            recs[f"C_window_cache_{shape}"] = measure(
                "gemma2-2b", shape, window_cache=True,
                tag=f"C_window_cache_{shape}")
    if args.json:
        print(json.dumps({
            "schema": "dial-torch-perf-iterations-v1", "quick": args.quick,
            "card": "NVIDIA H100 SXM (700 W) peaks",
            "measures": {tag: {k: rec["roofline"][k] for k in (
                "dominant", "compute_s", "memory_s", "collective_s",
                "mfu_bound")} | {"wire_bytes_per_chip":
                                 rec["wire_bytes_per_chip"],
                                 "trace_s": rec["trace_s"]}
                for tag, rec in recs.items()}}))
    return recs


if __name__ == "__main__":
    main()
