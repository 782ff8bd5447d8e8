"""Render the port's roofline table from the dry-run's records.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --jobs 4
    python benchmarks/torch_roofline_report.py [results/dryrun] \\
        [--combined | --by-arch]

One table per production mesh (16 x 16 = 256 ranks; 2 x 16 x 16 = 512):
each cell's dominant term and its compute, memory and collective
seconds at the NVIDIA H100 SXM's peaks (700 W: bf16 989 TFLOP/s, HBM
3.35 TB/s, 50 GB/s a card across nodes), the wire bytes per rank, the
useful-FLOPs share, the MFU bound and the trace seconds on the CPU.
``--combined`` prints one row per (arch, shape) with both meshes side by
side, and the total trace seconds; ``--by-arch`` one row per arch, each
shape's dominant term (c, m or x: compute, memory, collective) and its
bound seconds on the two meshes.  Imports neither JAX nor the
reference package (nor torch).
"""

from __future__ import annotations

import glob
import json
import os
import sys


def load(out_dir: str = "results/dryrun") -> list:
    recs = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def table(recs: list, mesh: str = "pod") -> str:
    rows = ["| arch | shape | dominant | compute s | memory s | collective s "
            "| wire GB/rank | MODEL_FLOPs/FLOPs | MFU bound | trace s |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    want = 2 if mesh == "pod" else 3
    for r in recs:
        if len(r["mesh"]) != want:
            continue
        ro = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | **{ro['dominant']}** "
            f"| {ro['compute_s']:.4f} | {ro['memory_s']:.4f} "
            f"| {ro['collective_s']:.4f} "
            f"| {r['wire_bytes_per_chip'] / 1e9:.3f} "
            f"| {ro['useful_flops_frac']:.2f} | {ro['mfu_bound']:.4f} "
            f"| {r['trace_s']:.1f} |")
    return "\n".join(rows)


def combined(recs: list) -> str:
    """One row per (arch, shape): each mesh's dominant term and its
    compute / memory / collective seconds, then the trace seconds."""
    by = {}
    for r in recs:
        by.setdefault((r["arch"], r["shape"]), {})[len(r["mesh"])] = r

    def cell(r):
        if r is None:
            return "missing | | "
        ro = r["roofline"]
        return (f"{ro['dominant']} | {ro['compute_s']:.3g} / "
                f"{ro['memory_s']:.3g} / {ro['collective_s']:.3g} | "
                f"{r['wire_bytes_per_chip'] / 1e9:.3g}")
    rows = ["| arch | shape | 16x16 | c / m / x s | wire GB | 2x16x16 "
            "| c / m / x s | wire GB | trace s |",
            "|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape), m in by.items():
        trace = " / ".join(f"{m[k]['trace_s']:.1f}" for k in (2, 3) if k in m)
        rows.append(f"| {arch} | {shape} | {cell(m.get(2))} | "
                    f"{cell(m.get(3))} | {trace} |")
    total = sum(r["trace_s"] for r in recs)
    return "\n".join(rows) + f"\n\n{len(recs)} cells, {total:.1f} s traced"


LETTER = {"compute": "c", "memory": "m", "collective": "x"}


def by_arch(recs: list) -> str:
    """One row per arch: per shape, the dominant term's letter and the
    bound seconds on 16 x 16 / 2 x 16 x 16."""
    shapes = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
    by = {}
    for r in recs:
        by.setdefault(r["arch"], {}).setdefault(r["shape"], {})[
            len(r["mesh"])] = r

    def cell(m):
        if not m:
            return "-"
        out = []
        for k in (2, 3):
            ro = m[k]["roofline"] if k in m else None
            out.append("?" if ro is None else
                       f"{LETTER[ro['dominant']]} "
                       f"{ro[ro['dominant'] + '_s']:.4g}")
        return " / ".join(out)
    rows = ["| arch | " + " | ".join(shapes) + " |",
            "|---|" + "---|" * len(shapes)]
    for arch, m in by.items():
        rows.append(f"| {arch} | " + " | ".join(cell(m.get(s))
                                                for s in shapes) + " |")
    return "\n".join(rows)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    flags = [a for a in argv if a.startswith("--")]
    argv = [a for a in argv if not a.startswith("--")]
    out_dir = argv[0] if argv else "results/dryrun"
    recs = load(out_dir)
    print(f"{len(recs)} dry-run records from {out_dir}")
    if "--combined" in flags:
        print(combined(recs))
        return
    if "--by-arch" in flags:
        print(by_arch(recs))
        print(f"\n{len(recs)} cells, "
              f"{sum(r['trace_s'] for r in recs):.1f} s traced")
        return
    print("\n## single pod (16 x 16 = 256 ranks)\n")
    print(table(recs, "pod"))
    print("\n## two pods (2 x 16 x 16 = 512 ranks)\n")
    print(table(recs, "multipod"))


if __name__ == "__main__":
    main()
