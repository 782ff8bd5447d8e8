"""Run one cell of the benchmark of DIAL's PyTorch/CUDA port.

    python3 dialbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Set-up (imports, the kernels' build, the
inputs, the warm-up and the capture) is timed as ``setup_s``; then the
cell's calls run for ``--seconds``; then the reference checks what they
produced.  ``--trace 0`` reports the cell's end-to-end metrics, ``--trace
1`` its per-layer metrics and the device's busy share.  The last line of
standard output is the result as one JSON object; the last lines of
standard error are each compared number beside its limit.  Without the
CUDA devices the cell asks for, it prints no result and exits 3; if
JAX or the JAX package got loaded, it exits 4.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# every build and kernel cache of the program inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from dialbench import harness

    cell = harness.find_cell(ROOT, args.workload)
    chips = int(cell.entry["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"dialbench: {args.workload} needs {chips} CUDA device(s), "
              f"{have} available", file=sys.stderr)
        return 3
    result, lines = harness.run(cell, args.seed, args.seconds,
                                bool(args.trace), "cuda", T0)
    bad = harness.forbidden_modules()
    if bad:
        print("dialbench: loaded JAX or the JAX package: " + ", ".join(bad),
              file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
