"""Assigned input-shape sets and their step kinds.

LM-transformer shapes (applies to every assigned arch):
    train_4k     seq 4,096   x global_batch 256   -> train_step
    prefill_32k  seq 32,768  x global_batch 32    -> prefill_step
    decode_32k   seq 32,768  x global_batch 128   -> serve_step (1 token,
                                                     KV cache of 32k)
    long_500k    seq 524,288 x global_batch 1     -> serve_step; only for
                 sub-quadratic archs (ssm / hybrid / local+global decode)
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# archs for which long_500k applies (sub-quadratic sequence handling, per
# DESIGN.md S5): SSM, hybrid, and gemma2's alternating local/global whose
# decode step is O(window) local + O(S) memory-bound global reads.
LONG_CONTEXT_ARCHS = {"falcon-mamba-7b", "recurrentgemma-9b", "gemma2-2b"}


def applicable_shapes(arch_id: str) -> list[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if arch_id in LONG_CONTEXT_ARCHS:
        out.append("long_500k")
    return out
