"""Bytes and operations of the two kernels on DIAL's path, from a
launch's shapes, and the least time the card could take for them.

Each input byte is read once and each output byte written once; the
operations are what the inputs need.  The bound of a launch is the
larger of its bytes at the card's memory bandwidth and its operations
at the peak rate of their type; :func:`bound` names which.

``segment_sum`` (ordered float64 sums): ``cols`` rows of ``entries``
float64 values onto ``segments`` sums, through a CSR map of int32
positions (one per entry) and int32 offsets (one per segment, plus
one); one float64 add per value.  Its real limit is the longest
segment's chain of dependent adds, a latency bound and no roofline.

``forest`` (paired GBDT margins): ``rows`` float32 rows of
``features`` values, one int32 forest selector a row, the forests'
int32 split features, float32 thresholds and leaves and float32 bases,
one float32 margin out a row; a row compares ``depth`` nodes and adds
one leaf in each of ``trees`` trees, then the base.
"""

from __future__ import annotations

# NVIDIA H100 SXM (80 GB HBM3), the data sheet's dense peaks at 700 W
PEAKS = {"hbm_bytes_per_s": 3.35e12, "float32_per_s": 67e12,
         "float64_per_s": 34e12}


def segment_sum(cols: int, entries: int, segments: int) -> dict:
    nbytes = 8 * cols * entries + 4 * entries + 4 * (segments + 1) \
        + 8 * cols * segments
    return {"bytes": nbytes, "ops": cols * entries, "type": "float64"}


def forest(rows: int, features: int, forests: int, trees: int, depth: int,
           paired: bool = True) -> dict:
    n_int, n_leaf = 2 ** depth - 1, 2 ** depth
    model = forests * trees * (4 * n_int + 4 * n_int + 4 * n_leaf) \
        + 4 * forests
    nbytes = 4 * rows * features + (4 * rows if paired else 0) + model \
        + 4 * rows
    return {"bytes": nbytes, "ops": rows * (trees * (depth + 1) + 1),
            "type": "float32"}


COUNTS = {"segment_sum": segment_sum, "forest": forest}


def bound(count: dict, peaks: dict = PEAKS) -> tuple:
    """``(seconds, "bytes" | "operations")``: the launch's least time."""
    t_bytes = count["bytes"] / peaks["hbm_bytes_per_s"]
    t_ops = count["ops"] / peaks[count["type"] + "_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_s(launches: list, kernel: str) -> tuple:
    """``(launches, seconds)``: the number of ``kernel``'s launches in
    ``launches`` (``(kernel, shape)`` pairs) and the sum of their
    bounds."""
    shapes = [shape for name, shape in launches if name == kernel]
    return len(shapes), sum(bound(COUNTS[kernel](**s))[0] for s in shapes)
