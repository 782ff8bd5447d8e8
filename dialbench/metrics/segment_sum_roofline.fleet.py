"""segment_sum's share of its roofline in the fleet's interval
(dialbench.roofline counts; kernel time from the profiler)."""

from dialbench import readings


def read(ctx):
    return readings.roofline_pct(ctx, "segment_sum", "segment_sum")
