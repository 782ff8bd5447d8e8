"""The paired forest kernel's share of its roofline in the lab batch's
tuning tick (dialbench.roofline counts; kernel time from the profiler)."""

from dialbench import readings


def read(ctx):
    return readings.roofline_pct(ctx, "forest", "forest_margin")
