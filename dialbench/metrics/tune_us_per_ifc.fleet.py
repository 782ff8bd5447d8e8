"""The tuning tick's device time per interface: the tuned replay less an
untuned replay of the same table (Table III's overhead on the fused
path)."""

from dialbench import readings


def read(ctx):
    return readings.tune_us_per_ifc(ctx)
