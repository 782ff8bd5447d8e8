"""Device operations in one replayed fleet interval, from the profiler over
the profiled call's replays."""

from dialbench import readings


def read(ctx):
    return readings.kernels_per_interval(ctx)
