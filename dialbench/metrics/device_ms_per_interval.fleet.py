"""The fleet's replayed interval on the device's clock (FusedLoop.last_run,
CUDA events)."""

from dialbench import readings


def read(ctx):
    return readings.device_ms_per_interval(ctx)
