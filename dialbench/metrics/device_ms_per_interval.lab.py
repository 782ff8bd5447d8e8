"""The lab batch's replayed interval on the device's clock
(loop_cache_stats' replay span, CUDA events)."""

from dialbench import readings


def read(ctx):
    return readings.device_ms_per_interval(ctx)
