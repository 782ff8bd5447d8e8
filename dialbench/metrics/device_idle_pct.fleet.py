"""The device's idle share over a profiled fleet session's steady run of
replays, from its first device operation to its last: 1 - busy union /
wall, from the profiler."""

from dialbench import readings


def read(ctx):
    return readings.device_idle_pct(ctx)
