"""The device's idle share of one profiled lab call, from its start to its
last device operation: 1 - busy union / wall, from the profiler (the
host's build, schedule and capture are the call's idle time)."""

from dialbench import readings


def read(ctx):
    return readings.device_idle_pct(ctx)
