"""Host time of the fleet's sessions an interval: each session's host-clock
wall less its replays' span on CUDA events (FusedLoop.last_run)."""

from dialbench import readings


def read(ctx):
    return readings.host_ms_per_interval(ctx)
