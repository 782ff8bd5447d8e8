"""Host time of the lab's run_batch calls an interval: the schedule build,
the capture, the copies and the records to the host, from each run's
host-clock wall less its replays' span."""

from dialbench import readings


def read(ctx):
    return readings.host_ms_per_interval(ctx)
