"""The fused loop's prepare of each run (its `loop.prepare` spans: the
run's host-to-device copies, the schedule's transpose) in the window's
calls, ms an interval."""

from dialbench import spans


def read(ctx):
    return spans.ms_per_interval(ctx, "loop.prepare")
