"""The fused loop's finish of each run, less its wait for the device
(`loop.finish` less `loop.wait`: the clock and the records to the host,
the decisions' rows) in the window's calls, ms an interval."""

from dialbench import spans


def read(ctx):
    return spans.ms_per_interval(ctx, "loop.finish", less="loop.wait")
