"""The program's stack of each call's batch (its `lab.stack` spans:
padding, the block-diagonal assembly, the copy to the device) in the
window's calls, ms an interval."""

from dialbench import spans


def read(ctx):
    return spans.ms_per_interval(ctx, "lab.stack")
