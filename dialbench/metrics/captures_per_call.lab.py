"""CUDA-graph captures a lab call makes, from the program's loop-cache
counters over the window (a new batch's table content is a new graph
today; a graph that took any table would read 0)."""

from dialbench import readings


def read(ctx):
    return readings.captures_per_call(ctx)
