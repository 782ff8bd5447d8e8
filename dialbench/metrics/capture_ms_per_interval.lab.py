"""Host time of the lab calls' CUDA-graph captures (capture and
instantiation, the program's loop-cache counter) an interval."""

from dialbench import readings


def read(ctx):
    return readings.capture_ms_per_interval(ctx)
