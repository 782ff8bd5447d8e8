"""The eager warm-up interval of each CUDA-graph capture (the fused
loop's `loop.warmup` spans, through its synchronize) in the window's
calls, ms an interval."""

from dialbench import spans


def read(ctx):
    return spans.ms_per_interval(ctx, "loop.warmup")
