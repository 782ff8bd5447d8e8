"""Host time of the program's scenario build and stack of each lab call's
new batch (lab.scenarios.build, lab.batch.stack_scenarios) an interval."""

from dialbench import readings


def read(ctx):
    return readings.build_ms_per_interval(ctx)
