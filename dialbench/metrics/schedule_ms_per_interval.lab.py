"""The program's disturbance schedule of each run (its `lab.schedule`
spans: one `make_schedule` an element and their concatenation) in the
window's calls, ms an interval."""

from dialbench import spans


def read(ctx):
    return spans.ms_per_interval(ctx, "lab.schedule")
