"""The program's element builds (its `lab.build` spans, one a scenario,
`lab/scenarios.py::build`) in the window's calls, ms an interval."""

from dialbench import spans


def read(ctx):
    return spans.ms_per_interval(ctx, "lab.build")
