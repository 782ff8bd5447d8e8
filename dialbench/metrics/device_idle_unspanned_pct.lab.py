"""The profiled lab call's device idle time that no program span covers,
in % of its idle time (the idle window of `device_idle_pct.lab`, the
profiler's own host work left out): the guard that the program's spans
keep covering the host time that starves the card."""

from dialbench import spans


def read(ctx):
    return spans.unspanned_idle_pct(ctx)
