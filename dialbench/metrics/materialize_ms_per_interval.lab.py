"""The program's elements made into engine pieces before their stack
(its `lab.materialize` spans, one an element, `lab/scenarios.py`) in the
window's calls, ms an interval: 0 where every batch is laid out from
its elements' staged arrays.  Nothing where the loaded program has no
such span (it makes every element's pieces in its build)."""

import sys

from dialbench import spans

PROGRAM = "repro_torch.lab.scenarios"


def read(ctx):
    name = getattr(sys.modules.get(PROGRAM), "MATERIALIZE_SPAN", None)
    return None if name is None else spans.ms_per_interval(ctx, name)
