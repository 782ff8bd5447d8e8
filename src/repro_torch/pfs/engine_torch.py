"""Execution layer: one tuning interval of ``demand_step`` + ``engine_step``.

The counterpart of the reference's ``FusedEngine``
(``repro/pfs/engine_jax.py``), which compiles the interval into one
``lax.scan``.  Here the interval is a Python loop of ``n_ticks`` over
device tensors: every tick's reductions launch the ``segment_sum``
kernel, and nothing syncs with the host.  This eager loop serves the
host paths (``run_fleet(backend="torch")``, ``collect``); the fused
tuning loop (:mod:`repro_torch.pfs.loop_torch`) runs the same ticks
inside an interval it captures as one CUDA graph.
"""

from __future__ import annotations

from repro_torch.pfs.state import (Disturbance, SimParams, SimState, SimTopo,
                                   engine_step)
from repro_torch.pfs.workloads import WorkloadState, WorkloadTable


class FusedEngine:
    """``n_ticks`` engine ticks per :meth:`run_interval` call."""

    def __init__(self, params: SimParams, topo: SimTopo,
                 table: WorkloadTable, n_ticks: int):
        self.params = params
        self.topo = topo
        self.table = table
        self.n_ticks = int(n_ticks)

    def run_interval(self, state: SimState, wstate: WorkloadState,
                     schedule: Disturbance | None = None, tracer=None):
        """Advance one interval.  ``schedule`` is a :class:`Disturbance`
        with a leading ``(n_ticks, ...)`` axis; tick ``i`` uses row ``i``.
        ``tracer`` (a :class:`~repro_torch.obs.host.HostTracer`) samples
        the state after the ticks it wants, with that tick's row, on the
        device.
        """
        for i in range(self.n_ticks):
            demand, wstate = self.table.demand_step(self.params, wstate,
                                                    state)
            dist = None if schedule is None else schedule.at_tick(i)
            state = engine_step(self.params, self.topo, state, demand,
                                disturbance=dist)
            if tracer is not None and tracer.wants_sample(i, self.n_ticks):
                tracer.sample(state, dist)
        return state, wstate
