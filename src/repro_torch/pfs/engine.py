"""Stateful wrapper over the pure PFS engine core, on one device.

:class:`PFSSim` owns the topology and one :class:`SimState` whose
tensors live on ``device``.  Attribute access (``sim.ctr_bytes_done``
...) reads the current state.  Workloads attach to it and are stepped
through the frozen :class:`~repro_torch.pfs.workloads.WorkloadTable`
(:mod:`repro_torch.pfs.engine_torch`); there is no per-object tick.

The object surface the LM's data pipeline and checkpoint manager drive
(the reference's ``repro/pfs/engine.py``): :meth:`PFSSim.step` and
:meth:`PFSSim.run` advance the attached workloads through the table,
which the sim keeps with its closed-loop state between calls and
rebuilds only when the attached set or a stripe changes
(:meth:`PFSSim.attach`, :meth:`PFSSim.bind`); :meth:`PFSSim.submit_read`
and :meth:`PFSSim.submit_write` deposit an application's demand with
the reference's scalar arithmetic, on the state's tensors.

The two DIAL-tunable knobs are per-OSC tensors: ``window_pages``
(Lustre ``osc.*.max_pages_per_rpc``) and ``rpcs_in_flight``
(``osc.*.max_rpcs_in_flight``); both take effect on the next tick.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.pfs.state import (READ, WRITE, SimParams, SimTopo,
                                   engine_step, init_state)


class PFSSim:
    """Discrete-time simulator of clients -> OSC -> RPC -> OST.

    ``device=None`` means the CUDA card (raises without one); pass
    ``device="cpu"`` for the plain PyTorch path.
    """

    def __init__(self, n_clients: int, n_osts: int,
                 params: SimParams | None = None, device=None):
        self.device = resolve_device(device)
        self.params = params or SimParams()
        self.topo = SimTopo.dense(n_clients, n_osts, self.device)
        self.state = init_state(self.topo)
        self.workloads: list = []
        self.issued: list = []      # closed-loop bytes issued, per workload
        self.done_base: list = []   # stripe done-bytes at attach / bind
        self._tables = None         # (table, wstate) of ``workloads``

    def __getattr__(self, name: str):
        state = self.__dict__.get("state")
        if state is not None and hasattr(state, name):
            return getattr(state, name)
        raise AttributeError(
            f"{type(self).__name__!s} object has no attribute {name!r}")

    @property
    def n_clients(self) -> int:
        return self.topo.n_clients

    @property
    def n_osts(self) -> int:
        return self.topo.n_osts

    @property
    def n_osc(self) -> int:
        return self.topo.n_osc

    @property
    def now(self):
        return self.state.now

    def osc_id(self, client: int, ost: int) -> int:
        return self.topo.osc_id(client, ost)

    def client_oscs(self, client: int) -> torch.Tensor:
        """The client's interfaces, one per OST (int64, on the device)."""
        return torch.tensor([self.osc_id(client, t)
                             for t in range(self.n_osts)], device=self.device)

    def set_knobs(self, osc_ids, window_pages=None,
                  rpcs_in_flight=None) -> None:
        """Apply θ to interfaces (a scalar broadcasts over ``osc_ids``);
        takes effect on the next tick."""
        idx = torch.as_tensor(osc_ids, dtype=torch.int64, device=self.device)
        for name, v in (("window_pages", window_pages),
                        ("rpcs_in_flight", rpcs_in_flight)):
            if v is not None:
                getattr(self.state, name)[idx] = torch.as_tensor(
                    v, dtype=torch.int64, device=self.device)

    # ------------------------------------------------------------------ #
    # workloads
    # ------------------------------------------------------------------ #
    def attach(self, workload) -> None:
        """Attach a :class:`~repro_torch.pfs.workloads.Workload`, with its
        stripe's delivered bytes so far as its done-bytes base."""
        self.sync_workloads()
        self.workloads.append(workload)
        self.issued.append(0.0)
        self.done_base.append(self._stripe_done(workload))

    def bind(self, workload) -> None:
        """Re-bind an attached workload after a change of its stripe: issued
        bytes reset to 0, the new stripe's delivered bytes as its base."""
        i = self.workload_index(workload)
        self.sync_workloads()
        self.issued[i] = 0.0
        self.done_base[i] = self._stripe_done(workload)

    def sync_workloads(self) -> None:
        """Write the kept table's closed-loop state (issued bytes) back into
        ``issued`` and drop the table: the next tick builds it anew."""
        if self._tables is not None:
            self.issued = [float(v) for v in self._tables[1].issued.cpu()]
            self._tables = None

    def done_bytes(self) -> list:
        """Every attached workload's delivered bytes net of its base (host
        floats, one read of the device)."""
        if not self.workloads:
            return []
        table, wstate = self._workload_tables()
        return table.done_bytes(self.state, wstate).tolist()

    def workload_index(self, workload) -> int:
        """The position of ``workload`` (by identity) among the attached."""
        for i, w in enumerate(self.workloads):
            if w is workload:
                return i
        raise ValueError(f"workload {workload.name!r} is not attached")

    def _stripe_done(self, workload) -> float:
        """The stripe's delivered bytes, summed in stripe order from 0 (the
        table's ordered ``segment_sum``, so a fresh base nets to 0)."""
        total = 0.0
        for v in self.state.ctr_bytes_done[workload.op][[
                self.osc_id(workload.client, t)
                for t in workload.osts]].tolist():
            total += v
        return total

    def _workload_tables(self):
        from repro_torch.pfs.workloads import table_from_sim
        if self._tables is None:
            self._tables = table_from_sim(self)
        return self._tables

    # ------------------------------------------------------------------ #
    # ticks
    # ------------------------------------------------------------------ #
    def step(self, disturbance=None) -> None:
        """One tick: the attached workloads' demand (the table), then the
        engine."""
        demand = None
        if self.workloads:
            table, wstate = self._workload_tables()
            demand, wstate = table.demand_step(self.params, wstate,
                                               self.state)
            self._tables = (table, wstate)
        self.state = engine_step(self.params, self.topo, self.state, demand,
                                 disturbance=disturbance)

    def run(self, seconds: float) -> None:
        """``round(seconds / tick)`` ticks, as one
        :class:`~repro_torch.pfs.engine_torch.FusedEngine` interval."""
        from repro_torch.pfs.engine_torch import FusedEngine
        n = int(round(seconds / self.params.tick))
        if not self.workloads:
            for _ in range(n):
                self.step()
            return
        table, wstate = self._workload_tables()
        self.state, wstate = FusedEngine(self.params, self.topo, table,
                                         n).run_interval(self.state, wstate)
        self._tables = (table, wstate)

    # ------------------------------------------------------------------ #
    # an application's demand, deposited directly (the reference's scalar
    # arithmetic, in place on the state's tensors)
    # ------------------------------------------------------------------ #
    def submit_read(self, osc: int, nbytes: float, randomness: float,
                    req_size: float) -> float:
        """Issue reads totalling ``nbytes`` on interface ``osc``; all of it
        enters the RPC pipeline."""
        s = self.state
        s.pending[READ, osc] += nbytes
        self._mix_randomness(READ, osc, nbytes, randomness)
        s.ctr_req_count[READ, osc] += max(nbytes / max(req_size, 1.0), 1.0)
        s.ctr_req_bytes[READ, osc] += nbytes
        s.ctr_cache_hit_bytes[osc] += (1.0 - randomness) * nbytes
        return nbytes

    def submit_write(self, osc: int, nbytes: float, randomness: float,
                     req_size: float) -> float:
        """Write ``nbytes`` on interface ``osc``: what grant and dirty
        limits allow lands in the dirty cache (and completes for the
        application); the rest blocks.  Returns the accepted bytes."""
        p, s = self.params, self.state
        dirty, grant = torch.stack([s.dirty_bytes[osc],
                                    s.grant_used[osc]]).tolist()
        room = min(p.max_dirty_bytes - dirty, p.grant_bytes - grant)
        accepted = float(np.clip(nbytes, 0.0, max(room, 0.0)))
        s.dirty_bytes[osc] += accepted
        s.grant_used[osc] += accepted
        self._mix_randomness(WRITE, osc, accepted, randomness)
        s.ctr_req_count[WRITE, osc] += max(nbytes / max(req_size, 1.0), 1.0)
        s.ctr_req_bytes[WRITE, osc] += accepted
        s.ctr_bytes_done[WRITE, osc] += accepted
        s.write_blocked[osc] = accepted < nbytes
        return accepted

    def _mix_randomness(self, op: int, osc: int, nbytes: float,
                        r: float) -> None:
        w = min(nbytes / (4 * 2**20), 1.0)
        rnd = self.state.randomness
        rnd[op, osc] = (1 - 0.2 * w) * rnd[op, osc] + 0.2 * w * r
