"""Stateful wrapper over the pure PFS engine core, on one device.

:class:`PFSSim` owns the topology and one :class:`SimState` whose
tensors live on ``device``.  Attribute access (``sim.ctr_bytes_done``
...) reads the current state.  Workloads attach to it and are stepped
through the frozen :class:`~repro_torch.pfs.workloads.WorkloadTable`
(:mod:`repro_torch.pfs.engine_torch`); there is no per-object tick.

The two DIAL-tunable knobs are per-OSC tensors: ``window_pages``
(Lustre ``osc.*.max_pages_per_rpc``) and ``rpcs_in_flight``
(``osc.*.max_rpcs_in_flight``); both take effect on the next tick.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.pfs.state import SimParams, SimTopo, init_state


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
        self.done_base: list = []   # stripe done-bytes at attach

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

    def osc_id(self, client: int, ost: int) -> int:
        return self.topo.osc_id(client, ost)

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

    def attach(self, workload) -> None:
        """Attach a :class:`~repro_torch.pfs.workloads.Workload`, capturing
        its stripe's delivered bytes so far as its done-bytes base."""
        oscs = [self.osc_id(workload.client, t) for t in workload.osts]
        done = self.state.ctr_bytes_done[workload.op][oscs]
        self.workloads.append(workload)
        self.issued.append(0.0)
        self.done_base.append(float(done.sum()))
