"""Client-local statistics probing -- the simulated ``/proc/fs/lustre``.

:func:`probe_all` copies the cumulative counters of many OSC interfaces
at one instant into a :class:`FleetStats` (one gather per field, on the
device).  DIAL's preprocessor (:mod:`repro_torch.core.metrics`) turns
two consecutive probes into the designed interval metrics.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class FleetStats:
    """Cumulative counters of interfaces ``oscs`` at time ``t``.

    Column ``i`` of every tensor is interface ``oscs[i]``; per-op fields
    are ``(2, n)``, per-OSC fields ``(n,)``.
    """

    t: float | torch.Tensor         # the state's clock, as it holds it
    oscs: torch.Tensor              # (n,) int64 interface ids
    bytes_done: torch.Tensor        # (2, n) app-visible completed bytes
    rpcs_sent: torch.Tensor
    rpc_bytes: torch.Tensor
    partial_rpcs: torch.Tensor
    latency_sum: torch.Tensor
    rpcs_done: torch.Tensor
    req_count: torch.Tensor
    req_bytes: torch.Tensor
    pending_integral: torch.Tensor
    active_integral: torch.Tensor
    cache_hit_bytes: torch.Tensor   # (n,)
    block_time: torch.Tensor
    dirty_integral: torch.Tensor
    grant_integral: torch.Tensor
    randomness: torch.Tensor        # (2, n)
    window_pages: torch.Tensor      # (n,) int64
    rpcs_in_flight: torch.Tensor    # (n,) int64

    def __len__(self) -> int:
        return self.oscs.shape[0]


# FleetStats field -> SimState field
_PER_OP = {"bytes_done": "ctr_bytes_done", "rpcs_sent": "ctr_rpcs_sent",
           "rpc_bytes": "ctr_rpc_bytes", "partial_rpcs": "ctr_partial_rpcs",
           "latency_sum": "ctr_latency_sum", "rpcs_done": "ctr_rpcs_done",
           "req_count": "ctr_req_count", "req_bytes": "ctr_req_bytes",
           "pending_integral": "ctr_pending_integral",
           "active_integral": "ctr_active_integral",
           "randomness": "randomness"}
_PER_OSC = {"cache_hit_bytes": "ctr_cache_hit_bytes",
            "block_time": "ctr_block_time",
            "dirty_integral": "ctr_dirty_integral",
            "grant_integral": "ctr_grant_integral",
            "window_pages": "window_pages",
            "rpcs_in_flight": "rpcs_in_flight"}


def probe_all(sim, oscs: torch.Tensor | None = None) -> FleetStats:
    """Snapshot the counters of interfaces ``oscs`` (default all)."""
    state = sim.state
    if oscs is None:
        oscs = torch.arange(sim.n_osc, device=sim.device)
    fields = {k: getattr(state, v)[:, oscs] for k, v in _PER_OP.items()}
    fields.update({k: getattr(state, v)[oscs] for k, v in _PER_OSC.items()})
    return FleetStats(t=state.now, oscs=oscs, **fields)


def probe(sim, osc: int) -> FleetStats:
    """One interface's counters: a one-column :class:`FleetStats` (what a
    per-interface agent reads)."""
    return probe_all(sim, torch.tensor([int(osc)], device=sim.device))


def stack_stats(stats: list, oscs) -> FleetStats:
    """Join probes of single interfaces (or any columns) into one
    :class:`FleetStats`, column by column, clock from the first."""
    fields = {f.name: torch.cat([getattr(s, f.name) for s in stats], dim=-1)
              for f in dataclasses.fields(FleetStats)
              if f.name not in ("t", "oscs")}
    return FleetStats(t=stats[0].t, oscs=torch.as_tensor(
        oscs, dtype=torch.int64, device=stats[0].bytes_done.device), **fields)
