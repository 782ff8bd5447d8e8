"""State layer of the PFS engine: flat tick state + the pure step function.

* :class:`SimParams`   -- physical constants of the simulated cluster;
* :class:`SimTopo`     -- the static (client, OST) -> OSC wiring, with the
  CSR segment maps of its two reductions built once;
* :class:`SimState`    -- every mutable per-tick tensor in one dataclass;
* :class:`Demand`      -- one tick's workload submissions as per-OSC deltas;
* :class:`Disturbance` -- one tick's exogenous conditions;
* :func:`engine_step`  -- the pure transition
  ``(params, topo, state, demand) -> state'``.

``engine_step`` has the functional form of the reference's
``engine_step_jax`` and the semantics of its numpy ``engine_step``
(``repro/pfs/state.py``): the same phases, the same arithmetic in the
same order, in float64.  Every per-OST and per-client reduction goes
through :func:`repro_torch.kernels.segment_reduce.ops.segment_sum`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.pow_cr.kernel import pow_cr_cuda
from repro_torch.kernels.segment_reduce.ops import SegmentMap, segment_sum

PAGE_SIZE = 4096  # bytes, Linux page

# Operation codes.
READ = 0
WRITE = 1

F64 = torch.float64


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Physical constants of the simulated cluster (the reference's
    defaults, calibrated on the paper's CloudLab testbed)."""

    tick: float = 0.005                # simulation step [s]
    ost_bandwidth: float = 520e6       # per-OST service bandwidth [B/s]
    ost_setup_parallel: float = 4.0    # concurrent setup contexts per OST
    ost_iops: float = 2600.0           # per-OST RPC completions per second
    setup_time_seq: float = 300e-6     # fixed overhead per sequential RPC [s]
    setup_time_rand: float = 3.5e-3    # extra overhead for fully random RPC [s]
    rtt: float = 120e-6                # client<->OSS network round trip [s]
    nic_bandwidth: float = 2.9e9       # per-client NIC cap [B/s]
    hold_time_read: float = 0.012      # OSC holds a partial read RPC [s]
    hold_time_write: float = 0.025     # writes plug longer (write-behind)
    ost_buffer_bytes: float = 64 * 2**20  # OST service-queue comfort zone
    congestion_exp: float = 0.35       # service efficiency decay past buffer
    max_dirty_bytes: float = 64 * 2**20   # per-OSC dirty cache limit
    grant_bytes: float = 96 * 2**20       # per-OSC server grant
    readahead_bytes: float = 8 * 2**20 # client readahead pipeline depth
    max_rpc_queue: int = 4096          # formed-but-unsent RPC cap per OSC

    def setup_time(self, randomness):
        """Per-RPC fixed overhead as a function of access randomness in [0,1]."""
        return self.setup_time_seq + randomness * self.setup_time_rand

    def hold_time(self, op: int) -> float:
        return self.hold_time_read if op == READ else self.hold_time_write


@dataclasses.dataclass(frozen=True)
class Disturbance:
    """One tick of exogenous conditions (a leading time axis makes a
    schedule).  The neutral values are exact arithmetic identities."""

    bw_scale: torch.Tensor    # (n_osts,) multiplier on OST bandwidth
    iops_scale: torch.Tensor  # (n_osts,) multiplier on setup/IOPS capacity
    bg_bytes: torch.Tensor    # (n_osts,) background bytes this tick
    nic_scale: torch.Tensor   # (n_clients,) multiplier on client NIC cap

    @classmethod
    def neutral(cls, n_osts: int, n_clients: int, device,
                n_ticks: int | None = None) -> "Disturbance":
        """Identity disturbance; with ``n_ticks`` a whole schedule."""
        lead = () if n_ticks is None else (n_ticks,)
        ones = lambda n: torch.ones(lead + (n,), dtype=F64, device=device)
        return cls(bw_scale=ones(n_osts), iops_scale=ones(n_osts),
                   bg_bytes=torch.zeros(lead + (n_osts,), dtype=F64,
                                        device=device),
                   nic_scale=ones(n_clients))

    def at_tick(self, i: int) -> "Disturbance":
        """Tick ``i`` of a schedule."""
        return Disturbance(bw_scale=self.bw_scale[i],
                           iops_scale=self.iops_scale[i],
                           bg_bytes=self.bg_bytes[i],
                           nic_scale=self.nic_scale[i])

    def to(self, device) -> "Disturbance":
        """The same values as float64 tensors on ``device`` (from tensors
        or from numpy arrays, as :func:`repro_torch.lab.scenarios.
        make_schedule` builds them)."""
        return Disturbance(*(
            torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                            dtype=F64, device=device)
            for a in (self.bw_scale, self.iops_scale, self.bg_bytes,
                      self.nic_scale)))


@dataclasses.dataclass(frozen=True)
class SimTopo:
    """Static topology: the (client, OST) -> OSC wiring.

    A directly built topology is dense, one OSC per (client, OST) pair
    like Lustre LOV (:meth:`dense`).  A batch of scenarios runs as one
    block-diagonal topology (:meth:`from_wiring`; see
    :mod:`repro_torch.lab.batch`), so ``n_osc`` is the wiring's length.
    ``ost_valid`` / ``client_valid`` mark the real slots when a topology
    was padded up to a ragged-batch shape class (``None``: all real).
    Phantom slots carry exact arithmetic identities everywhere, so the
    masks are bookkeeping for the probing and tuning layers; the engine
    never reads them.
    """

    n_clients: int
    n_osts: int
    osc_client: torch.Tensor   # (n_osc,) int64 owning client of each OSC
    osc_ost: torch.Tensor      # (n_osc,) int64 backing OST of each OSC
    ost_map: SegmentMap        # OSC -> OST reduction
    client_map: SegmentMap     # OSC -> client reduction
    neutral: Disturbance       # the identity disturbance of this topology
    ost_valid: torch.Tensor | None = None     # (n_osts,) bool; None = all
    client_valid: torch.Tensor | None = None  # (n_clients,) bool; None = all

    @property
    def n_osc(self) -> int:
        return self.osc_ost.shape[0]

    @property
    def device(self) -> torch.device:
        return self.osc_ost.device

    @classmethod
    def from_wiring(cls, n_clients: int, n_osts: int, osc_client, osc_ost,
                    device, ost_valid=None,
                    client_valid=None) -> "SimTopo":
        """A topology from its ``(n_osc,)`` wiring arrays, the segment
        maps built once here."""
        osc_client = np.asarray(osc_client, dtype=np.int64)
        osc_ost = np.asarray(osc_ost, dtype=np.int64)
        mask = lambda m: None if m is None else torch.as_tensor(  # noqa: E731
            np.asarray(m, dtype=bool), device=device)
        return cls(
            n_clients=int(n_clients), n_osts=int(n_osts),
            osc_client=torch.as_tensor(osc_client, device=device),
            osc_ost=torch.as_tensor(osc_ost, device=device),
            ost_map=SegmentMap.build(osc_ost, n_osts, device),
            client_map=SegmentMap.build(osc_client, n_clients, device),
            neutral=Disturbance.neutral(n_osts, n_clients, device),
            ost_valid=mask(ost_valid), client_valid=mask(client_valid))

    @classmethod
    def dense(cls, n_clients: int, n_osts: int, device, ost_valid=None,
              client_valid=None) -> "SimTopo":
        return cls.from_wiring(
            n_clients, n_osts, np.repeat(np.arange(n_clients), n_osts),
            np.tile(np.arange(n_osts), n_clients), device,
            ost_valid=ost_valid, client_valid=client_valid)

    def osc_id(self, client: int, ost: int) -> int:
        """A dense topology's interface of (client, OST)."""
        return client * self.n_osts + ost

    def ost_valid_mask(self) -> torch.Tensor:
        if self.ost_valid is None:
            return torch.ones(self.n_osts, dtype=torch.bool,
                              device=self.device)
        return self.ost_valid

    def client_valid_mask(self) -> torch.Tensor:
        if self.client_valid is None:
            return torch.ones(self.n_clients, dtype=torch.bool,
                              device=self.device)
        return self.client_valid

    def osc_valid(self) -> torch.Tensor:
        """(n_osc,) bool: an interface is real iff both its ends are."""
        return (self.client_valid_mask()[self.osc_client]
                & self.ost_valid_mask()[self.osc_ost])


@dataclasses.dataclass
class SimState:
    """All mutable engine state: knobs, per-op fluid state (2, n), the
    write path, and the cumulative counters the client can probe.

    The clock (``now``, ``tick_index``) is a Python float and int on the
    host paths, or 0-dim float64 / int64 tensors on the device (the
    fused loop's, so that a captured interval reads the time it runs
    at); :func:`engine_step` does the same float64 operations either way.
    """

    now: float | torch.Tensor
    tick_index: int | torch.Tensor
    # --- tunable knobs (DIAL's theta), per OSC, int64 -----------------
    window_pages: torch.Tensor
    rpcs_in_flight: torch.Tensor
    # --- per-OSC, per-op fluid state (2, n) ----------------------------
    pending: torch.Tensor
    hold_age: torch.Tensor
    queue_rpcs: torch.Tensor
    queue_bytes: torch.Tensor
    active_rpcs: torch.Tensor
    setup_work: torch.Tensor
    unready_bytes: torch.Tensor
    ready_bytes: torch.Tensor
    active_avg_size: torch.Tensor
    dispatch_time_num: torch.Tensor
    randomness: torch.Tensor
    # --- write path extras (n,) ----------------------------------------
    dirty_bytes: torch.Tensor
    grant_used: torch.Tensor
    write_blocked: torch.Tensor    # bool
    # --- cumulative counters (the probed "/proc" surface) --------------
    ctr_bytes_done: torch.Tensor
    ctr_rpcs_sent: torch.Tensor
    ctr_rpc_bytes: torch.Tensor
    ctr_partial_rpcs: torch.Tensor
    ctr_latency_sum: torch.Tensor
    ctr_rpcs_done: torch.Tensor
    ctr_req_count: torch.Tensor
    ctr_req_bytes: torch.Tensor
    ctr_cache_hit_bytes: torch.Tensor
    ctr_block_time: torch.Tensor
    ctr_pending_integral: torch.Tensor
    ctr_active_integral: torch.Tensor
    ctr_dirty_integral: torch.Tensor
    ctr_grant_integral: torch.Tensor


def init_state(topo: SimTopo) -> SimState:
    """Fresh state for a topology: Lustre-default knobs, everything idle."""
    n, dev = topo.n_osc, topo.device
    zeros2 = lambda: torch.zeros((2, n), dtype=F64, device=dev)
    zeros = lambda: torch.zeros(n, dtype=F64, device=dev)
    return SimState(
        now=0.0,
        tick_index=0,
        window_pages=torch.full((n,), 256, dtype=torch.int64, device=dev),
        rpcs_in_flight=torch.full((n,), 8, dtype=torch.int64, device=dev),
        pending=zeros2(), hold_age=zeros2(), queue_rpcs=zeros2(),
        queue_bytes=zeros2(), active_rpcs=zeros2(), setup_work=zeros2(),
        unready_bytes=zeros2(), ready_bytes=zeros2(),
        active_avg_size=torch.full((2, n), float(PAGE_SIZE), dtype=F64,
                                   device=dev),
        dispatch_time_num=zeros2(), randomness=zeros2(),
        dirty_bytes=zeros(), grant_used=zeros(),
        write_blocked=torch.zeros(n, dtype=torch.bool, device=dev),
        ctr_bytes_done=zeros2(), ctr_rpcs_sent=zeros2(),
        ctr_rpc_bytes=zeros2(), ctr_partial_rpcs=zeros2(),
        ctr_latency_sum=zeros2(), ctr_rpcs_done=zeros2(),
        ctr_req_count=zeros2(), ctr_req_bytes=zeros2(),
        ctr_cache_hit_bytes=zeros(), ctr_block_time=zeros(),
        ctr_pending_integral=zeros2(), ctr_active_integral=zeros2(),
        ctr_dirty_integral=zeros(), ctr_grant_integral=zeros(),
    )


@dataclasses.dataclass
class Demand:
    """One tick of workload submissions, resolved to per-OSC deltas
    (see :meth:`repro_torch.pfs.workloads.WorkloadTable.demand_step`)."""

    pending_read_add: torch.Tensor    # (n,) bytes entering the read pipeline
    dirty_add: torch.Tensor           # (n,) write bytes accepted into cache
    req_count_add: torch.Tensor       # (2, n)
    req_bytes_add: torch.Tensor       # (2, n)
    cache_hit_add: torch.Tensor       # (n,)
    randomness_new: torch.Tensor      # (2, n) absolute (EMA already applied)
    write_blocked_new: torch.Tensor   # (n,) bool, absolute


def _pow(x: torch.Tensor, e: float) -> torch.Tensor:
    """``x ** e``: numpy's ``power`` on the CPU, the correctly rounded
    ``pow_cr`` kernel on the card.

    The congestion factor it computes feeds a near-zero leftover whose
    sign a last bit can flip, so this one operation decides whether two
    devices agree.  The CPU path is the reference numpy engine's own
    ``power`` (``torch.pow`` rounds otherwise), so the port's CPU engine
    equals the reference's on the same host.  On the card ``torch.pow``
    is off by an ulp on ~23% of inputs; ``pow_cr`` returns the nearest
    double, as libm's ``pow`` does but within ~0.1% of its inputs.
    numpy's ``power`` is libm's or, on an AVX-512 host, SVML's (off on
    ~5% of inputs), which no card kernel reproduces (ROADMAP Queue 3).
    """
    if x.device.type == "cpu":
        return torch.from_numpy(np.power(x.numpy(), e))
    return pow_cr_cuda(x.contiguous(), e)


def _div_where(num, den, cond, fallback):
    """``np.divide(num, den, out=fallback, where=cond)``, functionally."""
    return torch.where(cond, num / torch.where(cond, den, 1.0), fallback)


def engine_step(params: SimParams, topo: SimTopo, state: SimState,
                demand: Demand | None = None,
                disturbance: Disturbance | None = None) -> SimState:
    """One pure engine tick; the input state is not modified.

    formation -> dispatch -> OST drain -> bandwidth -> completion ->
    accounting, as in the reference.  ``disturbance=None`` is the
    neutral identity.  A tensor clock stays a tensor (see
    :class:`SimState`), bit-equal to the float clock.
    """
    p = params
    dt = p.tick
    osc_ost, osc_client = topo.osc_ost, topo.osc_client
    ost_sum = lambda v: segment_sum(v, topo.ost_map)
    dist = disturbance if disturbance is not None else topo.neutral

    rows = lambda a: [a[READ], a[WRITE]]
    pending, hold_age = rows(state.pending), rows(state.hold_age)
    queue_rpcs, queue_bytes = rows(state.queue_rpcs), rows(state.queue_bytes)
    active_rpcs, setup_work = rows(state.active_rpcs), rows(state.setup_work)
    unready, ready_b = rows(state.unready_bytes), rows(state.ready_bytes)
    avg_size, disp_num = rows(state.active_avg_size), rows(state.dispatch_time_num)
    randomness = rows(state.randomness)
    ctr_bytes_done = rows(state.ctr_bytes_done)
    ctr_rpcs_sent, ctr_rpc_bytes = rows(state.ctr_rpcs_sent), rows(state.ctr_rpc_bytes)
    ctr_partial, ctr_lat = rows(state.ctr_partial_rpcs), rows(state.ctr_latency_sum)
    ctr_rpcs_done = rows(state.ctr_rpcs_done)
    ctr_pend_int = rows(state.ctr_pending_integral)
    ctr_act_int = rows(state.ctr_active_integral)
    ctr_req_count, ctr_req_bytes = state.ctr_req_count, state.ctr_req_bytes
    ctr_cache_hit = state.ctr_cache_hit_bytes
    dirty, grant, blocked = state.dirty_bytes, state.grant_used, state.write_blocked
    now = state.now

    # (1) workloads deposit demand
    if demand is not None:
        pending[READ] = pending[READ] + demand.pending_read_add
        dirty = dirty + demand.dirty_add
        grant = grant + demand.dirty_add
        ctr_req_count = ctr_req_count + demand.req_count_add
        ctr_req_bytes = ctr_req_bytes + demand.req_bytes_add
        ctr_cache_hit = ctr_cache_hit + demand.cache_hit_add
        ctr_bytes_done[WRITE] = ctr_bytes_done[WRITE] + demand.dirty_add
        randomness = rows(demand.randomness_new)
        blocked = demand.write_blocked_new

    # write path: dirty cache continuously feeds the pending queue
    in_pipe = (pending[WRITE] + queue_bytes[WRITE]
               + unready[WRITE] + ready_b[WRITE])
    pending[WRITE] = pending[WRITE] + torch.clamp_min(dirty - in_pipe, 0.0)

    # (2) RPC formation: full windows pack immediately; partials wait
    win_bytes = (state.window_pages * PAGE_SIZE).to(F64)
    for op in (READ, WRITE):
        pend = pending[op]
        room = torch.clamp_min(p.max_rpc_queue - queue_rpcs[op], 0.0)
        n_full = torch.minimum(torch.floor(pend / win_bytes), room)
        full_bytes = n_full * win_bytes
        queue_rpcs[op] = queue_rpcs[op] + n_full
        queue_bytes[op] = queue_bytes[op] + full_bytes
        pend = pend - full_bytes
        hold_age[op] = torch.where(pend > 0, hold_age[op] + dt, 0.0)
        expire = (pend > 0) & (hold_age[op] >= p.hold_time(op)) & (room > n_full)
        queue_rpcs[op] = queue_rpcs[op] + expire
        queue_bytes[op] = queue_bytes[op] + torch.where(expire, pend, 0.0)
        ctr_partial[op] = ctr_partial[op] + expire
        pending[op] = torch.where(expire, 0.0, pend)
        hold_age[op] = torch.where(expire, 0.0, hold_age[op])

    # (3) dispatch up to rpcs_in_flight (reads first: sync-read bias)
    slots = torch.clamp_min(
        state.rpcs_in_flight - (active_rpcs[READ] + active_rpcs[WRITE]), 0.0)
    for op in (READ, WRITE):
        take = torch.minimum(queue_rpcs[op], slots)
        frac = _div_where(take, queue_rpcs[op], queue_rpcs[op] > 0, 0.0)
        bytes_out = queue_bytes[op] * frac
        queue_rpcs[op] = queue_rpcs[op] - take
        queue_bytes[op] = queue_bytes[op] - bytes_out
        slots = slots - take
        active_rpcs[op] = active_rpcs[op] + take
        per_rpc = p.setup_time(randomness[op]) + p.rtt
        setup_work[op] = setup_work[op] + take * per_rpc
        unready[op] = unready[op] + bytes_out
        tot_bytes = unready[op] + ready_b[op]
        avg_size[op] = torch.where(
            active_rpcs[op] > 0,
            tot_bytes / torch.clamp_min(active_rpcs[op], 1e-9), avg_size[op])
        ctr_rpcs_sent[op] = ctr_rpcs_sent[op] + take
        ctr_rpc_bytes[op] = ctr_rpc_bytes[op] + bytes_out
        disp_num[op] = disp_num[op] + take * now

    # (4) OST setup service + IOPS ceiling, both ops as the rows of one
    # (2, n_osc) block, so their per-OST setups are one segment sum
    ost_work = ost_sum(setup_work[READ] + setup_work[WRITE])
    cap = dt * p.ost_setup_parallel * dist.iops_scale
    drain_frac_ost = _div_where(cap, ost_work, ost_work > cap, 1.0)
    work = torch.stack(setup_work)
    drained = work * drain_frac_ost[osc_ost]
    per_rpc = p.setup_time(torch.stack(randomness)) + p.rtt
    setups_done = _div_where(drained, per_rpc, per_rpc > 0, 0.0)
    ost_setups = ost_sum(setups_done)
    iops_cap = p.ost_iops * dt * dist.iops_scale
    iops_frac = _div_where(iops_cap, ost_setups, ost_setups > iops_cap, 1.0)
    effective = drained * iops_frac[:, osc_ost]
    for op in (READ, WRITE):
        setup_work[op] = work[op] - effective[op]
        ready = torch.minimum(
            _div_where(effective[op], per_rpc[op], per_rpc[op] > 0, 0.0)
            * avg_size[op], unready[op])
        ready = torch.where(setup_work[op] <= 1e-12, unready[op], ready)
        unready[op] = unready[op] - ready
        ready_b[op] = ready_b[op] + ready

    # (5) bandwidth: OST fair share + congestion decay + NIC cap
    want = ready_b[READ] + ready_b[WRITE]
    queued = unready[READ] + unready[WRITE] + ready_b[READ] + ready_b[WRITE]
    active_transfer = torch.where(want > 0,
                                  active_rpcs[READ] + active_rpcs[WRITE], 0.0)
    ost_queued, ost_active = ost_sum(torch.stack([queued, active_transfer]))
    ost_queued = ost_queued + dist.bg_bytes
    eff = torch.where(
        ost_queued > p.ost_buffer_bytes,
        _pow(p.ost_buffer_bytes / torch.clamp_min(ost_queued, 1.0),
             p.congestion_exp),
        1.0)
    ost_shares = ost_active[osc_ost]
    share = _div_where(active_transfer, ost_shares, ost_shares > 0, 0.0)
    ost_bw_eff = p.ost_bandwidth * dist.bw_scale * eff
    # background traffic is served first, shrinking the foreground
    # budget; written as a subtraction so the zero-background case keeps
    # the reference's multiplication order bit for bit
    bg_served = torch.minimum(dist.bg_bytes, ost_bw_eff * dt)
    alloc = torch.minimum(
        share * ost_bw_eff[osc_ost] * dt - share * bg_served[osc_ost], want)
    hungry = want - alloc
    ost_alloc, ost_hungry = ost_sum(torch.stack([alloc, hungry]))
    leftover = (ost_bw_eff * dt - bg_served) - ost_alloc
    bonus_frac = _div_where(leftover, ost_hungry, ost_hungry > 0, 0.0)
    alloc = alloc + hungry * torch.clamp_max(bonus_frac[osc_ost], 1.0)
    nic_cap = p.nic_bandwidth * dist.nic_scale * dt
    client_alloc = segment_sum(alloc, topo.client_map)
    nic_frac = _div_where(nic_cap, client_alloc, client_alloc > nic_cap, 1.0)
    alloc = alloc * nic_frac[osc_client]

    # (6) completions
    for op in (READ, WRITE):
        frac = _div_where(ready_b[op], want, want > 0, 0.0)
        drained = alloc * frac
        ready_b[op] = ready_b[op] - drained
        avg = torch.clamp_min(avg_size[op], 1.0)
        done_rpcs = torch.minimum(drained / avg, active_rpcs[op])
        inflight_bytes = unready[op] + ready_b[op]
        done_rpcs = torch.where(inflight_bytes <= 1e-9, active_rpcs[op],
                                done_rpcs)
        prev_active = active_rpcs[op]
        active_rpcs[op] = active_rpcs[op] - done_rpcs
        ctr_rpcs_done[op] = ctr_rpcs_done[op] + done_rpcs
        if op == READ:
            ctr_bytes_done[READ] = ctr_bytes_done[READ] + drained
        else:
            # flushed bytes leave the dirty cache and release grant
            dirty = torch.clamp_min(dirty - drained, 0.0)
            grant = torch.clamp_min(grant - drained, 0.0)
        avg_disp = disp_num[op] / torch.clamp_min(prev_active, 1e-9)
        lat = torch.clamp_min(now + dt - avg_disp, dt)
        ctr_lat[op] = ctr_lat[op] + done_rpcs * lat
        keep = active_rpcs[op] / torch.clamp_min(prev_active, 1e-9)
        disp_num[op] = disp_num[op] * keep

    # blocked-writer accounting (workloads stop issuing while blocked)
    ctr_block_time = state.ctr_block_time + blocked.to(F64) * dt
    room = torch.minimum(p.max_dirty_bytes - dirty, p.grant_bytes - grant)
    blocked = blocked & (room < PAGE_SIZE)

    # time-integrals for interval averages
    for op in (READ, WRITE):
        ctr_pend_int[op] = ctr_pend_int[op] + (pending[op] + queue_bytes[op]) * dt
        ctr_act_int[op] = ctr_act_int[op] + active_rpcs[op] * dt

    return SimState(
        now=now + dt,
        tick_index=state.tick_index + 1,
        window_pages=state.window_pages,
        rpcs_in_flight=state.rpcs_in_flight,
        pending=torch.stack(pending),
        hold_age=torch.stack(hold_age),
        queue_rpcs=torch.stack(queue_rpcs),
        queue_bytes=torch.stack(queue_bytes),
        active_rpcs=torch.stack(active_rpcs),
        setup_work=torch.stack(setup_work),
        unready_bytes=torch.stack(unready),
        ready_bytes=torch.stack(ready_b),
        active_avg_size=torch.stack(avg_size),
        dispatch_time_num=torch.stack(disp_num),
        randomness=torch.stack(randomness),
        dirty_bytes=dirty,
        grant_used=grant,
        write_blocked=blocked,
        ctr_bytes_done=torch.stack(ctr_bytes_done),
        ctr_rpcs_sent=torch.stack(ctr_rpcs_sent),
        ctr_rpc_bytes=torch.stack(ctr_rpc_bytes),
        ctr_partial_rpcs=torch.stack(ctr_partial),
        ctr_latency_sum=torch.stack(ctr_lat),
        ctr_rpcs_done=torch.stack(ctr_rpcs_done),
        ctr_req_count=ctr_req_count,
        ctr_req_bytes=ctr_req_bytes,
        ctr_cache_hit_bytes=ctr_cache_hit,
        ctr_block_time=ctr_block_time,
        ctr_pending_integral=torch.stack(ctr_pend_int),
        ctr_active_integral=torch.stack(ctr_act_int),
        ctr_dirty_integral=state.ctr_dirty_integral + dirty * dt,
        ctr_grant_integral=state.ctr_grant_integral + grant * dt,
    )
