"""Declarative scenarios: topology + workload mix + disturbance schedule.

The port's copy of the reference's ``repro/lab/scenarios.py`` (numpy
host code): the same events, validation, schedules, specs, jitter and
catalog.  A :class:`ScenarioSpec` is a pure-data description of one
simulated cluster run.  :func:`build` checks it and stages it on the
host as plain data (its workload table's numpy arrays):
:func:`repro_torch.lab.batch.stack_scenarios` lays a batch of staged
elements out as one fleet on its device in one pass.  A
:class:`BuiltScenario` makes its own engine pieces (CPU tensors) only
when a caller reads them.  :func:`make_schedule` compiles the events
into a per-tick :class:`~repro_torch.pfs.state.Disturbance` of numpy
arrays (a pure function of the absolute tick index, so interval
boundaries cannot disagree); a run copies it to the device once.

Disturbances are *exogenous*: conditions no client controls or observes
directly.

    ``ost_slow``      scale an OST's bandwidth *and* setup/IOPS capacity;
    ``bg_burst``      background bytes/s arriving at an OST from clients
                      outside the simulated fleet (noisy neighbours),
                      served first;
    ``nic_slow``      scale a client's NIC ceiling (heterogeneous links);
    ``ost_fail``      hard OST outage: bandwidth and IOPS scale to
                      ``magnitude`` (default 0) inside the window;
    ``ost_failover``  fail, then ramp linearly back to full capacity
                      over ``recovery`` seconds after ``end``;
    ``client_evict``  the client's NIC scale drops to ``magnitude``
                      (default 0) until reconnection.

The registry at the bottom names the paper evaluation setups
(vpic / bdcats / dlio / filebench) and beyond-paper stress scenarios;
``python -m repro_torch.lab list`` prints the catalog.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.config_space import DEFAULT
from repro_torch.obs.timers import span
from repro_torch.pfs.state import (READ, WRITE, Disturbance, SimParams,
                                   SimState, SimTopo, init_state)
from repro_torch.pfs.workloads import (WorkloadState, WorkloadTable,
                                       bdcats_read, dlio_reader,
                                       random_stream, sequential_stream,
                                       vpic_write)

HOST = torch.device("cpu")


# ---------------------------------------------------------------------- #
# disturbance events -> per-tick schedules
# ---------------------------------------------------------------------- #
# kinds whose targets index OSTs vs clients, and kinds that express a
# capacity *outage* (scale drops toward 0 inside the window) vs a
# steady-state degradation
EVENT_KINDS = ("ost_slow", "bg_burst", "nic_slow",
               "ost_fail", "ost_failover", "client_evict")
CLIENT_KINDS = ("nic_slow", "client_evict")
FAULT_KINDS = ("ost_fail", "ost_failover", "client_evict")


@dataclasses.dataclass(frozen=True)
class DisturbanceEvent:
    """One piecewise/periodic exogenous condition.

    Active on ticks whose time ``t`` satisfies ``start <= t < end`` and,
    when ``period > 0``, ``(t - start) mod period < duty * period``
    (square-wave bursting).  ``magnitude`` is a scale factor for the
    ``*_slow`` kinds, background bytes/second for ``bg_burst``, and the
    residual capacity fraction during the outage for the fault kinds
    (``ost_fail`` / ``ost_failover`` / ``client_evict``, default 0 —
    hard offline).  ``recovery`` (``ost_failover`` only) is the number
    of seconds after ``end`` the target takes to ramp linearly from
    ``magnitude`` back to full capacity.

    Construction validates every field — a malformed event raises
    ``ValueError`` here, at the event/spec boundary, instead of passing
    silently into :func:`make_schedule` or crashing deep inside it.
    """

    kind: str                 # one of EVENT_KINDS
    targets: tuple            # OST ids, or client ids for CLIENT_KINDS
    magnitude: float = 0.0
    start: float = 0.0        # seconds
    end: float = math.inf
    period: float = 0.0       # 0 -> constant while inside [start, end)
    duty: float = 1.0
    recovery: float = 0.0     # seconds; ost_failover ramp-back window

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown disturbance kind {self.kind!r}; "
                             f"known: {', '.join(EVENT_KINDS)}")
        tgts = tuple(self.targets)
        if not tgts:
            raise ValueError(f"{self.kind}: empty targets — an event must "
                             "name at least one OST/client id")
        if any((not float(x).is_integer()) or x < 0 for x in tgts):
            raise ValueError(f"{self.kind}: targets must be non-negative "
                             f"integer ids, got {tgts!r}")
        if not (math.isfinite(self.magnitude) and self.magnitude >= 0):
            raise ValueError(f"{self.kind}: magnitude must be finite and "
                             f">= 0, got {self.magnitude!r}")
        if self.kind in ("ost_slow", "nic_slow") and self.magnitude == 0:
            raise ValueError(f"{self.kind}: magnitude must be > 0 (use "
                             "ost_fail/client_evict for a hard outage)")
        if self.kind in FAULT_KINDS and self.magnitude >= 1.0:
            raise ValueError(f"{self.kind}: residual capacity magnitude "
                             f"must be < 1, got {self.magnitude!r}")
        if not (math.isfinite(self.start) and self.start >= 0):
            raise ValueError(f"{self.kind}: start must be finite and >= 0, "
                             f"got {self.start!r}")
        if not self.end > self.start:
            raise ValueError(f"{self.kind}: end ({self.end!r}) must be > "
                             f"start ({self.start!r})")
        if not (math.isfinite(self.period) and self.period >= 0):
            raise ValueError(f"{self.kind}: period must be finite and "
                             f">= 0, got {self.period!r}")
        if not 0.0 < self.duty <= 1.0:
            raise ValueError(f"{self.kind}: duty must be in (0, 1], got "
                             f"{self.duty!r}")
        if not (math.isfinite(self.recovery) and self.recovery >= 0):
            raise ValueError(f"{self.kind}: recovery must be finite and "
                             f">= 0, got {self.recovery!r}")
        if self.kind == "ost_failover":
            if self.recovery <= 0:
                raise ValueError("ost_failover: recovery must be > 0 — a "
                                 "zero-length ramp is ost_fail")
            if not math.isfinite(self.end):
                raise ValueError("ost_failover: end must be finite (the "
                                 "ramp starts when the outage ends)")
            if self.period > 0:
                raise ValueError("ost_failover: period must be 0 (a ramp "
                                 "after a square wave is ill-defined; "
                                 "use periodic ost_fail for flapping)")
        elif self.recovery != 0:
            raise ValueError(f"{self.kind}: recovery only applies to "
                             "ost_failover")

    def active(self, t: np.ndarray) -> np.ndarray:
        act = (t >= self.start) & (t < self.end)
        if self.period > 0:
            act &= np.mod(t - self.start, self.period) < self.duty * self.period
        return act

    def capacity_scale(self, t: np.ndarray) -> np.ndarray:
        """Per-tick capacity multiplier for the fault kinds.

        ``magnitude`` inside the active window, 1 outside; ost_failover
        additionally ramps linearly from ``magnitude`` at ``end`` to 1
        at ``end + recovery`` instead of snapping back.
        """
        scale = np.where(self.active(t), self.magnitude, 1.0)
        if self.kind == "ost_failover":
            frac = (t - self.end) / self.recovery
            in_ramp = (t >= self.end) & (frac < 1.0)
            scale = np.where(
                in_ramp, self.magnitude + (1.0 - self.magnitude) * frac,
                scale)
        return scale


def validate_events(events, topo: SimTopo) -> None:
    """Check every event's target ids against a topology.

    Field-level validation happens at event construction; this is the
    spec-level half — an OST id >= ``n_osts`` (or client id >=
    ``n_clients``) would otherwise scatter out of bounds inside
    :func:`make_schedule`.
    """
    for ev in events:
        n = (topo.n_clients if ev.kind in CLIENT_KINDS else topo.n_osts)
        what = "client" if ev.kind in CLIENT_KINDS else "OST"
        bad = [x for x in ev.targets if not 0 <= int(x) < n]
        if bad:
            raise ValueError(
                f"{ev.kind}: {what} target ids {bad} out of range for a "
                f"{topo.n_clients}-client x {topo.n_osts}-OST topology")


def make_schedule(events, topo: SimTopo, params: SimParams,
                  t0_tick: int, n_ticks: int) -> Disturbance:
    """Compile events into one interval's per-tick Disturbance schedule
    (``(n_ticks, ...)`` numpy arrays).

    Pure function of the absolute tick index ``t0_tick + i``, so
    consecutive intervals tile seamlessly and every path sees the
    identical exogenous world.
    """
    validate_events(events, topo)
    t = (t0_tick + np.arange(n_ticks)) * params.tick
    sched = Disturbance(bw_scale=np.ones((n_ticks, topo.n_osts)),
                        iops_scale=np.ones((n_ticks, topo.n_osts)),
                        bg_bytes=np.zeros((n_ticks, topo.n_osts)),
                        nic_scale=np.ones((n_ticks, topo.n_clients)))
    for ev in events:
        cols = np.asarray(ev.targets, dtype=np.int64)
        if ev.kind == "ost_slow":
            scale = np.where(ev.active(t), ev.magnitude, 1.0)[:, None]
            sched.bw_scale[:, cols] *= scale
            sched.iops_scale[:, cols] *= scale
        elif ev.kind in ("ost_fail", "ost_failover"):
            scale = ev.capacity_scale(t)[:, None]
            sched.bw_scale[:, cols] *= scale
            sched.iops_scale[:, cols] *= scale
        elif ev.kind == "bg_burst":
            sched.bg_bytes[:, cols] += (ev.active(t) * ev.magnitude
                                        * params.tick)[:, None]
        elif ev.kind == "nic_slow":
            sched.nic_scale[:, cols] *= np.where(ev.active(t), ev.magnitude,
                                                 1.0)[:, None]
        else:                            # client_evict (kinds are closed
            scale = ev.capacity_scale(t)[:, None]        # at construction)
            sched.nic_scale[:, cols] *= scale
    return sched


# ---------------------------------------------------------------------- #
# scenario spec + build
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """Pure-data description of one simulated run.

    ``workloads`` holds unbound :class:`~repro_torch.pfs.workloads.Workload`
    rows (the presets stay the row constructors); ``events`` the
    exogenous disturbance schedule; ``initial_theta`` the knob setting
    every OSC starts from (the Lustre default unless the scenario is
    meant to demonstrate recovery from a pathological config).

    The engine itself is deterministic: two builds of the same spec run
    bit-identically.  ``seed`` seeds the *structure-preserving jitter*
    :func:`variants` derives fan-out populations from — diversity across
    a batch comes from jittered parameters and disturbance phases, not
    from engine noise.
    """

    name: str
    n_clients: int
    n_osts: int
    workloads: tuple = ()
    events: tuple = ()
    initial_theta: tuple = DEFAULT      # (window_pages, rpcs_in_flight)
    seed: int = 0
    description: str = ""
    tags: tuple = ()

    def make_workloads(self) -> list:
        """Fresh (unshared) Workload row instances for attaching to sims."""
        return [dataclasses.replace(w) for w in self.workloads]


# the span of one element's engine pieces made from its staged data
# (the benchmark's ``materialize_ms_per_interval.lab`` reads it)
MATERIALIZE_SPAN = "lab.materialize"


@functools.lru_cache(maxsize=64)
def _host_topo(n_clients: int, n_osts: int) -> SimTopo:
    """A dense host topology of this shape, shared read-only by the
    checks and layouts of every element of the shape (its sizes and
    interface ids)."""
    return SimTopo.dense(n_clients, n_osts, HOST)


class EngineParts(NamedTuple):
    """One element's engine pieces on the host."""

    topo: SimTopo
    table: WorkloadTable
    state: SimState
    wstate: WorkloadState


@dataclasses.dataclass
class BuiltScenario:
    """One checked spec on the host, ready to stack.

    Staged as plain data: ``arrays``, its workload table's numpy arrays
    (what :meth:`~repro_torch.pfs.workloads.WorkloadTable.from_arrays`
    takes), and ``n_waves``; the topology's sizes and the initial θ are
    the spec's.  ``topo``, ``table``, ``state`` and ``wstate``, the
    engine's pieces as CPU tensors, are made together the first time
    any of them is read (one :data:`MATERIALIZE_SPAN` span) and kept in
    ``parts``.  An element whose ``parts`` is ``None`` is untouched:
    :func:`~repro_torch.lab.batch.stack_scenarios` lays untouched
    elements out from their arrays and never makes their pieces.
    """

    spec: ScenarioSpec
    params: SimParams
    arrays: dict | None = None
    n_waves: int = 1
    parts: EngineParts | None = None

    @property
    def topo(self) -> SimTopo:
        return self._made().topo

    @property
    def table(self) -> WorkloadTable:
        return self._made().table

    @property
    def state(self) -> SimState:
        return self._made().state

    @property
    def wstate(self) -> WorkloadState:
        return self._made().wstate

    def _made(self) -> EngineParts:
        if self.parts is None:
            with span(MATERIALIZE_SPAN):
                spec = self.spec
                topo = SimTopo.dense(spec.n_clients, spec.n_osts, HOST)
                state = init_state(topo)
                w, f = spec.initial_theta
                state.window_pages[:] = int(w)
                state.rpcs_in_flight[:] = int(f)
                table = self.host_table()
                self.parts = EngineParts(topo, table, state,
                                         table.init_wstate(state))
        return self.parts

    def host_table(self) -> WorkloadTable:
        """A new workload table on the host from the staged arrays (a
        copy of them): the table that :attr:`table` first holds."""
        return WorkloadTable.from_arrays(
            {f: a.copy() for f, a in self.arrays.items()},
            n_osc=self.spec.n_clients * self.spec.n_osts,
            n_waves=self.n_waves, device=HOST,
            names=tuple(w.name for w in self.spec.workloads))

    @property
    def shape(self) -> tuple:
        """``(n_clients, n_osts, rows, waves, stripe entries)``: read from
        the pieces once they are made, else from the staged data."""
        if self.parts is not None:
            topo, table = self.parts.topo, self.parts.table
            return (topo.n_clients, topo.n_osts, len(table), table.n_waves,
                    table.entry_row.shape[0])
        return (self.spec.n_clients, self.spec.n_osts,
                len(self.arrays["op"]), self.n_waves,
                len(self.arrays["entry_row"]))

    def schedule(self, t0_tick: int, n_ticks: int) -> Disturbance:
        topo = (self.parts.topo if self.parts is not None
                else _host_topo(self.spec.n_clients, self.spec.n_osts))
        return make_schedule(self.spec.events, topo, self.params, t0_tick,
                             n_ticks)


def build(spec: ScenarioSpec, params: SimParams | None = None) -> BuiltScenario:
    """Check a spec against its topology and stage it on the host: its
    workload table's arrays, the reference's wave partition."""
    with span("lab.build"):
        topo = _host_topo(spec.n_clients, spec.n_osts)
        validate_events(spec.events, topo)
        arrays = WorkloadTable.arrays_from_workloads(spec.workloads, topo)
        return BuiltScenario(spec=spec, params=params or SimParams(),
                             arrays=arrays,
                             n_waves=WorkloadTable.n_waves_of(arrays))


def _jitter_event(ev: DisturbanceEvent, rng) -> DisturbanceEvent:
    """One structure-preserving event jitter (same rng draw order as the
    historical inline version: one magnitude draw, one phase draw)."""
    if ev.kind == "bg_burst":
        mag = ev.magnitude * rng.uniform(0.6, 1.4)
    elif ev.kind in FAULT_KINDS:
        # residual capacity stays a valid outage fraction (< 1)
        mag = float(np.clip(ev.magnitude * rng.uniform(0.7, 1.3), 0.0, 0.9))
    else:
        mag = float(np.clip(ev.magnitude * rng.uniform(0.7, 1.3), 0.01, 1.0))
    shift = rng.uniform(0.0, 0.5)
    # shift the whole window so finite-end events keep their duration
    # (start-only jitter could cross `end` and fail validation)
    end = ev.end if math.isinf(ev.end) else ev.end + shift
    return dataclasses.replace(ev, magnitude=mag, start=ev.start + shift,
                               end=end)


def variants(spec: ScenarioSpec, n: int, seed: int = 0) -> list[ScenarioSpec]:
    """``n`` structure-preserving jitters of a spec (for batch fan-out).

    Continuous workload parameters (request size, thread rate,
    randomness, duty cycling) and event magnitudes/phases are perturbed;
    topology, row count, stripe layout, ops — everything that defines
    the batchable *structure* — stay fixed, so any set of variants of
    one spec stacks into one batch without padding.
    """
    out = []
    for i in range(n):
        rng = np.random.default_rng((seed << 16) ^ (spec.seed << 8) ^ i)
        wls = tuple(dataclasses.replace(
            w,
            req_size=float(w.req_size) * 2.0 ** rng.uniform(-0.7, 0.7),
            thread_rate=float(w.thread_rate) * rng.uniform(0.7, 1.3),
            randomness=float(np.clip(w.randomness + rng.uniform(-0.1, 0.1),
                                     0.0, 1.0)),
            period=float(w.period) * rng.uniform(0.8, 1.25),
        ) for w in spec.workloads)
        evs = tuple(_jitter_event(ev, rng) for ev in spec.events)
        out.append(dataclasses.replace(
            spec, name=f"{spec.name}#{i}", workloads=wls, events=evs,
            seed=spec.seed + 1 + i))
    return out


# ---------------------------------------------------------------------- #
# the catalog
# ---------------------------------------------------------------------- #
SCENARIOS: dict[str, ScenarioSpec] = {}


def register(spec: ScenarioSpec) -> ScenarioSpec:
    SCENARIOS[spec.name] = spec
    return spec


def scenario_names() -> list[str]:
    return list(SCENARIOS)


def get_scenario(name: str) -> ScenarioSpec:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"known: {', '.join(SCENARIOS)}") from None


register(ScenarioSpec(
    name="vpic_checkpoint",
    n_clients=4, n_osts=4,
    workloads=tuple(vpic_write(c, dims=1 + c % 3, osts=(0, 1, 2, 3))
                    for c in range(4)),
    description="H5bench VPIC-IO checkpoint: 4 clients write contiguous "
                "particle arrays striped over all OSTs (Table II).",
    tags=("paper", "write"),
))

register(ScenarioSpec(
    name="bdcats_analysis",
    n_clients=4, n_osts=4,
    workloads=tuple(bdcats_read(c, mode, osts=(0, 1, 2, 3))
                    for c, mode in enumerate(("partial", "strided",
                                              "full", "partial"))),
    description="H5bench BDCATS-IO analysis: partial/strided/full reads "
                "of the VPIC output (Table II).",
    tags=("paper", "read"),
))

register(ScenarioSpec(
    name="dlio_bert",
    n_clients=6, n_osts=2,
    workloads=tuple(dlio_reader(c, "bert", n_threads=2 + c % 3,
                                osts=(c % 2,)) for c in range(6)),
    description="DLIO BERT input pipeline: shuffled smallish TFRecord "
                "reads in epoch bursts (Fig. 3).",
    tags=("paper", "read", "bursty"),
))

register(ScenarioSpec(
    name="dlio_megatron",
    n_clients=6, n_osts=2,
    workloads=tuple(dlio_reader(c, "megatron", n_threads=2 + c % 4,
                                osts=(c % 2,)) for c in range(6)),
    description="DLIO Megatron input pipeline: larger sequential-ish "
                "sample reads from indexed .bin files (Fig. 3).",
    tags=("paper", "read", "bursty"),
))

register(ScenarioSpec(
    name="filebench_mix",
    n_clients=8, n_osts=2,
    workloads=tuple(
        (sequential_stream(c, READ, 4 * 2**20, ost=c % 2) if c % 2 else
         random_stream(c, WRITE, 256 * 1024, ost=c % 2, n_threads=2))
        for c in range(8)),
    initial_theta=(64, 2),
    description="Filebench-style mixed streams from a pathological "
                "(64-page, 2-in-flight) start — the run_fleet recovery "
                "scenario and the disturbance-free lab anchor.",
    tags=("paper", "mixed"),
))

register(ScenarioSpec(
    name="noisy_neighbor",
    n_clients=4, n_osts=2,
    workloads=tuple(
        (sequential_stream(c, READ, 4 * 2**20, ost=c % 2) if c < 2 else
         bdcats_read(c, "strided", osts=(0, 1))) for c in range(4)),
    events=(
        DisturbanceEvent("bg_burst", targets=(0,), magnitude=450e6,
                         start=1.0, period=4.0, duty=0.5),
        DisturbanceEvent("bg_burst", targets=(1,), magnitude=450e6,
                         start=3.0, period=4.0, duty=0.5),
    ),
    description="Contention bursts: un-modeled tenants slam alternating "
                "OSTs with 450 MB/s background traffic on a 4 s square "
                "wave; local RPC latency is the only visible symptom.",
    tags=("beyond-paper", "contention-burst"),
))

register(ScenarioSpec(
    name="degraded_ost",
    n_clients=4, n_osts=4,
    workloads=tuple(
        (vpic_write(c, dims=2, osts=(0, 1, 2, 3)) if c < 2 else
         bdcats_read(c, "full", osts=(0, 1, 2, 3))) for c in range(4)),
    events=(
        DisturbanceEvent("ost_slow", targets=(1,), magnitude=0.3,
                         start=2.0),
    ),
    description="Degraded OST: one of four stripe targets drops to 30% "
                "bandwidth and IOPS mid-run (sick disk), turning every "
                "full-stripe op into a straggler problem.",
    tags=("beyond-paper", "degraded-ost"),
))

register(ScenarioSpec(
    name="failing_ost",
    n_clients=4, n_osts=4,
    workloads=tuple(bdcats_read(c, ("partial", "strided")[c % 2],
                                osts=(0, 1, 2, 3)) for c in range(4)),
    events=(
        DisturbanceEvent("ost_slow", targets=(0,), magnitude=0.05,
                         start=3.0),
    ),
    description="Failing OST: stripe target 0 collapses to 5% capacity "
                "at t=3 s and never recovers.",
    tags=("beyond-paper", "degraded-ost"),
))

register(ScenarioSpec(
    name="failover_ost",
    n_clients=4, n_osts=4,
    workloads=tuple(bdcats_read(c, ("partial", "strided")[c % 2],
                                osts=(0, 1, 2, 3)) for c in range(4)),
    events=(
        DisturbanceEvent("ost_failover", targets=(0,), start=2.0, end=4.0,
                         recovery=3.0),
    ),
    description="OST failover: stripe target 0 goes OFFLINE at t=2 s "
                "(shine MOUNTED->OFFLINE), fails back at t=4 s and ramps "
                "to full capacity over 3 s — failback onto a cold target "
                "is never instant.",
    tags=("beyond-paper", "fault", "failover"),
))

register(ScenarioSpec(
    name="client_eviction",
    n_clients=6, n_osts=2,
    workloads=tuple(dlio_reader(c, "bert", n_threads=2 + c % 3,
                                osts=(c % 2,)) for c in range(6)),
    events=(
        DisturbanceEvent("client_evict", targets=(1, 4), start=2.0,
                         end=5.0),
    ),
    description="Client eviction: clients 1 and 4 hit CLIENT_ERROR at "
                "t=2 s — NIC scale 0, queued demand stalls — and "
                "reconnect at t=5 s; survivors inherit the freed "
                "capacity and their optima shift twice.",
    tags=("beyond-paper", "fault", "eviction"),
))

register(ScenarioSpec(
    name="hetero_links",
    n_clients=8, n_osts=2,
    workloads=tuple(sequential_stream(c, READ, 8 * 2**20, ost=c % 2,
                                      n_threads=2) for c in range(8)),
    events=(
        DisturbanceEvent("nic_slow", targets=(4, 5, 6, 7), magnitude=0.12),
    ),
    description="Heterogeneous client links: half the clients sit behind "
                "a 12% NIC (edge boxes on the slow fabric); per-client "
                "optima diverge.",
    tags=("beyond-paper", "hetero-links"),
))

register(ScenarioSpec(
    name="bursty_arrivals",
    n_clients=6, n_osts=2,
    workloads=tuple(
        dataclasses.replace(
            dlio_reader(c, "bert" if c % 2 else "megatron",
                        n_threads=2 + c % 3, osts=(c % 2,)),
            duty_cycle=0.4 if c % 2 else 0.5,
            period=2.0 if c % 2 else 3.0)
        for c in range(6)),
    events=(
        DisturbanceEvent("bg_burst", targets=(0, 1), magnitude=300e6,
                         start=0.5, period=2.0, duty=0.25),
    ),
    description="Bursty arrivals: short-duty DLIO epochs plus 300 MB/s "
                "background spikes every 2 s — steady state never lasts "
                "a full tuning interval.",
    tags=("beyond-paper", "contention-burst", "bursty"),
))
