"""Batched scenario execution: a batch of scenarios as one fleet.

The counterpart of the reference's ``repro/lab/batch.py``, which
``vmap``-s one interval over a leading batch axis.  Here B scenarios
with n interfaces each run as one block-diagonal fleet of ``B * n``
interfaces on one device: element b's interface ``osc`` is fleet column
``b * n + osc``, its client ``c`` is ``b * C + c``, its OST ``o`` is
``b * O + o``, its workload row ``r`` is ``b * R + r``, and its
disturbance schedule fills its own OST and client columns.  The engine's
segment sums see one map per reduction, whose every segment holds one
element's entries in that element's own order, so a batched run is bit
for bit B separate runs, and a tick launches as many kernels whatever B
is.  ``now`` and ``tick_index`` are one clock for the batch.

Structurally identical scenarios stack directly.  Mismatched structures
stack **ragged**: every element is padded up to a shared shape class
(:func:`pad_class`: OSTs, clients, workload rows and stripe entries
rounded up to powers of two) with phantom OSTs, clients and rows whose
parameters are exact arithmetic identities, so padded runs give θ
bit-equal to unpadded ones.  :func:`bucket_scenarios` groups a
heterogeneous catalog by shape class, one run per bucket.

In-batch DIAL tuning is the fleet's: :class:`BatchPort` exposes the
batch through the fleet port surface and one
:class:`~repro_torch.core.fleet.FleetAgent` tunes every element
(``run_batch``'s host path), or the fused loop runs the whole batch on
the device, each interval one CUDA-graph replay on the card
(``fused=True``).

A :class:`~repro_torch.lab.scenarios.BuiltScenario` lives on the host;
:func:`stack_scenarios` moves the batch to its device (``device=None``
means the CUDA card) once.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.fleet import FleetAgent
from repro_torch.core.gbdt import DenseForest
from repro_torch.core.model import DIALModel
from repro_torch.core.tuner import TunerParams
from repro_torch.lab.scenarios import (HOST, BuiltScenario, make_schedule)
from repro_torch.pfs.engine_torch import FusedEngine
from repro_torch.distributed.sharding import shard_elements
from repro_torch.obs.timers import span
from repro_torch.pfs.loop_torch import (FusedLoop, FusedLoopResult,
                                        Intervention, decisions_from_trace)
from repro_torch.pfs.state import (Disturbance, SimParams, SimState, SimTopo,
                                   init_state)
from repro_torch.pfs.stats import probe_all
from repro_torch.pfs.workloads import WorkloadState, WorkloadTable

_STATE_FIELDS = tuple(f.name for f in dataclasses.fields(SimState))
_CLOCK = ("now", "tick_index")


def _fleet_topo(topo: SimTopo, n_elems: int, ost_valid, client_valid,
                device) -> SimTopo:
    """The block-diagonal topology of ``n_elems`` copies of ``topo``."""
    b = np.arange(n_elems)[:, None]
    osc_client = topo.osc_client.cpu().numpy()[None]
    osc_ost = topo.osc_ost.cpu().numpy()[None]
    return SimTopo.from_wiring(
        n_elems * topo.n_clients, n_elems * topo.n_osts,
        (b * topo.n_clients + osc_client).reshape(-1),
        (b * topo.n_osts + osc_ost).reshape(-1), device,
        ost_valid=None if ost_valid.all() else ost_valid,
        client_valid=None if client_valid.all() else client_valid)


@dataclasses.dataclass
class ScenarioBatch:
    """B scenarios of one shape as one fleet on one device.

    ``topo`` is one element's (padded) topology on the host, the shape
    every element shares; ``fleet`` the B elements' block-diagonal
    topology, and ``table`` / ``state`` / ``wstate`` the fleet's, on the
    batch's device.  ``tables`` keeps each element's table on the host,
    ``specs`` each element's spec (its disturbance schedule).

    Ragged (padded) batches also carry ``osc_cols``: one int array per
    element listing its *real* interface columns within the padded
    layout, in original interface order.  Empty ``osc_cols`` means
    nothing was padded.
    """

    params: SimParams
    topo: SimTopo
    fleet: SimTopo
    table: WorkloadTable
    state: SimState
    wstate: WorkloadState
    tables: tuple
    specs: tuple
    osc_cols: tuple = ()

    def __len__(self) -> int:
        return self.fleet.n_osc // self.topo.n_osc

    @property
    def n_osc(self) -> int:
        """Interfaces per element."""
        return self.topo.n_osc

    @property
    def device(self) -> torch.device:
        return self.fleet.device

    def element_cols(self, b: int) -> np.ndarray:
        """Element ``b``'s real interface columns, in original order."""
        if self.osc_cols:
            return np.asarray(self.osc_cols[b], dtype=np.int64)
        return np.arange(self.n_osc, dtype=np.int64)

    def real_tune_cols(self) -> np.ndarray:
        """Fleet columns (``b * n + osc``) of every real interface."""
        n = self.n_osc
        return np.concatenate([b * n + self.element_cols(b)
                               for b in range(len(self))])

    def pad_stats(self) -> dict:
        """Padding-waste accounting."""
        n = self.n_osc
        real = sum(len(self.element_cols(b)) for b in range(len(self)))
        total = len(self) * n
        return {"n_elems": len(self), "n_osc": n,
                "real_interfaces": int(real),
                "phantom_interfaces": int(total - real),
                "total_interfaces": int(total),
                "pad_waste": float(1.0 - real / total) if total else 0.0}

    def schedule(self, t0_tick: int, n_ticks: int) -> Disturbance:
        """The fleet's ``(n_ticks, ...)`` disturbance schedule (numpy):
        each element's own (neutral without events) in its OST and
        client columns."""
        with span("lab.schedule"):
            per = [make_schedule(s.events, self.topo, self.params, t0_tick,
                                 n_ticks) for s in self.specs]
            return Disturbance(*(np.concatenate(
                [getattr(d, f.name) for d in per], axis=1)
                for f in dataclasses.fields(Disturbance)))

    def stacked(self, name: str) -> np.ndarray:
        """A state field on the host with the batch's leading axis, as
        the reference's stacked batch holds it: ``(B, n)`` or ``(B, 2,
        n)``."""
        a = getattr(self.state, name).cpu().numpy()
        b, n = len(self), self.n_osc
        if a.ndim == 1:
            return a.reshape(b, n)
        return np.ascontiguousarray(
            np.moveaxis(a.reshape(a.shape[0], b, n), 0, 1))

    # ------------------------------------------------------------------ #
    def throughput(self, seconds: float) -> dict:
        """Per-element aggregate MB/s from the cumulative counters.

        The counters come to the host once and each element's real
        columns are summed there in their original order, exactly as the
        reference sums them, so per-element figures are bit-equal to an
        unpadded run's (a device reduction would group the adds
        otherwise).
        """
        done = self.stacked("ctr_bytes_done")             # (B, 2, n)
        if self.osc_cols:
            read = np.array([done[b, 0, self.element_cols(b)].sum()
                             for b in range(len(self))]) / seconds / 1e6
            write = np.array([done[b, 1, self.element_cols(b)].sum()
                              for b in range(len(self))]) / seconds / 1e6
        else:
            read = done[:, 0].sum(axis=1) / seconds / 1e6
            write = done[:, 1].sum(axis=1) / seconds / 1e6
        return {"read_mbs": read, "write_mbs": write,
                "total_mbs": read + write}


def _assemble(built: list, topo: SimTopo, osc_cols: tuple,
              device) -> ScenarioBatch:
    """Lay same-shaped built scenarios out as one fleet on ``device``."""
    b0 = built[0]
    for b in built[1:]:
        if (b.state.now, b.state.tick_index) != (b0.state.now,
                                                 b0.state.tick_index):
            raise ValueError("batch elements must share the clock")
    cat = lambda ts: torch.cat(ts, dim=-1).to(device)  # noqa: E731
    state = SimState(**{
        f: (getattr(b0.state, f) if f in _CLOCK
            else cat([getattr(b.state, f) for b in built]))
        for f in _STATE_FIELDS})
    fleet = _fleet_topo(
        topo, len(built),
        torch.cat([b.topo.ost_valid_mask() for b in built]).numpy(),
        torch.cat([b.topo.client_valid_mask() for b in built]).numpy(),
        device)
    tables = tuple(b.table for b in built)
    return ScenarioBatch(
        params=b0.params, topo=topo, fleet=fleet,
        table=WorkloadTable.block(list(tables), topo.n_clients, device),
        state=state,
        wstate=WorkloadState(cat([b.wstate.issued for b in built]),
                             cat([b.wstate.done_base for b in built])),
        tables=tables, specs=tuple(b.spec for b in built),
        osc_cols=osc_cols)


# the structure fields strict stacking compares, in check order -- the
# refusal message names the first mismatching one with both values
_STRUCTURE_FIELDS = ("params", "n_clients", "n_osts", "n_rows", "n_waves",
                     "n_entries")


def structure_key(b: BuiltScenario) -> tuple:
    """The structural signature batch elements must share to stack
    *without padding*: physics constants, topology dimensions and the
    workload table's shape (rows, waves, stripe entries)."""
    return (b.params, b.topo.n_clients, b.topo.n_osts,
            len(b.table), b.table.n_waves, b.table.entry_row.shape[0])


def _structure_mismatch(built: list[BuiltScenario]):
    """First (element index, field name, value, element-0 value) whose
    structure differs from element 0's, or ``None`` if all match."""
    k0 = structure_key(built[0])
    for i, b in enumerate(built[1:], start=1):
        k = structure_key(b)
        if k != k0:
            f = next(j for j in range(len(k)) if k[j] != k0[j])
            return i, _STRUCTURE_FIELDS[f], k[f], k0[f]
    return None


def _p2(x: int) -> int:
    """Next power of two >= x."""
    return 1 << max(int(x) - 1, 0).bit_length()


def pad_class(b: BuiltScenario) -> tuple:
    """The padded shape class ``(params, C, O, R, E, W)`` of a scenario.

    Clients and OSTs round up to the next power of two; workload rows
    and stripe entries round up to ``p2(x + 1)`` so every padded table
    owns at least one phantom row (phantom stripe entries must point at
    an inactive row to contribute exact zeros).  ``params`` rides the
    key because physics cannot be padded away.
    """
    return (b.params, _p2(b.topo.n_clients), _p2(b.topo.n_osts),
            _p2(len(b.table) + 1), _p2(b.table.entry_row.shape[0] + 1),
            _p2(b.table.n_waves))


def pad_scenario(b: BuiltScenario, cls: tuple) -> BuiltScenario:
    """Pad one built scenario up to a bucket shape class.

    Every addition is an exact arithmetic identity: phantom OSTs and
    clients join the dense topology with validity masks off and
    fresh-idle per-interface state (every reduction they join adds a
    literal ``0.0``); phantom workload rows are inert
    (:meth:`WorkloadTable.padded`).  Real interfaces keep their order
    under the remap ``new = (old // O) * O_pad + old % O_pad``, so
    ordered reductions over real columns regroup nothing.
    """
    params, nc, no, nr, ne, nw = cls
    if params != b.params:
        raise ValueError("pad class params mismatch")
    topo_old = b.topo
    if (nc, no) == (topo_old.n_clients, topo_old.n_osts):
        topo, remap = topo_old, None
    else:
        ost_valid = np.zeros(no, dtype=bool)
        ost_valid[:topo_old.n_osts] = topo_old.ost_valid_mask().numpy()
        client_valid = np.zeros(nc, dtype=bool)
        client_valid[:topo_old.n_clients] = \
            topo_old.client_valid_mask().numpy()
        topo = SimTopo.dense(nc, no, HOST, ost_valid=ost_valid,
                             client_valid=client_valid)
        old_osc = np.arange(topo_old.n_osc, dtype=np.int64)
        remap = (old_osc // topo_old.n_osts) * no + old_osc % topo_old.n_osts

    state = init_state(topo)
    for f in _STATE_FIELDS:
        old = getattr(b.state, f)
        if f in _CLOCK:
            setattr(state, f, old)
        elif remap is None:
            setattr(state, f, old.clone())
        else:
            getattr(state, f)[..., remap] = old
    table = b.table.padded(nr, ne, nw, topo.n_osc, osc_remap=remap)
    zeros = torch.zeros(nr - len(b.table), dtype=b.wstate.issued.dtype)
    wstate = WorkloadState(issued=torch.cat([b.wstate.issued, zeros]),
                           done_base=torch.cat([b.wstate.done_base, zeros]))
    return BuiltScenario(spec=b.spec, params=b.params, topo=topo,
                         table=table, state=state, wstate=wstate)


def stack_scenarios(built: list[BuiltScenario], ragged: bool = True,
                    device=None) -> ScenarioBatch:
    """Stack built scenarios into one batch on ``device`` (``None``: the
    CUDA card).

    Structurally identical elements stack directly (no padding).
    Mismatched structures are padded up to the elementwise-max
    :func:`pad_class` and stacked ragged, unless ``ragged=False``, which
    refuses (the error names the first mismatching structure field and
    both values).  ``SimParams`` must always match: the engine runs one
    physics for the whole fleet.
    """
    with span("lab.stack"):
        if not built:
            raise ValueError("empty scenario batch")
        dev = resolve_device(device)
        b0 = built[0]
        for b in built[1:]:
            if b.params != b0.params:
                raise ValueError("batch elements must share SimParams "
                                 "(the engine closes over element 0's)")
        mm = _structure_mismatch(built)
        if mm is not None and not ragged:
            i, field, v, v0 = mm
            raise ValueError(
                f"batch elements must share workload-table structure to "
                f"stack with ragged=False: element {i} has {field}={v} but "
                f"element 0 has {field}={v0} (drop ragged=False to pad-and-"
                f"mask mismatched structures into one bucket)")
        osc_cols: tuple = ()
        if mm is not None:
            classes = [pad_class(b) for b in built]
            cls = (b0.params,) + tuple(
                max(c[j] for c in classes) for j in range(1, 6))
            built = [pad_scenario(b, cls) for b in built]
            osc_cols = tuple(
                np.nonzero(b.topo.osc_valid().numpy())[0].astype(np.int64)
                for b in built)
            b0 = built[0]
        # the shared element topology is the all-valid bucket shape; the
        # elements' validity masks live on the fleet's topology
        topo = (b0.topo if mm is None
                else SimTopo.dense(b0.topo.n_clients, b0.topo.n_osts, HOST))
        return _assemble(built, topo, osc_cols, dev)


def bucket_scenarios(built: list[BuiltScenario], ragged: bool = True,
                     device=None):
    """Group a heterogeneous catalog into stackable buckets.

    Returns ``[(indices, batch), ...]`` where ``indices`` maps each batch
    element back to its position in ``built``.  With ``ragged``
    (default) scenarios group by :func:`pad_class`; with
    ``ragged=False`` by exact :func:`structure_key` (more buckets, no
    padding).  Bucket order is deterministic: sorted by shape class,
    ties by first element index.
    """
    groups: dict = {}
    for i, b in enumerate(built):
        key = pad_class(b) if ragged else structure_key(b)
        groups.setdefault(key, []).append(i)
    out = []
    for key in sorted(groups, key=lambda k: tuple(k[1:])):
        idxs = groups[key]
        out.append((idxs, stack_scenarios([built[i] for i in idxs],
                                          ragged=ragged, device=device)))
    return out


# ---------------------------------------------------------------------- #
# the host path: one interval, then one fleet tick
# ---------------------------------------------------------------------- #
class BatchEngine:
    """One tuning interval for the whole batch: the fleet's ``n_ticks``
    of ``demand_step`` then ``engine_step`` (``topo`` is the batch's
    :attr:`ScenarioBatch.fleet`)."""

    def __init__(self, params: SimParams, topo: SimTopo, n_ticks: int):
        self.params = params
        self.topo = topo
        self.n_ticks = int(n_ticks)

    def run_interval(self, table: WorkloadTable, state: SimState,
                     wstate: WorkloadState, sched: Disturbance | None = None,
                     tracer=None):
        """Advance every element one interval (``sched``: the fleet's
        ``(n_ticks, ...)`` schedule on the device, or ``None``; ``tracer``
        the host tracer sampling its ticks)."""
        return FusedEngine(self.params, self.topo, table,
                           self.n_ticks).run_interval(state, wstate, sched,
                                                      tracer)


class BatchPort:
    """The fleet port surface over a batch.

    Interface ``(b, osc)`` of the batch is fleet column ``b * n + osc``.
    ``cols`` restricts the exposed interfaces (only the DIAL element of
    an evaluation, only a campaign's measured cells); the default is
    every real interface of every element.
    """

    def __init__(self, batch: ScenarioBatch, cols=None):
        self.batch = batch
        if cols is None:
            cols = batch.real_tune_cols()
        self._cols = torch.as_tensor(np.asarray(cols, dtype=np.int64),
                                     device=batch.device)

    def osc_ids(self) -> torch.Tensor:
        return self._cols

    def probe_all(self):
        return probe_all(self.batch, self._cols)

    def set_knobs_many(self, osc_ids, window_pages, rpcs_in_flight) -> None:
        dev = self.batch.device
        ids = torch.as_tensor(osc_ids, dtype=torch.int64, device=dev)
        s = self.batch.state
        s.window_pages[ids] = torch.as_tensor(window_pages,
                                              dtype=torch.int64, device=dev)
        s.rpcs_in_flight[ids] = torch.as_tensor(rpcs_in_flight,
                                                dtype=torch.int64, device=dev)


def run_batch(batch: ScenarioBatch, model=None, seconds: float = 10.0,
              interval: float = 0.5,
              tuner_params: TunerParams | None = None,
              tune_cols=None, engine: BatchEngine | None = None,
              fused: bool = False, mesh=None, trace=None,
              intervene=None, graph: bool | None = None):
    """Drive a whole batch for ``seconds``, optionally DIAL-tuning it.

    The batched counterpart of :func:`repro_torch.core.fleet.run_fleet`:
    every interval is one :class:`BatchEngine` interval over the fleet
    followed (with ``model``) by one fleet tick over ``tune_cols``
    (default: every real interface).  Returns the
    :class:`~repro_torch.core.fleet.FleetAgent` (``None`` untuned); the
    final state is on ``batch.state``.

    ``fused=True`` runs the whole run on the device
    (:class:`~repro_torch.pfs.loop_torch.FusedLoop` over the fleet, each
    interval a CUDA-graph replay on the card; ``graph=False`` keeps the
    eager interval), with the whole run's schedule copied once.  Knob
    trajectories equal the host path's; the value is a
    :class:`~repro_torch.pfs.loop_torch.FusedLoopResult` whose
    ``decisions`` hold fleet columns.  ``intervene`` (fused only) is an
    :class:`~repro_torch.pfs.loop_torch.Intervention` with a ``(B, n)``
    leading shape; never-tuned elements ignore their rows.

    ``trace`` (a :class:`~repro_torch.obs.schema.TraceConfig`) opts the
    run into telemetry.  Fused runs return the records on
    ``result.trace`` (normalize with
    :meth:`~repro_torch.obs.schema.RunTrace.from_fused`); the timeline
    covers every element, and the decision columns of never-tuned
    elements carry the reference's inert placeholder record (``decided``
    false, the applied θ, zeroed gate metrics).  The host path records
    through the fleet agent's
    :class:`~repro_torch.obs.host.HostTracer` (``fleet.trace``), its
    timeline sampled in the engine's tick loop; an untuned host batch
    has no agent and is refused.

    ``mesh`` (fused only; a tuple of devices,
    :func:`repro_torch.distributed.sharding.fleet_mesh`) splits the
    batch over the devices: padded to a multiple of the mesh size by
    repeating element 0 (tune mask off, so phantoms never decide), cut
    into contiguous equal shards, each run as a fleet of its own on its
    device through that device's cached loop.  Every shard's intervals
    are launched before any result is read back; the state, records and
    decisions come back on the batch's device in element order, bit for
    bit the unsharded run's.
    """
    with span("lab.run_batch"):
        return _run_batch(batch, model, seconds, interval, tuner_params,
                          tune_cols, engine, fused, mesh, trace, intervene,
                          graph)


def _run_batch(batch, model, seconds, interval, tuner_params, tune_cols,
               engine, fused, mesh, trace, intervene, graph):
    steps = max(int(round(interval / batch.params.tick)), 1)
    n_intervals = int(round(seconds / interval))

    if fused:
        if model is None:
            raise ValueError("fused=True requires a model (untuned runs "
                             "gain nothing from fusing the decision loop)")
        if engine is not None:
            raise ValueError("`engine` configures the per-interval host "
                             "path; the fused path builds its own loops")
        return _run_batch_fused(batch, model, steps, n_intervals,
                                tuner_params, tune_cols, intervene, graph,
                                trace, mesh)
    if intervene is not None:
        raise ValueError("intervene= rides the fused batch path -- pass "
                         "fused=True")
    if mesh is not None:
        raise ValueError("mesh sharding rides the fused batch path -- "
                         "pass fused=True with mesh")
    if graph is not None:
        raise ValueError("graph= applies to fused=True only")
    if trace is not None and model is None:
        raise ValueError("host-path tracing records decision provenance "
                         "through the fleet agent -- untuned host batches "
                         "have neither (use fused=True for timelines)")

    engine = engine or BatchEngine(batch.params, batch.fleet, steps)
    fleet = tracer = None
    if model is not None:
        if trace is not None:
            from repro_torch.obs.host import HostTracer

            tracer = HostTracer(trace, batch.params, batch.fleet)
        fleet = FleetAgent(BatchPort(batch, cols=tune_cols), model,
                           tuner_params=tuner_params, device=batch.device,
                           tracer=tracer)
        fleet.trace = None
    # the whole run's schedule, copied once and sliced per interval
    # (make_schedule is a pure function of the absolute tick index)
    full = batch.schedule(0, n_intervals * steps).to(batch.device)
    for i in range(n_intervals):
        sched = Disturbance(*(getattr(full, f.name)[i * steps:(i + 1) * steps]
                              for f in dataclasses.fields(Disturbance)))
        batch.state, batch.wstate = engine.run_interval(
            batch.table, batch.state, batch.wstate, sched, tracer=tracer)
        if fleet is not None:
            fleet.tick()
    if tracer is not None:
        fleet.trace = tracer.run_trace(fleet.oscs, interval,
                                       batch.params.tick)
    return fleet


# ---------------------------------------------------------------------- #
# the fused path and its loop cache
# ---------------------------------------------------------------------- #
# fused loops reused across run_batch calls: batches that share (model,
# physics, fleet wiring, cadence, tuner, device) hit the same FusedLoop,
# whose captured interval replays for a table of the same content, so an
# evaluate sweep captures one graph a bucket
_FUSED_LOOPS: dict = {}


def _zero_stats() -> dict:
    return {"hits": 0, "misses": 0, "captures": 0, "capture_s": 0.0,
            "replays": 0, "replay_device_ms": 0.0, "replayed_launches": {}}


_CACHE_STATS = _zero_stats()


def loop_cache_stats() -> dict:
    """Fused-loop cache counters -- ``hits`` / ``misses`` / ``size`` --
    and the accounting of the runs made through the cached loops since
    the last reset: CUDA-graph ``captures`` and their ``capture_s``
    (capture + instantiate), ``replays``, their ``replay_device_ms``
    (each run's span on CUDA events) and ``replayed_launches`` (kernel
    launches per replay x replays, by kernel: the launch counters see
    only a graph's warm-up and capture)."""
    return {**_CACHE_STATS,
            "replayed_launches": dict(_CACHE_STATS["replayed_launches"]),
            "size": len(_FUSED_LOOPS)}


def reset_loop_cache_stats() -> None:
    _CACHE_STATS.update(_zero_stats())


def _account(run: dict) -> None:
    """Add one fused run (a loop's ``last_run``) to the counters."""
    if run.get("captured_now"):
        _CACHE_STATS["captures"] += 1
        _CACHE_STATS["capture_s"] += run["capture_s"] + (
            run["instantiate_s"] or 0.0)
    replays = run.get("replays", 0)
    _CACHE_STATS["replays"] += replays
    if replays:
        _CACHE_STATS["replay_device_ms"] += \
            run["device_ms_per_interval"] * replays
        out = _CACHE_STATS["replayed_launches"]
        for k, v in run["launches_per_replay"].items():
            out[k] = out.get(k, 0) + v * replays


def _cached_loop(params, topo: SimTopo, steps: int, model,
                 tuner_params, trace=None) -> FusedLoop:
    key = (id(model), model._version,
           params, topo.n_clients, topo.n_osts,
           # same-sized topologies can differ in wiring; the loop's
           # segment maps are the wiring
           topo.osc_client.cpu().numpy().tobytes(),
           topo.osc_ost.cpu().numpy().tobytes(),
           int(steps), tuner_params, str(topo.device),
           # a traced loop's interval has more outputs: traced and
           # untraced runs never share a loop, nor its graph
           trace)
    if key not in _FUSED_LOOPS:
        _CACHE_STATS["misses"] += 1
        if len(_FUSED_LOOPS) >= 32:          # bound the cache: evict the
            _FUSED_LOOPS.pop(next(iter(_FUSED_LOOPS)))   # oldest (FIFO)
        # the entry pins the model: the key holds id(model), unique only
        # while the object lives
        _FUSED_LOOPS[key] = (FusedLoop(params, topo, steps, model,
                                       tuner_params=tuner_params,
                                       trace=trace), model)
    else:
        _CACHE_STATS["hits"] += 1
    return _FUSED_LOOPS[key][0]


def _run_batch_fused(batch: ScenarioBatch, model, steps: int,
                     n_intervals: int, tuner_params, tune_cols, intervene,
                     graph, trace=None, mesh=None) -> FusedLoopResult:
    """The batched run on the device: one tuned loop over the whole
    fleet.  Elements with no tuned interface (the static-θ arms of an
    evaluation) ride it with their tune mask off, so they never decide;
    as in the reference, which runs them in a separate engine-only loop,
    they ignore their intervention rows (a pin holds only on tuned
    elements).  A replayed interval costs its kernel count, not its
    width, so one loop replays the engine's kernels once for the
    bucket."""
    b, n = len(batch), batch.n_osc
    mask = np.zeros((b, n), dtype=bool)
    cols = (batch.real_tune_cols() if tune_cols is None
            else np.asarray(tune_cols, dtype=np.int64))
    mask[cols // n, cols % n] = True
    tuned = mask.any(axis=1)
    if intervene is not None and not tuned.all():
        pin = intervene.pin_mask
        pin = (pin.cpu().numpy() if torch.is_tensor(pin)
               else np.asarray(pin, dtype=bool)).reshape(b, n)
        intervene = intervene._replace(pin_mask=pin & tuned[:, None])
    schedule = batch.schedule(0, n_intervals * steps)
    if mesh is not None:
        result = run_sharded(
            batch.params, batch.topo, batch.fleet, batch.tables,
            batch.state, batch.wstate, schedule, mask, intervene, model,
            steps, n_intervals, tuner_params, trace, graph, mesh)
    else:
        loop = _cached_loop(batch.params, batch.fleet, steps, model,
                            tuner_params, trace)
        result = loop.run(batch.table, batch.state, batch.wstate,
                          n_intervals, schedule=schedule, tune_mask=mask,
                          intervene=intervene, graph=graph)
        _account(loop.last_run)
    batch.state, batch.wstate = result.state, result.wstate
    if trace is not None and not tuned.all():
        _placeholder_untuned(result.trace, np.repeat(~tuned, n))
    return result


# the records a never-tuned element's columns keep in a traced batch;
# the rest are zeroed (the reference runs such elements in an
# engine-only loop that has no decision path, and fills them so)
_PLACEHOLDER_KEEPS = ("t", "warm", "theta", "cur_theta")


def _placeholder_untuned(trace: dict, cols: np.ndarray) -> None:
    """Give the never-tuned columns ``cols`` (a fleet-wide bool mask) of
    a traced run's records the reference's inert placeholder record:
    ``decided`` false, θ the applied knobs (probe-time θ, which never
    changes on such an element), every other field zero."""
    cols = torch.as_tensor(cols)
    for key, v in trace.items():
        if key == "timeline" or key in _PLACEHOLDER_KEEPS:
            continue
        v[:, cols] = 0
    trace["theta"][:, cols] = trace["cur_theta"][:, cols]


# ---------------------------------------------------------------------- #
# the sharded fused path: one fleet per device of a mesh
# ---------------------------------------------------------------------- #
# the model's forests on each mesh device, copied once per model version
# (the entry pins the model, whose id is in the key)
_REPLICAS: dict = {}


def model_on(model, device):
    """``model`` with its forests on ``device``: the model itself where
    it already lives there, else a copy made once per
    ``model._version`` (a refit makes a new one)."""
    device = torch.device(device)
    if model.device == device:
        return model
    key = (id(model), model._version, str(device))
    if key not in _REPLICAS:
        if len(_REPLICAS) >= 32:                      # FIFO, as the loops
            _REPLICAS.pop(next(iter(_REPLICAS)))
        moved = [DenseForest(f.feature.to(device), f.threshold.to(device),
                             f.leaf.to(device), f.base_score, f.depth,
                             f.n_features)
                 for f in (model.read_forest, model.write_forest)]
        _REPLICAS[key] = (DIALModel(*moved, space=model.space, k=model.k),
                          model)
    return _REPLICAS[key][0]


def _take(x, elems, n_elems: int):
    """Elements ``elems`` of a fleet tensor or array whose last axis is
    element-major over ``n_elems`` elements."""
    lead = tuple(x.shape[:-1])
    if torch.is_tensor(x):
        split = x.reshape(lead + (n_elems, -1))
        out = split.index_select(len(lead), torch.as_tensor(
            elems, device=x.device))
    else:
        out = np.take(np.asarray(x).reshape(lead + (n_elems, -1)), elems,
                      axis=len(lead))
    return out.reshape(lead + (-1,))


def _on(device):
    """The shard's device as the current one: the kernels launch on the
    current device's streams and keep their launch state per device."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _head(x, n_real: int, n_elems: int, axis: int):
    """The first ``n_real`` of ``n_elems`` element blocks of ``axis``."""
    width = x.shape[axis] // n_elems
    return x.narrow(axis, 0, n_real * width)


def run_sharded(params: SimParams, topo: SimTopo, fleet: SimTopo, tables,
                state: SimState, wstate: WorkloadState, schedule, mask,
                intervene, model, steps: int, n_intervals: int,
                tuner_params, trace, graph, mesh) -> FusedLoopResult:
    """A block-diagonal fleet of ``len(tables)`` elements, split over
    the devices of ``mesh``.

    ``topo`` is one element's topology, ``fleet`` the whole fleet's (its
    validity masks), ``tables`` each element's table; ``state`` /
    ``wstate`` / ``schedule`` (a numpy :class:`Disturbance` or
    ``None``) are the fleet's, element-major along their last axis;
    ``mask`` is the ``(B, n)`` tune mask and ``intervene`` ``None`` or a
    ``(B, n)``-leading :class:`~repro_torch.pfs.loop_torch.Intervention`.
    Shard s runs elements ``shard_elements(B, len(mesh))[s]``, phantoms
    with their tune mask off and the neutral intervention.  Every
    shard's intervals are launched before any shard is read back.  The
    result's state, ``hist`` and records are on ``fleet``'s device, in
    element order, phantoms dropped.
    """
    b, n = len(tables), topo.n_osc
    mesh = tuple(torch.device(d) for d in mesh)
    shards = shard_elements(b, len(mesh))
    per = len(shards[0])
    ost_valid = fleet.ost_valid_mask().cpu().numpy()
    client_valid = fleet.client_valid_mask().cpu().numpy()
    mask = np.asarray(mask, dtype=bool).reshape(b, n)
    if intervene is not None:
        intervene = Intervention(*(
            (a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a))
            .reshape((b, n) + tail)
            for a, tail in zip(intervene, ((), (2,), (), ()))))
    out_dev = fleet.device

    runs = []                   # (loop, carry, records, run, n_real)
    for s, (dev, elems) in enumerate(zip(mesh, shards)):
        n_real = max(0, min(per, b - s * per))
        real = np.arange(per) < n_real
        sub = _fleet_topo(topo, per, _take(ost_valid, elems, b),
                          _take(client_valid, elems, b), dev)
        table = WorkloadTable.block([tables[e] for e in elems],
                                    topo.n_clients, dev)
        st = SimState(**{
            f: (getattr(state, f) if f in _CLOCK
                else _take(getattr(state, f), elems, b).to(dev))
            for f in _STATE_FIELDS})
        ws = WorkloadState(_take(wstate.issued, elems, b).to(dev),
                           _take(wstate.done_base, elems, b).to(dev))
        sched = (None if schedule is None else Disturbance(*(
            _take(getattr(schedule, f.name), elems, b)
            for f in dataclasses.fields(Disturbance))))
        iv = None
        if intervene is not None:
            iv = Intervention(*(np.where(
                real.reshape((per,) + (1,) * (a.ndim - 1)), a[elems],
                np.zeros_like(a[elems])) for a in intervene))
        loop = _cached_loop(params, sub, steps, model_on(model, dev),
                            tuner_params, trace)
        with _on(dev):
            inputs = loop.prepare(st, ws, n_intervals, sched,
                                  mask[elems] & real[:, None], iv)
            carry, records = loop.advance(table, inputs, n_intervals, graph)
        runs.append((dev, loop, carry, records, loop.last_run, n_real))

    results = []
    for dev, loop, carry, records, run, n_real in runs:
        with _on(dev):
            results.append((loop.finish(carry, records, n_intervals, run),
                            n_real))
        _account(run)
    live = [(r, k) for r, k in results if k]

    def join(get, axis, dev=out_dev):
        return torch.cat([_head(get(r), k, per, axis).to(dev)
                          for r, k in live], dim=axis)

    r0 = results[0][0]
    state_out = SimState(**{
        f: (getattr(r0.state, f) if f in _CLOCK
            else join(lambda r: getattr(r.state, f), -1))
        for f in _STATE_FIELDS})
    wstate_out = WorkloadState(join(lambda r: r.wstate.issued, -1),
                               join(lambda r: r.wstate.done_base, -1))
    hist = None
    if r0.hist is not None:
        hist = tuple(join(lambda r: r.hist[i], 1)
                     for i in range(len(r0.hist)))
    trace_out = None
    if r0.trace is not None:
        # host tensors, as an unsharded run's records; the element axis
        # is the interfaces' (1) or, on the timeline, the OSTs' or
        # clients' (last); per-interval scalars are every shard's
        trace_out = {}
        for key, v in r0.trace.items():
            if key == "timeline":
                trace_out[key] = {
                    tk: (tv if tv.dim() < 3 else
                         join(lambda r: r.trace[key][tk], -1, "cpu"))
                    for tk, tv in v.items()}
            else:
                trace_out[key] = (v if v.dim() < 2 else
                                  join(lambda r: r.trace[key], 1, "cpu"))
    return FusedLoopResult(
        state=state_out, wstate=wstate_out, trace=trace_out,
        decisions=(decisions_from_trace(trace_out)
                   if trace_out is not None and "decided" in trace_out
                   else []),
        hist=hist, interval_seconds=r0.interval_seconds,
        n_run=n_intervals)
