"""Fleet-scale DIAL on the device: every interface's tuning tick at once.

:class:`FleetAgent` runs the reference's fleet algorithm
(``repro/core/fleet.py``) with tensors on one device:

    probe      :func:`repro_torch.pfs.stats.probe_all`, one gather per field;
    metrics    :func:`snapshot_all` into ``(n_osc, F)`` float64 matrices;
    gating     volume and steadiness masks;
    inference  every decided (interface x θ) row of both ops in one launch
               of the paired-forest kernel (:meth:`DIALModel.score_fleet`);
    tuning     :func:`conditional_score_greedy_batch` (Algorithm 1);
    actuation  one indexed knob write for every decided interface.

The host reads the device twice per decided interval: the gate mask
(to size the feature batches) and the decision record.
``run_fleet(backend="torch-fused")`` runs the same decisions without
either read: the whole run on the device
(:class:`~repro_torch.pfs.loop_torch.FusedLoop`, each interval one CUDA
graph replay on the card), the records read once at its end, then
adopted by the agent (:meth:`FleetAgent.ingest_fused`) so that host
ticks can continue where it stopped.

``measure_overhead=True`` records paper Table III's per-interface wall
times (:class:`~repro_torch.core.agent.AgentTimings`): each stage
boundary of a measured tick synchronizes the device first, an unmeasured
tick makes no such sync, and decisions are the same either way.

Decentralization is kept: every row is built from that interface's own
counters, and no decision reads another interface's state.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.agent import AgentTimings, stage_clock
from repro_torch.core.config_space import SPACE, ConfigSpace
from repro_torch.core.metrics import (FleetSnapshot, fleet_feature_matrix,
                                      snapshot_all)
from repro_torch.core.model import DIALModel
from repro_torch.core.tuner import (FleetDecisions, TunerParams,
                                    conditional_score_greedy_batch)
from repro_torch.pfs.engine_torch import FusedEngine
from repro_torch.pfs.state import F64, READ, WRITE
from repro_torch.pfs.stats import FleetStats, probe_all, stack_stats
from repro_torch.pfs.workloads import sync_workloads_from_table, table_from_sim


@dataclasses.dataclass
class SimFleetPort:
    """Adapter: a set of the simulator's OSC interfaces (default all)."""

    sim: object
    oscs: torch.Tensor | None = None

    def osc_ids(self) -> torch.Tensor:
        if self.oscs is None:
            return torch.arange(self.sim.n_osc, device=self.sim.device)
        return torch.as_tensor(self.oscs, dtype=torch.int64,
                               device=self.sim.device)

    def probe_all(self) -> FleetStats:
        return probe_all(self.sim, self.osc_ids())

    def set_knobs_many(self, osc_ids, window_pages, rpcs_in_flight) -> None:
        self.sim.set_knobs(osc_ids, window_pages=window_pages,
                           rpcs_in_flight=rpcs_in_flight)


@dataclasses.dataclass
class LoopFleetPort:
    """Adapter lifting a per-interface port
    (:class:`~repro_torch.core.agent.ClientPort`) to the fleet surface:
    probes and knob writes loop over its interfaces on the host, the
    rest of the tick runs batched."""

    port: object

    def osc_ids(self) -> torch.Tensor:
        return torch.as_tensor(list(self.port.osc_ids()), dtype=torch.int64)

    def probe_all(self) -> FleetStats:
        ids = self.osc_ids()
        return stack_stats([self.port.probe(o) for o in ids.tolist()], ids)

    def set_knobs_many(self, osc_ids, window_pages, rpcs_in_flight) -> None:
        ids = torch.atleast_1d(torch.as_tensor(osc_ids)).cpu()
        ws = torch.as_tensor(window_pages).cpu().expand(ids.shape)
        rs = torch.as_tensor(rpcs_in_flight).cpu().expand(ids.shape)
        for o, w, r in zip(ids.tolist(), ws.tolist(), rs.tolist()):
            self.port.set_knobs(o, w, r)


def as_fleet_port(port):
    """Lift a port to the fleet surface (as it is if it already is one;
    a simulator client's port reads the simulator's tensors directly)."""
    if hasattr(port, "probe_all"):
        return port
    if hasattr(port, "sim") and hasattr(port, "client"):
        return SimFleetPort(port.sim, torch.as_tensor(
            port.osc_ids(), dtype=torch.int64, device=port.sim.device))
    return LoopFleetPort(port)


@dataclasses.dataclass
class FleetTickResult:
    """What one fleet tick decided, row-aligned over decided rows, as
    host (CPU) tensors."""

    oscs: torch.Tensor          # (m,) interface ids that reached Alg. 1
    ops: torch.Tensor           # (m,) op model used per interface
    decisions: FleetDecisions

    def __len__(self) -> int:
        return self.oscs.shape[0]

    def as_list(self) -> list:
        """Per-interface records ``[(osc, op, TuneDecision), ...]``."""
        return [(int(self.oscs[i]), int(self.ops[i]), self.decisions.one(i))
                for i in range(len(self))]


def empty_tick_result(n_configs: int = len(SPACE)) -> FleetTickResult:
    """A fresh gated-tick result (never shared between agents)."""
    i64 = lambda *s: torch.zeros(s, dtype=torch.int64)
    return FleetTickResult(
        oscs=i64(0), ops=i64(0),
        decisions=FleetDecisions(
            theta=i64(0, 2), changed=torch.zeros(0, dtype=torch.bool),
            n_candidates=i64(0), score=torch.zeros(0, dtype=F64),
            probs=torch.zeros((0, n_configs), dtype=F64)))


class FleetAgent:
    """DIAL for a whole fleet of interfaces; call :meth:`tick` every
    interval.  ``device=None`` means the CUDA card; the port's sim and
    the model must live on the same device.  ``tracer`` (a
    :class:`~repro_torch.obs.host.HostTracer`) records every interval's
    decision provenance, gated or not, as device tensors.
    ``measure_overhead`` fills ``timings`` (see the module note)."""

    def __init__(
        self,
        port: SimFleetPort,
        model: DIALModel,
        space: ConfigSpace = SPACE,
        tuner_params: TunerParams | None = None,
        k: int = 1,
        min_volume_bytes: float = 256 * 1024,
        warmup_intervals: int = 2,
        measure_overhead: bool = False,
        device=None,
        tracer=None,
    ):
        self.device = resolve_device(device)
        self._prev = port.probe_all()
        for what, dev in (("port", self._prev.bytes_done.device),
                          ("model", model.device)):
            if dev != self.device:
                raise ValueError(f"FleetAgent on {self.device}: {what} on "
                                 f"{dev}")
        self.port = port
        self.model = model
        self.space = space
        self.tracer = tracer
        self.tuner_params = (tuner_params if tuner_params is not None
                             else TunerParams())
        self.k = k
        self.min_volume = min_volume_bytes
        self.warmup = warmup_intervals
        self._ticks = 0
        self.measure_overhead = measure_overhead
        self.timings = {READ: AgentTimings(), WRITE: AgentTimings()}
        self.oscs = port.osc_ids().to(self.device)
        self.n = self.oscs.shape[0]
        self._theta_feats = torch.as_tensor(space.as_features(),
                                            device=self.device)
        self._hist: collections.deque = collections.deque(maxlen=k + 1)
        self.decisions: list = []

    def _gated(self) -> FleetTickResult:
        result = empty_tick_result(len(self.space))
        self.decisions.append(result)
        return result

    def tick(self) -> FleetTickResult:
        """One tuning round across every interface."""
        measure = self.measure_overhead
        self._ticks += 1
        t0 = stage_clock(self.device, measure)
        cur = self.port.probe_all()
        snap = snapshot_all(self._prev, cur)
        self._prev = cur
        self._hist.append(snap)
        # the applied θ comes from the probe itself: knobs may have
        # changed out-of-band since the last write
        current = torch.stack([cur.window_pages, cur.rpcs_in_flight], dim=1)
        t1 = stage_clock(self.device, measure)
        vol_r, vol_w = snap.read_volume, snap.write_volume
        ops = torch.where(vol_r >= vol_w, READ, WRITE)     # op model (SIII-C)
        active = torch.maximum(vol_r, vol_w) >= self.min_volume
        if len(self._hist) < self.k + 1 or self._ticks <= self.warmup + self.k:
            if self.tracer is not None:
                self._trace_gated(cur.t, ops, vol_r, vol_w, active, False,
                                  None, None, current)
            return self._gated()

        # per-interface gating, as masks (burst guard on the op volume)
        oldest = self._hist[0]
        v0 = torch.where(ops == READ, oldest.read_volume, oldest.write_volume)
        v1 = torch.where(ops == READ, vol_r, vol_w)
        ratio = v1 / torch.clamp_min(v0, 1.0)
        steady = (ratio >= 0.5) & (ratio <= 2.0)
        # the one read of the device that sizes the batches: -1 gated,
        # else the row's op
        code = torch.where(active & steady, ops, -1).cpu().numpy()
        rows_h = np.nonzero(code >= 0)[0]
        if rows_h.size == 0:
            if self.tracer is not None:
                self._trace_gated(cur.t, ops, vol_r, vol_w, active, True,
                                  steady, ratio, current)
            return self._gated()
        is_read_h = code[rows_h] == READ
        to_dev = lambda a: torch.as_tensor(a, device=self.device)
        rows = to_dev(rows_h)
        pos_read, pos_write = (to_dev(np.nonzero(m)[0])
                               for m in (is_read_h, ~is_read_h))

        history = list(self._hist)
        x_read = fleet_feature_matrix(history, READ, rows[pos_read],
                                      self._theta_feats)
        x_write = fleet_feature_matrix(history, WRITE, rows[pos_write],
                                       self._theta_feats)
        p_read, p_write = self.model.score_fleet(x_read, x_write)
        m = len(self.space)
        probs = torch.empty((rows.shape[0], m), dtype=F64, device=self.device)
        probs[pos_read] = p_read.reshape(-1, m).to(F64)
        probs[pos_write] = p_write.reshape(-1, m).to(F64)
        t2 = stage_clock(self.device, measure)

        dec = conditional_score_greedy_batch(
            probs, ops[rows], current[rows], self.space, self.tuner_params)
        # unchanged rows keep their θ, so writing every decided row is
        # the same as writing the changed ones, without a host sync
        self.port.set_knobs_many(self.oscs[rows], dec.theta[:, 0],
                                 dec.theta[:, 1])
        t3 = stage_clock(self.device, measure)
        if self.tracer is not None:
            self._trace_decided(cur.t, rows, dec, ops, vol_r, vol_w, active,
                                steady, ratio, current)
        result = FleetTickResult(oscs=self.oscs[rows].cpu(),
                                 ops=ops[rows].cpu(), decisions=dec.to("cpu"))
        if measure:
            self._record_timings(rows_h.size, is_read_h, t0, t1, t2, t3)
        self.decisions.append(result)
        return result

    def _record_timings(self, n_rows: int, is_read, t0, t1, t2, t3) -> None:
        """Per-interface wall times of one decided tick (the reference's
        fleet Table III figures): the probe and snapshot over every
        interface, inference and the whole tick over the decided
        ones."""
        snap_ms = (t1 - t0) / max(self.n, 1) * 1e3
        inf_ms = (t2 - t1) / max(n_rows, 1) * 1e3
        e2e_ms = (t3 - t0) / max(n_rows, 1) * 1e3
        for op, mask in ((READ, is_read), (WRITE, ~is_read)):
            if mask.any():
                tm = self.timings[op]
                tm.snapshot_ms.append(snap_ms)
                tm.inference_ms.append(inf_ms)
                tm.end_to_end_ms.append(e2e_ms)

    def _trace_gated(self, t, ops, vol_r, vol_w, active, warm, steady,
                     ratio, current) -> None:
        """Mirror a no-decision interval into the tracer (raw values; the
        shared normalization applies the masking convention).  Before the
        history is warm there is no ``steady`` or ``ratio`` (``None``)."""
        zi = torch.zeros(self.n, dtype=torch.int64, device=self.device)
        zf = torch.zeros(self.n, dtype=F64, device=self.device)
        zb = torch.zeros(self.n, dtype=torch.bool, device=self.device)
        if steady is None:
            steady, ratio = zb, zf
        self.tracer.record_interval(
            t, zb, ops, current, zb, zi, zf,
            torch.zeros((self.n, len(self.space)), dtype=F64,
                        device=self.device),
            vol_r, vol_w, active, steady, warm, ratio, current)

    def _trace_decided(self, t, rows, dec, ops, vol_r, vol_w, active,
                       steady, ratio, current) -> None:
        """Mirror a decided interval: the Algorithm 1 outcome scattered
        back to full-fleet tensors (the decided rows' θ, the applied θ
        elsewhere), on the device."""
        decided = torch.zeros(self.n, dtype=torch.bool, device=self.device)
        decided[rows] = True
        theta = current.clone()
        theta[rows] = dec.theta
        changed = torch.zeros_like(decided)
        changed[rows] = dec.changed
        ncand = torch.zeros(self.n, dtype=torch.int64, device=self.device)
        ncand[rows] = dec.n_candidates
        score = torch.zeros(self.n, dtype=F64, device=self.device)
        score[rows] = dec.score
        probs = torch.zeros((self.n, len(self.space)), dtype=F64,
                            device=self.device)
        probs[rows] = dec.probs
        self.tracer.record_interval(
            t, decided, ops, theta, changed, ncand, score, probs, vol_r,
            vol_w, active, steady, True, ratio, current)

    def ingest_fused(self, result) -> None:
        """Adopt a :class:`~repro_torch.pfs.loop_torch.FusedLoopResult` as
        this agent's history: one decision record per interval (aligned
        as :meth:`tick`'s), the probe re-read from the port, and the
        snapshot ring refilled from the run's final one, so further host
        ticks decide exactly as if every interval had run here."""
        self.decisions.extend(result.decisions)
        self._ticks += result.n_intervals
        st = self.port.probe_all()
        self._prev = st
        if result.hist is None:
            return                              # an untuned run
        hr, hw, hrv, hwv = result.hist          # (k+1, n_all, ...) rings
        rows = self.oscs                        # this agent's subset
        kp1 = hr.shape[0]
        # ring slots older than the run are still the zero placeholders
        for j in range(kp1 - min(result.n_intervals, kp1), kp1):
            age = kp1 - 1 - j                   # intervals before now
            self._hist.append(FleetSnapshot(
                t=st.t - age * result.interval_seconds,
                dt=result.interval_seconds, oscs=rows,
                read=hr[j][rows], write=hw[j][rows],
                read_volume=hrv[j][rows], write_volume=hwv[j][rows]))


def run_fleet(sim, model: DIALModel, oscs=None, seconds: float = 10.0,
              interval: float = 0.5, tuner_params: TunerParams | None = None,
              backend: str = "torch", device=None,
              graph: bool | None = None, trace=None,
              measure_overhead: bool = False, mesh=None) -> FleetAgent:
    """Drive the simulator with one fleet agent over ``oscs`` (default
    all interfaces).

    The attached workloads are frozen into a table, and each interval
    advances ``interval / tick`` engine ticks on the device.

    * ``backend="torch"``, the counterpart of the reference's ``"jax"``:
      :class:`FusedEngine` runs each interval's ticks, then the agent
      ticks on the host;
    * ``backend="torch-fused"``, the counterpart of ``"jax-fused"``: the
      whole run, decisions included, in one
      :class:`~repro_torch.pfs.loop_torch.FusedLoop` (``graph`` is its
      :meth:`~repro_torch.pfs.loop_torch.FusedLoop.advance`'s: ``None``
      replays each interval as a CUDA graph on the card); the agent then
      ingests the run.  The loop is kept as ``fleet.loop``.
    * ``backend="torch-sharded"``, the counterpart of ``"jax-sharded"``:
      the sim lifted to a one-element batch, padded to the devices of
      ``mesh`` (default :func:`~repro_torch.distributed.sharding.
      fleet_mesh`, every visible card) and run through
      :func:`~repro_torch.lab.batch.run_sharded`, a fused loop per
      device.  One sim's interfaces share OSTs, so it lands on one
      device and the others run phantoms; the backend pins the sharded
      path end to end (a real scale-out splits many scenarios,
      ``run_batch(fused=True, mesh=...)``).

    Decisions and knob trajectories are the same on all three.
    ``measure_overhead`` (``"torch"`` only) fills ``fleet.timings``: a
    fused run has no per-stage host boundary to time.

    ``trace`` (a :class:`~repro_torch.obs.schema.TraceConfig`) opts the
    run into telemetry: the agent carries a normalized
    :class:`~repro_torch.obs.schema.RunTrace` as ``fleet.trace``.  On
    ``"torch-fused"`` the records are the loop's; on ``"torch"`` a
    :class:`~repro_torch.obs.host.HostTracer` takes the same records,
    its timeline sampled in the engine's tick loop on the device.
    Tracing never changes a decision.
    """
    if backend not in ("torch", "torch-fused", "torch-sharded"):
        raise ValueError(f"unknown engine backend {backend!r}")
    if graph is not None and backend == "torch":
        raise ValueError("graph= applies to the fused backends only")
    if mesh is not None and backend != "torch-sharded":
        raise ValueError("mesh only applies to backend='torch-sharded'")
    if measure_overhead and backend != "torch":
        raise ValueError(
            "measure_overhead requires per-interval host timing; a fused "
            "run has no per-stage boundary to time -- use backend='torch' "
            "(benchmarks/torch_table3_overhead.py times the fused path "
            "differentially)")
    tracer = None
    if trace is not None and backend == "torch":
        from repro_torch.obs.host import HostTracer

        tracer = HostTracer(trace, sim.params, sim.topo)
    fleet = FleetAgent(SimFleetPort(sim, oscs), model,
                       tuner_params=tuner_params,
                       measure_overhead=measure_overhead, device=device,
                       tracer=tracer)
    fleet.loop = None
    fleet.trace = None
    steps_per_interval = max(int(round(interval / sim.params.tick)), 1)
    n_intervals = int(round(seconds / interval))
    table, wstate = table_from_sim(sim)
    if backend == "torch":
        engine = FusedEngine(sim.params, sim.topo, table, steps_per_interval)
        for _ in range(n_intervals):
            sim.state, wstate = engine.run_interval(sim.state, wstate,
                                                    tracer=tracer)
            fleet.tick()
        if tracer is not None:
            fleet.trace = tracer.run_trace(fleet.oscs, interval,
                                           sim.params.tick)
    elif backend == "torch-sharded":
        from repro_torch.distributed.sharding import fleet_mesh
        from repro_torch.lab.batch import run_sharded
        from repro_torch.obs.schema import RunTrace

        tune_mask = np.zeros((1, sim.n_osc), dtype=bool)
        tune_mask[0, fleet.oscs.cpu().numpy()] = True
        result = run_sharded(
            sim.params, sim.topo, sim.topo, (table,), sim.state, wstate,
            None, tune_mask, None, model, steps_per_interval, n_intervals,
            fleet.tuner_params, trace, graph,
            fleet_mesh() if mesh is None else mesh)
        sim.state, wstate = result.state, result.wstate
        fleet.ingest_fused(result)
        if trace is not None:
            fleet.trace = RunTrace.from_fused(result, trace,
                                              sim.params.tick)
    else:
        from repro_torch.pfs.loop_torch import FusedLoop

        fleet.loop = FusedLoop(
            sim.params, sim.topo, steps_per_interval, model,
            space=fleet.space, tuner_params=fleet.tuner_params, k=fleet.k,
            min_volume_bytes=fleet.min_volume,
            warmup_intervals=fleet.warmup, trace=trace)
        tune_mask = torch.zeros(sim.n_osc, dtype=torch.bool,
                                device=fleet.device)
        tune_mask[fleet.oscs] = True
        result = fleet.loop.run(table, sim.state, wstate, n_intervals,
                                tune_mask=tune_mask, graph=graph)
        sim.state, wstate = result.state, result.wstate
        fleet.ingest_fused(result)
        if trace is not None:
            fleet.trace = fleet.loop.run_trace(result)
    sync_workloads_from_table(sim, wstate)
    return fleet
