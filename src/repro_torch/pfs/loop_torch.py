"""Device-resident DIAL decision loop: every tuned interval on the card.

The counterpart of the reference's ``repro/pfs/loop_jax.py``.  The host
loop (:func:`repro_torch.core.fleet.run_fleet` with ``backend="torch"``)
reads the device on every decided interval to size its feature batches;
here nothing leaves the device until the run ends.  One interval is

    ticks       ``steps`` x ``demand_step`` then ``engine_step``, the
                schedule's row for each tick
    probe       the counters read straight off the state (:func:`probe_state`)
    snapshot    :func:`repro_torch.core.metrics.snapshot_arrays`, into a
                ``(k+1)``-deep history ring
    gates       volume and steadiness masks, warm-up on a device tick
                counter, the tune mask
    features    history | θ | Δθ of **every** interface against all of Θ,
                float64 rounded to float32 where the host path rounds
    scoring     one launch of the paired-forest kernel for all rows
                (:func:`~repro_torch.kernels.gbdt_forest.ops.paired_forest_margin`)
    Algorithm 1 :func:`~repro_torch.core.tuner.conditional_score_greedy_batch`
    write-back  knobs where ``decide & changed``, then the interventions

On the card (:meth:`FusedLoop.run` with ``graph`` left ``None``) the
interval is captured once as a ``torch.cuda.CUDAGraph`` and every
interval of the run is a replay: the counterpart of the reference's one
``lax.scan`` dispatch.  Because the state is functional (each tick
returns new tensors), the graph reads static input buffers and ends by
copying the interval's new state, probe, history ring and tick counter
back into them.  Warm-up runs one interval on clones of the state, on a
side stream, before the capture (the forest kernel's one-time attribute
and occupancy calls happen there, outside capture), so the caller's
state advances once.  After each replay the interval's decision record
is copied into ``(n_intervals, n, ...)`` device buffers, which move to
the host once, at the end of the run.  A capture or replay that fails
raises; nothing falls back to the eager interval.  ``graph=False`` runs
the same interval eagerly on the card (the A/B and the card tests); the
CPU always runs it eagerly, through the kernels' plain versions.

:attr:`FusedLoop.last_run` describes the latest run: graphed or not,
the replays, the capture and instantiate seconds, and on the card
``device_ms_per_interval``, the span of its intervals on the device's
clock (CUDA events; a replay's copies included).

Launch counts: ``LAUNCHES`` counts in Python, so a graphed run counts
its warm-up interval and the capture, not the replays.
``last_run["launches_per_replay"]`` holds the launches one captured
interval makes; times ``last_run["replays"]`` that is what the run
launched.

A batch of scenarios runs as one block-diagonal fleet (the reference's
``batched=True``, a ``vmap`` of the run; see :mod:`repro_torch.lab.batch`):
element b's interface ``osc`` is fleet column ``b * n + osc``, so the
loop is unchanged and :meth:`FusedLoop.run` also takes the batch's
leading axis: a ``(B, n)`` tune mask and :class:`Intervention`, and a
``(B, ticks, ...)`` schedule, which it flattens to the fleet's form.
The captured interval is keyed on the table's content
(:attr:`WorkloadTable.key`), so a rebuilt batch of the same scenarios
replays it.

``trace=TraceConfig(...)`` (:mod:`repro_torch.obs`) opts the loop into
telemetry, the counterpart of the reference's traced scan outputs.  The
interval's record gains the decision provenance (``t``, ``vol_r``,
``vol_w``, ``active``, ``steady``, ``warm``, ``ratio``, ``cur_theta``:
values the interval computes anyway, so tracing adds outputs, never
arithmetic, and θ and the state are bit for bit the untraced run's),
and with a timeline one :func:`~repro_torch.obs.schema.timeline_tap`
after ticks ``stride-1, 2*stride-1, ...`` of the interval, each with
that tick's schedule row.  On the card they are more static outputs of
the captured interval, copied after each replay like the decision
record.  :meth:`FusedLoop.run_trace` normalizes a traced result.

The reference's ``mesh=`` (a ``shard_map`` of the batched run) is not a
loop option here: :func:`repro_torch.lab.batch.run_batch` with ``mesh=``
splits a batch into one fleet per device, each with a loop of its own
(:meth:`FusedLoop.advance` on every shard, then :meth:`FusedLoop.finish`
on each).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.config_space import SPACE, ConfigSpace
from repro_torch.core.metrics import (N_READ, N_WRITE, READ_KNOB_IDX,
                                      WRITE_KNOB_IDX, snapshot_arrays)
from repro_torch.core.tuner import (FleetDecisions, TunerParams,
                                    conditional_score_greedy_batch)
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.gbdt_forest.ops import (pair_forests,
                                                 paired_forest_margin,
                                                 sigmoid32)
from repro_torch.obs.schema import TraceConfig, timeline_tap
from repro_torch.pfs.state import (F64, READ, WRITE, Disturbance, SimParams,
                                   SimState, SimTopo, engine_step)
from repro_torch.pfs.workloads import WorkloadState, WorkloadTable

I64 = torch.int64
# what a traced interval's record adds to the decision record: the
# decision provenance, then the timeline's samples under
# "timeline.<field>" keys
PROVENANCE = ("t", "vol_r", "vol_w", "active", "steady", "warm", "ratio",
              "cur_theta")
TIMELINE = "timeline."


class Intervention(NamedTuple):
    """Per-interface counterfactual knobs for one fused run (the
    reference's ``Intervention``, unbatched).

    ``pin_mask``/``pin_theta``  after every write-back the interface's
                                knobs are forced to ``pin_theta``;
    ``force_gates``             the volume and steadiness gates count
                                as open (warm-up and the tune mask
                                still apply);
    ``freeze``                  decisions are never applied.

    Every field enters through ``torch.where`` on masks whose neutral
    values are identities, so :meth:`neutral` reproduces the factual run
    bit for bit.  Fields are ``(n,)`` bool and ``(n, 2)`` int64 numpy
    arrays or tensors, or a batch's ``(B, n)`` and ``(B, n, 2)``.
    """

    pin_mask: np.ndarray
    pin_theta: np.ndarray
    force_gates: np.ndarray
    freeze: np.ndarray

    @classmethod
    def neutral(cls, n: int) -> "Intervention":
        """The do-nothing intervention."""
        return cls(pin_mask=np.zeros(n, dtype=bool),
                   pin_theta=np.zeros((n, 2), dtype=np.int64),
                   force_gates=np.zeros(n, dtype=bool),
                   freeze=np.zeros(n, dtype=bool))

    @classmethod
    def pin(cls, n: int, theta) -> "Intervention":
        """Pin every interface to ``theta = (window_pages, rpcs)``."""
        iv = cls.neutral(n)
        return iv._replace(
            pin_mask=np.ones(n, dtype=bool),
            pin_theta=np.broadcast_to(np.asarray(theta, dtype=np.int64),
                                      (n, 2)).copy())

    @classmethod
    def gates_open(cls, n: int) -> "Intervention":
        return cls.neutral(n)._replace(force_gates=np.ones(n, dtype=bool))

    @classmethod
    def freeze_theta(cls, n: int) -> "Intervention":
        return cls.neutral(n)._replace(freeze=np.ones(n, dtype=bool))


class Probe(NamedTuple):
    """The cumulative counters the loop reads off the state, with the
    :class:`~repro_torch.pfs.stats.FleetStats` field names, so
    :func:`snapshot_arrays` takes either.  ``t`` is the device clock."""

    t: torch.Tensor
    bytes_done: torch.Tensor
    rpcs_sent: torch.Tensor
    rpc_bytes: torch.Tensor
    partial_rpcs: torch.Tensor
    latency_sum: torch.Tensor
    rpcs_done: torch.Tensor
    req_count: torch.Tensor
    req_bytes: torch.Tensor
    pending_integral: torch.Tensor
    active_integral: torch.Tensor
    cache_hit_bytes: torch.Tensor
    block_time: torch.Tensor
    dirty_integral: torch.Tensor
    grant_integral: torch.Tensor
    randomness: torch.Tensor
    window_pages: torch.Tensor
    rpcs_in_flight: torch.Tensor


def probe_state(state: SimState) -> Probe:
    """The fleet probe as the state's own tensors (no copy)."""
    return Probe(
        t=state.now,
        bytes_done=state.ctr_bytes_done,
        rpcs_sent=state.ctr_rpcs_sent,
        rpc_bytes=state.ctr_rpc_bytes,
        partial_rpcs=state.ctr_partial_rpcs,
        latency_sum=state.ctr_latency_sum,
        rpcs_done=state.ctr_rpcs_done,
        req_count=state.ctr_req_count,
        req_bytes=state.ctr_req_bytes,
        pending_integral=state.ctr_pending_integral,
        active_integral=state.ctr_active_integral,
        cache_hit_bytes=state.ctr_cache_hit_bytes,
        block_time=state.ctr_block_time,
        dirty_integral=state.ctr_dirty_integral,
        grant_integral=state.ctr_grant_integral,
        randomness=state.randomness,
        window_pages=state.window_pages,
        rpcs_in_flight=state.rpcs_in_flight,
    )


@dataclasses.dataclass
class FusedLoopResult:
    """What one fused run produced.

    ``decisions`` holds one :class:`~repro_torch.core.fleet.FleetTickResult`
    per interval (empty for gated intervals), host tensors, aligned with
    :attr:`FleetAgent.decisions`; ``trace`` the dense ``(n_intervals, n,
    ...)`` records they come from (host tensors), with a traced loop's
    provenance beside them and its timeline under ``trace["timeline"]``
    (``(n_intervals, samples, tracks)``).  ``state``/``wstate``
    stay on the loop's device, with a float ``now`` and an int
    ``tick_index``; ``hist`` is the final ``(k+1)``-deep snapshot ring
    (read and write matrices, then volumes) on the device, which
    :meth:`FleetAgent.ingest_fused` continues from.
    """

    state: SimState
    wstate: WorkloadState
    trace: dict | None
    decisions: list
    hist: tuple | None = None
    interval_seconds: float = 0.0
    n_run: int = 0

    @property
    def n_intervals(self) -> int:
        return len(self.decisions) if self.decisions else self.n_run


def decisions_from_trace(trace: dict) -> list:
    """Per-interval decision records (host tensors) from a fused trace:
    the rows where ``decided``, as the host agent records them."""
    from repro_torch.core.fleet import FleetTickResult

    out = []
    for i in range(trace["decided"].shape[0]):
        rows = torch.nonzero(trace["decided"][i])[:, 0]
        out.append(FleetTickResult(
            oscs=rows, ops=trace["ops"][i][rows],
            decisions=FleetDecisions(
                theta=trace["theta"][i][rows],
                changed=trace["changed"][i][rows],
                n_candidates=trace["n_candidates"][i][rows],
                score=trace["score"][i][rows],
                probs=trace["probs"][i][rows])))
    return out


@dataclasses.dataclass
class _Carry:
    """What one interval hands the next: the engine's state and the
    decision loop's (previous probe, snapshot ring, interval counter;
    ``None`` in an untuned loop)."""

    state: SimState
    wstate: WorkloadState
    prev: Probe | None = None
    hist: tuple | None = None
    tick: torch.Tensor | None = None

    def tensors(self) -> list:
        """Every tensor, in a fixed order (the graph's static buffers).

        The probe comes first: a new carry's probe may hold the static
        state's own knob tensors (the ticks pass them through), so it is
        copied back before the state is.
        """
        out = [] if self.prev is None else (
            list(self.prev) + list(self.hist) + [self.tick])
        out += [getattr(self.state, f.name)
                for f in dataclasses.fields(SimState)]
        return out + [self.wstate.issued, self.wstate.done_base]

    def clone(self) -> "_Carry":
        c = lambda t: t.clone()  # noqa: E731
        return _Carry(
            state=SimState(**{f.name: c(getattr(self.state, f.name))
                              for f in dataclasses.fields(SimState)}),
            wstate=WorkloadState(c(self.wstate.issued),
                                 c(self.wstate.done_base)),
            prev=None if self.prev is None else Probe(*map(c, self.prev)),
            hist=None if self.hist is None else tuple(map(c, self.hist)),
            tick=None if self.tick is None else c(self.tick))


@dataclasses.dataclass
class _Inputs:
    """A run's inputs on the device: the first carry, the schedule
    ``(n_intervals * steps, ...)`` or ``None``, the tune mask and the
    intervention (``None`` in an untuned loop or an unintervened run)."""

    carry: _Carry
    schedule: Disturbance | None
    tune_mask: torch.Tensor | None
    intervene: Intervention | None


@dataclasses.dataclass
class _Graph:
    """One captured interval: its static buffers and its outputs."""

    graph: torch.cuda.CUDAGraph
    carry: _Carry                    # static inputs, rewritten by a replay
    dist: Disturbance | None         # static (steps, ...) schedule slice
    tune_mask: torch.Tensor | None
    intervene: Intervention | None
    record: dict | None              # the replay's decision record
    launches: collections.Counter    # kernel launches one replay makes
    capture_s: float
    instantiate_s: float | None      # None: timed with the capture


class FusedLoop:
    """N intervals of engine + DIAL tuning, each interval one CUDA-graph
    replay on the card.

    ``steps_per_interval`` engine ticks make an interval; ``model``,
    ``space``, ``tuner_params``, ``k``, ``min_volume_bytes`` and
    ``warmup_intervals`` are :class:`~repro_torch.core.fleet.FleetAgent`'s.
    ``tuned=False`` is the lean engine-only run; ``trace`` a
    :class:`~repro_torch.obs.schema.TraceConfig` (see the module note).
    The loop runs on the topology's device (the model must be there
    too).  A graph is
    captured at the first run of a (table content, schedule or not,
    intervention or not) and replayed by every later run with the same
    ones; the loop keeps only its latest graph, so a run with other ones
    captures anew.

    Decentralization is untouched: every interface's decision reads only
    that interface's counters.
    """

    def __init__(self, params: SimParams, topo: SimTopo,
                 steps_per_interval: int, model,
                 space: ConfigSpace = SPACE,
                 tuner_params: TunerParams | None = None,
                 k: int = 1,
                 min_volume_bytes: float = 256 * 1024,
                 warmup_intervals: int = 2,
                 tuned: bool = True,
                 trace: TraceConfig | None = None):
        self.params = params
        self.topo = topo
        self.device = topo.device
        self.steps = int(steps_per_interval)
        self.space = space
        self.tuner_params = (tuner_params if tuner_params is not None
                             else TunerParams())
        self.k = int(k)
        self.min_volume = float(min_volume_bytes)
        self.warmup = int(warmup_intervals)
        self.tuned = bool(tuned)
        self.trace_config = trace
        # timeline samples an interval takes (none untraced)
        self.n_samples = 0 if trace is None else trace.samples(self.steps)
        self._graph: tuple | None = None     # (key, table, _Graph)
        self.last_run: dict = {}
        if not self.tuned:
            return
        if model is None:
            raise ValueError("a tuned FusedLoop needs a model")
        if model.device != self.device:
            raise ValueError(f"FusedLoop on {self.device}: model on "
                             f"{model.device}")
        feature, threshold, leaf, base, self.depth, self.n_features = \
            pair_forests(model.read_forest, model.write_forest)
        to = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        self.forests = tuple(map(to, (feature, threshold, leaf, base)))
        self.theta_feats = to(space.as_features())          # (M, 2) log2
        kp1 = self.k + 1
        need = max(N_READ * kp1 + 4, N_WRITE * kp1 + 4)
        if self.n_features < need:
            raise ValueError(
                f"model expects {self.n_features} features but k={self.k} "
                f"histories need {need}: trained with another history "
                f"length?")

    # ------------------------------------------------------------------ #
    def _features(self, hist: torch.Tensor, n_feat: int,
                  knob_idx) -> torch.Tensor:
        """``(k+1, n, N)`` float64 ring -> ``(n, |Θ|, n_features)`` float32
        rows, interface-major, zero-padded: the host matrix's layout, each
        value rounded once from float64."""
        n, m = hist.shape[1], self.theta_feats.shape[0]
        h2 = hist.transpose(0, 1).reshape(n, -1)           # oldest first
        last = self.k * n_feat
        cur = torch.stack([h2[:, last + knob_idx[0]],
                           h2[:, last + knob_idx[1]]], dim=1)
        w = h2.shape[1]
        x = torch.zeros((n, m, self.n_features), dtype=torch.float32,
                        device=hist.device)
        x[:, :, :w] = h2[:, None, :]
        x[:, :, w:w + 2] = self.theta_feats
        x[:, :, w + 2:w + 4] = self.theta_feats - cur[:, None, :]
        return x

    def _interval(self, table: WorkloadTable, carry: _Carry,
                  dist: Disturbance | None, tune_mask, iv):
        """One interval, functional: ``carry -> (carry', record)``.  No
        host read anywhere (it is what the graph captures)."""
        st, ws = carry.state, carry.wstate
        taps = []
        for i in range(self.steps):
            demand, ws = table.demand_step(self.params, ws, st)
            d_i = None if dist is None else dist.at_tick(i)
            st = engine_step(self.params, self.topo, st, demand,
                             disturbance=d_i)
            if self.n_samples and self.trace_config.wants_sample(
                    i, self.steps):
                taps.append(timeline_tap(self.params, self.topo, st, d_i))
        extra = {TIMELINE + k: torch.stack([tap[k] for tap in taps])
                 for k in (taps[0] if taps else ())}
        if not self.tuned:
            if self.trace_config is None:
                return _Carry(st, ws), None
            return _Carry(st, ws), {"t": st.now, **extra}

        # probe + snapshot (the host path's arithmetic), the history ring
        cur = probe_state(st)
        _, snap_r, snap_w, vol_r, vol_w = snapshot_arrays(carry.prev, cur)
        hr, hw, hrv, hwv = (torch.cat([h[1:], s[None]]) for h, s in zip(
            carry.hist, (snap_r, snap_w, vol_r, vol_w)))
        tick = carry.tick + 1

        # gates (FleetAgent.tick's predicates), warm-up on the device
        ops = torch.where(vol_r >= vol_w, READ, WRITE)
        active = torch.maximum(vol_r, vol_w) >= self.min_volume
        v0 = torch.where(ops == READ, hrv[0], hwv[0])
        v1 = torch.where(ops == READ, vol_r, vol_w)
        ratio = v1 / torch.clamp_min(v0, 1.0)
        steady = (ratio >= 0.5) & (ratio <= 2.0)
        warm = tick >= self.warmup + self.k + 1
        gate_ok = active & steady
        if iv is not None:
            gate_ok = gate_ok | iv.force_gates
        decide = gate_ok & warm & tune_mask

        # every interface x Θ under its own op, one paired-forest launch
        n, m = ops.shape[0], self.theta_feats.shape[0]
        x = torch.where((ops == READ)[:, None, None],
                        self._features(hr, N_READ, READ_KNOB_IDX),
                        self._features(hw, N_WRITE, WRITE_KNOB_IDX))
        op_rows = ops.to(torch.int32)[:, None].expand(n, m).reshape(-1)
        margin = paired_forest_margin(x.reshape(n * m, -1), op_rows,
                                      *self.forests, self.depth)
        probs = sigmoid32(margin).to(F64).reshape(n, m)

        # Algorithm 1 on every row; the applied θ is the probe's
        current = torch.stack([st.window_pages, st.rpcs_in_flight], dim=1)
        dec = conditional_score_greedy_batch(probs, ops, current, self.space,
                                             self.tuner_params)
        apply = decide & dec.changed
        if iv is not None:
            apply = apply & ~iv.freeze
        new_wp = torch.where(apply, dec.theta[:, 0], st.window_pages)
        new_rf = torch.where(apply, dec.theta[:, 1], st.rpcs_in_flight)
        if iv is not None:
            new_wp = torch.where(iv.pin_mask, iv.pin_theta[:, 0], new_wp)
            new_rf = torch.where(iv.pin_mask, iv.pin_theta[:, 1], new_rf)
        st = dataclasses.replace(st, window_pages=new_wp,
                                 rpcs_in_flight=new_rf)
        record = {"decided": decide, "ops": ops, "theta": dec.theta,
                  "changed": dec.changed, "n_candidates": dec.n_candidates,
                  "score": dec.score, "probs": probs}
        if self.trace_config is not None:
            # the provenance is values computed above: outputs only
            record.update(zip(PROVENANCE, (
                st.now, vol_r, vol_w, active, steady, warm, ratio, current)))
            record.update(extra)
        return _Carry(st, ws, cur, (hr, hw, hrv, hwv), tick), record

    # ------------------------------------------------------------------ #
    def prepare(self, state: SimState, wstate: WorkloadState,
                n_intervals: int, schedule: Disturbance | None = None,
                tune_mask=None, intervene: Intervention | None = None
                ) -> _Inputs:
        """A run's inputs on the loop's device (the run's host-to-device
        copies; :meth:`advance` makes none).  The clock becomes 0-dim
        device tensors; the snapshot ring starts at zeros.  A batch's
        leading axis is flattened into the fleet's columns (see the
        module note); the default tune mask is every real interface."""
        dev = self.device
        n = self.topo.n_osc
        if intervene is not None and not self.tuned:
            raise ValueError("intervene= requires a tuned loop")
        fields = {f.name: getattr(state, f.name)
                  for f in dataclasses.fields(SimState)}
        fields["now"] = torch.as_tensor(state.now, dtype=F64, device=dev)
        fields["tick_index"] = torch.as_tensor(state.tick_index, dtype=I64,
                                               device=dev)
        st = SimState(**fields)
        carry = _Carry(st, wstate)
        if schedule is not None:
            schedule = schedule.to(dev)
            if schedule.bw_scale.dim() == 3:        # (B, ticks, ...)
                schedule = Disturbance(*(
                    a.transpose(0, 1).reshape(a.shape[1], -1)
                    for a in _fields(schedule)))
            total = int(n_intervals) * self.steps
            if any(a.shape[0] != total for a in _fields(schedule)):
                raise ValueError(f"the schedule's ticks are not the run's "
                                 f"{total}")
        if not self.tuned:
            return _Inputs(carry, schedule, None, None)
        carry.prev = probe_state(st)
        carry.hist = (torch.zeros((self.k + 1, n, N_READ), dtype=F64,
                                  device=dev),
                      torch.zeros((self.k + 1, n, N_WRITE), dtype=F64,
                                  device=dev),
                      torch.zeros((self.k + 1, n), dtype=F64, device=dev),
                      torch.zeros((self.k + 1, n), dtype=F64, device=dev))
        carry.tick = torch.zeros((), dtype=I64, device=dev)
        as_dev = lambda a, dt: torch.as_tensor(  # noqa: E731
            np.asarray(a) if not torch.is_tensor(a) else a, dtype=dt,
            device=dev)
        mask = (self.topo.osc_valid() if tune_mask is None
                else as_dev(tune_mask, torch.bool).reshape(n))
        iv = None
        if intervene is not None:
            iv = Intervention(*(
                as_dev(a, dt).reshape((n,) + tail) for a, dt, tail in zip(
                    intervene, (torch.bool, I64, torch.bool, torch.bool),
                    ((), (2,), (), ()))))
        return _Inputs(carry, schedule, mask, iv)

    def _slice(self, schedule: Disturbance | None, i: int):
        """Interval ``i``'s ``(steps, ...)`` rows of a run's schedule."""
        if schedule is None:
            return None
        lo, hi = i * self.steps, (i + 1) * self.steps
        return Disturbance(*(a[lo:hi] for a in _fields(schedule)))

    def _capture(self, table: WorkloadTable, inputs: _Inputs) -> _Graph:
        """Warm up on clones (side stream), then capture one interval."""
        dev = self.device
        static = inputs.carry.clone()
        dist = self._slice(inputs.schedule, 0)
        if dist is not None:
            dist = Disturbance(*(a.clone() for a in _fields(dist)))
        mask = None if inputs.tune_mask is None else inputs.tune_mask.clone()
        iv = (None if inputs.intervene is None
              else Intervention(*(a.clone() for a in inputs.intervene)))
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._interval(table, static.clone(), dist, mask, iv)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)

        try:                    # instantiate apart, where torch allows it
            graph = torch.cuda.CUDAGraph(keep_graph=True)
        except TypeError:
            graph = None
        split = graph is not None
        if not split:
            graph = torch.cuda.CUDAGraph()
        before = collections.Counter(LAUNCHES)
        t0 = time.perf_counter()
        # the capture stream is the loop's device's (torch's default one
        # is made once, on whichever device was current then)
        with torch.cuda.graph(graph, stream=side):
            new, record = self._interval(table, static, dist, mask, iv)
            for dst, src in zip(static.tensors(), new.tensors()):
                dst.copy_(src)
        torch.cuda.synchronize(dev)
        capture_s = time.perf_counter() - t0
        instantiate_s = None
        if split:
            t0 = time.perf_counter()
            graph.instantiate()
            torch.cuda.synchronize(dev)
            instantiate_s = time.perf_counter() - t0
        launches = collections.Counter(LAUNCHES)
        launches.subtract(before)
        return _Graph(graph, static, dist, mask, iv, record,
                      +launches, capture_s, instantiate_s)

    def advance(self, table: WorkloadTable, inputs: _Inputs,
                n_intervals: int, graph: bool | None = None):
        """Run ``n_intervals`` on the device from ``inputs``; returns the
        last carry and the ``(n_intervals, n, ...)`` device records.

        ``graph=None`` replays a captured interval on the card and runs
        it eagerly on the CPU; ``graph=False`` runs it eagerly on the
        card too.  Once a graph is captured, nothing here reads the
        device from the host.
        """
        n_intervals = int(n_intervals)
        on_card = self.device.type == "cuda"
        if graph is None:
            graph = on_card
        if graph and not on_card:
            raise ValueError("graph=True needs the loop on a CUDA device")
        records = None          # (n_intervals, ...) buffers of the records

        def buffers(rec: dict) -> dict:
            return {k: torch.empty((n_intervals,) + tuple(v.shape),
                                   dtype=v.dtype, device=self.device)
                    for k, v in rec.items()}

        # the device's span of the intervals, read after the run syncs
        events = ((torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) if on_card
                  else None)
        if not graph:
            carry = inputs.carry
            if events:
                events[0].record()
            for i in range(n_intervals):
                carry, rec = self._interval(
                    table, carry, self._slice(inputs.schedule, i),
                    inputs.tune_mask, inputs.intervene)
                if rec is not None:
                    if records is None:
                        records = buffers(rec)
                    for k, v in rec.items():
                        records[k][i] = v
            if events:
                events[1].record()
            self.last_run = {"graph": False, "replays": 0, "events": events}
            return carry, records

        key = (table.key, inputs.schedule is None, inputs.intervene is None,
               self.trace_config)
        captured_now = self._graph is None or self._graph[0] != key
        setup_s = 0.0
        if captured_now:
            self._graph = None               # free the old graph first
            t0 = time.perf_counter()
            # the entry pins the table: the graph reads its tensors
            self._graph = (key, table, self._capture(table, inputs))
            setup_s = time.perf_counter() - t0
        g = self._graph[2]
        for dst, src in zip(g.carry.tensors(), inputs.carry.tensors()):
            dst.copy_(src)
        if g.tune_mask is not None:
            g.tune_mask.copy_(inputs.tune_mask)
        if g.intervene is not None:
            for dst, src in zip(g.intervene, inputs.intervene):
                dst.copy_(src)
        if g.record is not None:
            records = buffers(g.record)
        if events:
            events[0].record()
        for i in range(n_intervals):
            if g.dist is not None:
                for dst, src in zip(_fields(g.dist), _fields(
                        self._slice(inputs.schedule, i))):
                    dst.copy_(src)
            g.graph.replay()
            if records is not None:
                for k, v in g.record.items():
                    records[k][i].copy_(v)
        events[1].record()
        self.last_run = {"graph": True, "replays": n_intervals,
                         "events": events,
                         "captured_now": captured_now,
                         "setup_s": setup_s,
                         "launches_per_replay": dict(g.launches),
                         "capture_s": g.capture_s,
                         "instantiate_s": g.instantiate_s}
        return g.carry.clone(), records

    def run(self, table: WorkloadTable, state: SimState,
            wstate: WorkloadState, n_intervals: int,
            schedule: Disturbance | None = None, tune_mask=None,
            intervene: Intervention | None = None,
            graph: bool | None = None) -> FusedLoopResult:
        """Advance ``n_intervals`` of engine + tuning.

        ``schedule`` is a whole-run :class:`Disturbance` with a flat
        leading ``(n_intervals * steps, ...)`` axis (tensors or numpy
        arrays; a batch's ``(B, n_intervals * steps, ...)``);
        ``tune_mask`` (``n`` or ``(B, n)`` bools, default every real
        interface) restricts which interfaces may decide; ``intervene``
        applies an :class:`Intervention`.  ``graph`` is
        :meth:`advance`'s.  The caller's ``state``/``wstate`` are not
        modified; the records move to the host once, here.
        """
        n_intervals = int(n_intervals)
        inputs = self.prepare(state, wstate, n_intervals, schedule,
                              tune_mask, intervene)
        carry, records = self.advance(table, inputs, n_intervals, graph)
        return self.finish(carry, records, n_intervals, self.last_run)

    def finish(self, carry: _Carry, records: dict | None, n_intervals: int,
               run: dict) -> FusedLoopResult:
        """The end of a run: the clock and the records to the host.

        ``run`` is the :attr:`last_run` that :meth:`advance` left for
        this run (a sharded batch advances every shard before it
        finishes any, so the loop may have advanced another since); it
        becomes :attr:`last_run` again, with ``device_ms_per_interval``.
        """
        st = dataclasses.replace(carry.state, now=float(carry.state.now),
                                 tick_index=int(carry.state.tick_index))
        self.last_run = run
        events = run.pop("events", None)
        if events and n_intervals:
            run["device_ms_per_interval"] = \
                events[0].elapsed_time(events[1]) / n_intervals
        trace = None
        if records is not None:
            trace = {k: v.cpu() for k, v in records.items()
                     if not k.startswith(TIMELINE)}
            if self.n_samples:
                trace["timeline"] = {k[len(TIMELINE):]: v.cpu()
                                     for k, v in records.items()
                                     if k.startswith(TIMELINE)}
        return FusedLoopResult(
            state=st, wstate=carry.wstate, trace=trace,
            decisions=(decisions_from_trace(trace)
                       if trace is not None and "decided" in trace else []),
            hist=carry.hist, interval_seconds=self.steps * self.params.tick,
            n_run=n_intervals)

    def run_trace(self, result: FusedLoopResult):
        """Normalize a traced result to a
        :class:`~repro_torch.obs.schema.RunTrace`."""
        from repro_torch.obs.schema import RunTrace

        if self.trace_config is None:
            raise ValueError("loop was built without trace=TraceConfig(...)")
        return RunTrace.from_fused(result, self.trace_config,
                                   self.params.tick)


# engine-only loops reused across :func:`run_engine` calls: sims that
# share (physics, wiring, cadence, device) hit the same loop, whose
# captured interval replays for a table of the same content
_ENGINE_LOOPS: dict = {}


def run_engine(sim, seconds: float, interval: float = 0.5) -> dict:
    """Advance ``sim``'s attached workloads ``seconds`` under their
    current knobs, ``interval / tick`` ticks an interval, through an
    engine-only :class:`FusedLoop` (``tuned=False``): on the card each
    interval a CUDA-graph replay, on the CPU eager.  The ticks are
    :meth:`~repro_torch.pfs.engine.PFSSim.run`'s.  The loop is kept per
    (physics, wiring, cadence, device), so a later sim with the same
    tables replays its graph.  Returns the run's ``last_run``."""
    from repro_torch.pfs.workloads import (sync_workloads_from_table,
                                           table_from_sim)

    steps = max(int(round(interval / sim.params.tick)), 1)
    n_ticks = int(round(seconds / sim.params.tick))
    if n_ticks % steps:
        raise ValueError(f"{seconds} s is not a whole number of "
                         f"{interval} s intervals")
    topo = sim.topo
    key = (sim.params, topo.n_clients, topo.n_osts,
           topo.osc_client.cpu().numpy().tobytes(),
           topo.osc_ost.cpu().numpy().tobytes(), steps, str(sim.device))
    if key not in _ENGINE_LOOPS:
        if len(_ENGINE_LOOPS) >= 8:                 # bound the cache (FIFO)
            _ENGINE_LOOPS.pop(next(iter(_ENGINE_LOOPS)))
        _ENGINE_LOOPS[key] = FusedLoop(sim.params, topo, steps, None,
                                       tuned=False)
    loop = _ENGINE_LOOPS[key]
    table, wstate = table_from_sim(sim)
    result = loop.run(table, sim.state, wstate, n_ticks // steps)
    sim.state = result.state
    sync_workloads_from_table(sim, result.wstate)
    return dict(loop.last_run)


def _fields(dist: Disturbance) -> tuple:
    """A disturbance's tensors, in field order."""
    return tuple(getattr(dist, f.name) for f in dataclasses.fields(dist))
