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

Decentralization is kept: every row is built from that interface's own
counters, and no decision reads another interface's state.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.config_space import SPACE, ConfigSpace
from repro_torch.core.metrics import fleet_feature_matrix, snapshot_all
from repro_torch.core.model import DIALModel
from repro_torch.core.tuner import (FleetDecisions, TunerParams,
                                    conditional_score_greedy_batch)
from repro_torch.pfs.engine_torch import FusedEngine
from repro_torch.pfs.state import F64, READ, WRITE
from repro_torch.pfs.stats import FleetStats, probe_all
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
class FleetTickResult:
    """What one fleet tick decided, row-aligned over decided rows, as
    host (CPU) tensors."""

    oscs: torch.Tensor          # (m,) interface ids that reached Alg. 1
    ops: torch.Tensor           # (m,) op model used per interface
    decisions: FleetDecisions

    def __len__(self) -> int:
        return self.oscs.shape[0]


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
    the model must live on the same device."""

    def __init__(
        self,
        port: SimFleetPort,
        model: DIALModel,
        space: ConfigSpace = SPACE,
        tuner_params: TunerParams | None = None,
        k: int = 1,
        min_volume_bytes: float = 256 * 1024,
        warmup_intervals: int = 2,
        device=None,
    ):
        self.device = resolve_device(device)
        for what, dev in (("sim", port.sim.device), ("model", model.device)):
            if dev != self.device:
                raise ValueError(f"FleetAgent on {self.device}: {what} on "
                                 f"{dev}")
        self.port = port
        self.model = model
        self.space = space
        self.tuner_params = (tuner_params if tuner_params is not None
                             else TunerParams())
        self.k = k
        self.min_volume = min_volume_bytes
        self.warmup = warmup_intervals
        self._ticks = 0
        self.oscs = port.osc_ids()
        self.n = self.oscs.shape[0]
        self._theta_feats = torch.as_tensor(space.as_features(),
                                            device=self.device)
        self._prev = port.probe_all()
        self._hist: collections.deque = collections.deque(maxlen=k + 1)
        self.decisions: list = []

    def _gated(self) -> FleetTickResult:
        result = empty_tick_result(len(self.space))
        self.decisions.append(result)
        return result

    def tick(self) -> FleetTickResult:
        """One tuning round across every interface."""
        self._ticks += 1
        cur = self.port.probe_all()
        snap = snapshot_all(self._prev, cur)
        self._prev = cur
        self._hist.append(snap)
        # the applied θ comes from the probe itself: knobs may have
        # changed out-of-band since the last write
        current = torch.stack([cur.window_pages, cur.rpcs_in_flight], dim=1)
        vol_r, vol_w = snap.read_volume, snap.write_volume
        ops = torch.where(vol_r >= vol_w, READ, WRITE)     # op model (SIII-C)
        active = torch.maximum(vol_r, vol_w) >= self.min_volume
        if len(self._hist) < self.k + 1 or self._ticks <= self.warmup + self.k:
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

        dec = conditional_score_greedy_batch(
            probs, ops[rows], current[rows], self.space, self.tuner_params)
        # unchanged rows keep their θ, so writing every decided row is
        # the same as writing the changed ones, without a host sync
        self.port.set_knobs_many(self.oscs[rows], dec.theta[:, 0],
                                 dec.theta[:, 1])
        result = FleetTickResult(oscs=self.oscs[rows].cpu(),
                                 ops=ops[rows].cpu(), decisions=dec.to("cpu"))
        self.decisions.append(result)
        return result


def run_fleet(sim, model: DIALModel, oscs=None, seconds: float = 10.0,
              interval: float = 0.5, tuner_params: TunerParams | None = None,
              backend: str = "torch", device=None) -> FleetAgent:
    """Drive the simulator with one fleet agent over ``oscs`` (default
    all interfaces).

    ``backend="torch"`` (the only one) is the counterpart of the
    reference's ``"jax"`` backend: the attached workloads are frozen
    into a table, each interval advances ``interval / tick`` engine
    ticks on the device (:class:`FusedEngine`), then the agent ticks.
    """
    if backend != "torch":
        raise ValueError(f"unknown engine backend {backend!r}")
    fleet = FleetAgent(SimFleetPort(sim, oscs), model,
                       tuner_params=tuner_params, device=device)
    steps_per_interval = max(int(round(interval / sim.params.tick)), 1)
    n_intervals = int(round(seconds / interval))
    table, wstate = table_from_sim(sim)
    engine = FusedEngine(sim.params, sim.topo, table, steps_per_interval)
    for _ in range(n_intervals):
        sim.state, wstate = engine.run_interval(sim.state, wstate)
        fleet.tick()
    sync_workloads_from_table(sim, wstate)
    return fleet
