"""The per-client DIAL agent (paper SIII-A, components 1-4).

One agent runs on one PFS client, on its own: it probes that client's
OSC interfaces every interval, derives the designed metrics, scores Θ
with the learned model and applies the Conditional-Score-Greedy winner
to each interface.  Agents never communicate.

The counterpart of the reference's ``repro/core/agent.py``.  A
:class:`DIALAgent` lifts its :class:`ClientPort` to the fleet surface
and runs a one-client :class:`~repro_torch.core.fleet.FleetAgent`.  The
per-interface loop is kept as :class:`ReferenceLoopAgent`, the oracle
the fleet is held against: one probe, snapshot, model call and
Algorithm 1 per interface per tick, on one-interface tensors.  Both are
host loops over the port's tensors, for small fleets.

``measure_overhead=True`` records paper Table III's per-interface wall
times (:class:`AgentTimings`: snapshot, inference, end to end, per op).
On the card a ``perf_counter`` stamp alone would time only the queueing
of the launches, so a measured tick synchronizes the agent's device at
each stage boundary; an unmeasured tick makes no such sync.  Decisions
are the same either way.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Protocol

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.config_space import SPACE, ConfigSpace
from repro_torch.core.metrics import fleet_feature_matrix, snapshot_all
from repro_torch.core.model import DIALModel
from repro_torch.core.tuner import TunerParams, conditional_score_greedy_batch
from repro_torch.pfs.state import F64, READ, WRITE
from repro_torch.pfs.stats import FleetStats, probe


class ClientPort(Protocol):
    """What a DIAL agent needs from the system it tunes."""

    def osc_ids(self) -> list[int]: ...
    def probe(self, osc: int) -> FleetStats: ...
    def set_knobs(self, osc: int, window_pages: int,
                  rpcs_in_flight: int) -> None: ...


class SimClientPort:
    """Adapter: one client of the simulator (its interfaces, one per
    OST)."""

    def __init__(self, sim, client: int):
        self.sim = sim
        self.client = int(client)

    def osc_ids(self) -> list[int]:
        return [self.sim.osc_id(self.client, t)
                for t in range(self.sim.n_osts)]

    def probe(self, osc: int) -> FleetStats:
        return probe(self.sim, osc)

    def set_knobs(self, osc: int, window_pages: int,
                  rpcs_in_flight: int) -> None:
        self.sim.set_knobs([osc], window_pages=window_pages,
                           rpcs_in_flight=rpcs_in_flight)


@dataclasses.dataclass
class AgentTimings:
    """Wall-clock overheads per operation (paper Table III), in ms.

    Loop agents append each interface's own latency; fleet agents append
    the batch's cost amortized per covered interface.
    """

    snapshot_ms: list = dataclasses.field(default_factory=list)
    inference_ms: list = dataclasses.field(default_factory=list)
    end_to_end_ms: list = dataclasses.field(default_factory=list)

    def summary(self) -> dict:
        f = lambda xs: float(np.mean(xs)) if xs else 0.0  # noqa: E731
        return {"snapshot_ms": f(self.snapshot_ms),
                "inference_ms": f(self.inference_ms),
                "end_to_end_ms": f(self.end_to_end_ms)}


def stage_clock(device, measure: bool) -> float:
    """A stage boundary's ``perf_counter`` stamp: on a measured path
    after the device's queued work has finished, else the bare clock
    (no sync)."""
    if measure and device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


class DIALAgent:
    """The tuner of one client; call :meth:`tick` every interval.  A thin
    adapter over a one-client :class:`FleetAgent`."""

    def __init__(self, port, model: DIALModel, space: ConfigSpace = SPACE,
                 tuner_params: TunerParams | None = None, k: int = 1,
                 min_volume_bytes: float = 256 * 1024,
                 warmup_intervals: int = 2, measure_overhead: bool = False,
                 device=None):
        from repro_torch.core.fleet import FleetAgent, as_fleet_port

        self.port = port
        self.measure_overhead = measure_overhead
        self._fleet = FleetAgent(
            as_fleet_port(port), model, space=space,
            tuner_params=tuner_params, k=k,
            min_volume_bytes=min_volume_bytes,
            warmup_intervals=warmup_intervals,
            measure_overhead=measure_overhead, device=device)
        self.decisions: list = []

    @property
    def timings(self) -> dict:
        """``{READ: AgentTimings, WRITE: AgentTimings}`` (measured ticks
        only)."""
        return self._fleet.timings

    def tick(self) -> list:
        """One tuning round: ``[(osc, op, TuneDecision), ...]``."""
        decisions = self._fleet.tick().as_list()
        self.decisions.extend(decisions)
        return decisions


class ReferenceLoopAgent:
    """The per-interface tuning loop, one Python iteration per interface
    per tick: the oracle the batched fleet must match decision for
    decision.  ``model`` may be any object with ``predict_proba(op, x)``
    returning a probability per row of ``x``."""

    def __init__(self, port, model, space: ConfigSpace = SPACE,
                 tuner_params: TunerParams | None = None, k: int = 1,
                 min_volume_bytes: float = 256 * 1024,
                 warmup_intervals: int = 2, measure_overhead: bool = False):
        self.port = port
        self.model = model
        self.space = space
        self.tuner_params = (tuner_params if tuner_params is not None
                             else TunerParams())
        self.k = k
        self.min_volume = min_volume_bytes
        self.warmup = warmup_intervals
        self._ticks = 0
        self.measure_overhead = measure_overhead
        self.timings = {READ: AgentTimings(), WRITE: AgentTimings()}
        self._prev: dict = {}
        self._hist: dict = {}
        self.decisions: list = []
        for osc in port.osc_ids():
            self._prev[osc] = port.probe(osc)
            self._hist[osc] = collections.deque(maxlen=k + 1)
        dev = next(iter(self._prev.values())).bytes_done.device
        self._device = dev
        self._theta_feats = torch.as_tensor(space.as_features(), device=dev)
        self._row = torch.zeros(1, dtype=torch.int64, device=dev)

    def tick(self) -> list:
        """One tuning round across this client's interfaces."""
        self._ticks += 1
        decisions = []
        measure = self.measure_overhead
        for osc in self.port.osc_ids():
            t0 = stage_clock(self._device, measure)
            cur = self.port.probe(osc)
            snap = snapshot_all(self._prev[osc], cur)
            self._prev[osc] = cur
            self._hist[osc].append(snap)
            # the applied θ comes from the probe: knobs may have been
            # changed out of band since the last write
            current = torch.stack([cur.window_pages, cur.rpcs_in_flight],
                                  dim=1)
            t1 = stage_clock(self._device, measure)
            if (len(self._hist[osc]) < self.k + 1
                    or self._ticks <= self.warmup + self.k):
                continue
            vol_r, vol_w = float(snap.read_volume[0]), float(
                snap.write_volume[0])
            if max(vol_r, vol_w) < self.min_volume:
                continue                # idle interface: nothing to tune
            op = READ if vol_r >= vol_w else WRITE
            history = list(self._hist[osc])
            # steady-state guard: comparable volume across the history
            old = history[0]
            v0 = float((old.read_volume if op == READ
                        else old.write_volume)[0])
            v1 = vol_r if op == READ else vol_w
            if not 0.5 <= v1 / max(v0, 1.0) <= 2.0:
                continue
            x = fleet_feature_matrix(history, op, self._row,
                                     self._theta_feats)
            probs = self.model.predict_proba(op, x).to(F64)[None]
            t2 = stage_clock(self._device, measure)
            dec = conditional_score_greedy_batch(
                probs, torch.tensor([op], device=probs.device), current,
                self.space, self.tuner_params).to("cpu").one(0)
            if dec.changed:
                self.port.set_knobs(osc, *dec.theta)
            t3 = stage_clock(self._device, measure)
            if measure:
                tm = self.timings[op]
                tm.snapshot_ms.append((t1 - t0) * 1e3)
                tm.inference_ms.append((t2 - t1) * 1e3)
                tm.end_to_end_ms.append((t3 - t0) * 1e3)
            decisions.append((osc, op, dec))
        self.decisions.extend(decisions)
        return decisions


def run_with_agents(sim, model: DIALModel, clients: list[int],
                    seconds: float, interval: float = 0.5,
                    measure_overhead: bool = False,
                    tuner_params: TunerParams | None = None, device=None):
    """DIAL on ``clients``: all their interfaces tick as one fleet batch
    (decisions stay per interface).  Returns the ``FleetAgent``."""
    from repro_torch.core.fleet import run_fleet

    oscs = [sim.osc_id(c, t) for c in clients for t in range(sim.n_osts)]
    return run_fleet(sim, model, oscs=torch.tensor(oscs, device=sim.device),
                     seconds=seconds, interval=interval,
                     tuner_params=tuner_params, device=device,
                     measure_overhead=measure_overhead)


def run_with_loop_agents(sim, model, clients: list[int], seconds: float,
                         interval: float = 0.5,
                         measure_overhead: bool = False,
                         tuner_params: TunerParams | None = None,
                         device=None) -> list:
    """The oracle driver: one :class:`ReferenceLoopAgent` per client, each
    interval's ticks on the device (:class:`FusedEngine`) first."""
    from repro_torch.pfs.engine_torch import FusedEngine
    from repro_torch.pfs.workloads import (sync_workloads_from_table,
                                           table_from_sim)

    if resolve_device(device) != sim.device:
        raise ValueError(f"run_with_loop_agents on {resolve_device(device)}:"
                         f" sim on {sim.device}")
    agents = [ReferenceLoopAgent(SimClientPort(sim, c), model,
                                 tuner_params=tuner_params,
                                 measure_overhead=measure_overhead)
              for c in clients]
    steps = max(int(round(interval / sim.params.tick)), 1)
    table, wstate = table_from_sim(sim)
    engine = FusedEngine(sim.params, sim.topo, table, steps)
    for _ in range(int(round(seconds / interval))):
        sim.state, wstate = engine.run_interval(sim.state, wstate)
        for a in agents:
            a.tick()
    sync_workloads_from_table(sim, wstate)
    return agents
