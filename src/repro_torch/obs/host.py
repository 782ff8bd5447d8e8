"""Host-path tracer: the fused trace schema, emitted by the host loop.

The counterpart of the reference's ``repro/obs/host.py``.
:class:`HostTracer` collects the records the traced
:class:`~repro_torch.pfs.loop_torch.FusedLoop` emits -- per-interval
decision provenance from :class:`~repro_torch.core.fleet.FleetAgent`
(which calls :meth:`record_interval` every tick, gated or not) and
per-tick timeline samples from the engine's tick loop
(:class:`~repro_torch.pfs.engine_torch.FusedEngine`, which calls
:meth:`sample` at the fused path's sample offsets).  The records stay
on the device as the tensors they were taken from, so a sample adds no
host sync; they move to the host once, in :meth:`run_trace`.  The
result is a :class:`~repro_torch.obs.schema.RunTrace` diffable
row for row against a traced fused run of the same scenario.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.obs.schema import (RunTrace, TraceConfig,
                                    normalize_decisions, timeline_tap)

_RECORD = ("decided", "ops", "theta", "changed", "n_candidates", "score",
           "probs", "vol_r", "vol_w", "active", "steady", "ratio",
           "cur_theta")


def _host(values: list) -> np.ndarray:
    """Stack per-interval values (tensors on one device, or numbers) and
    bring them to the host in one copy."""
    if torch.is_tensor(values[0]):
        return torch.stack(values).cpu().numpy()
    return np.asarray(values)


class HostTracer:
    """Accumulates host-loop records; one instance per traced run."""

    def __init__(self, config: TraceConfig | None = None,
                 params=None, topo=None):
        self.config = config if config is not None else TraceConfig()
        self.params = params
        self.topo = topo
        self._dec: list[dict] = []
        self._tl: list[dict] = []

    # ------------------------------------------------------------------ #
    # decision mirror (called by FleetAgent.tick, every interval)
    # ------------------------------------------------------------------ #
    def record_interval(self, t, decided, ops, theta, changed,
                        n_candidates, score, probs, vol_r, vol_w, active,
                        steady, warm, ratio, cur_theta) -> None:
        """One interval's full-fleet record (pre-masking raw values, the
        same masking as the fused path applies in normalization); the
        tensors are kept where they are."""
        self._dec.append(dict(zip(("t", "warm") + _RECORD, (
            t, bool(warm), decided, ops, theta, changed, n_candidates,
            score, probs, vol_r, vol_w, active, steady, ratio,
            cur_theta))))

    def wants_sample(self, tick_in_interval: int,
                     steps_per_interval: int) -> bool:
        """Sample offsets matching the fused loop: within each interval,
        ticks ``stride-1, 2*stride-1, ...`` (remainder ticks past the last
        full stride are not sampled)."""
        return self.config.wants_sample(tick_in_interval, steps_per_interval)

    def sample(self, state, dist=None) -> None:
        """One timeline sample off the live ``SimState`` (device tensors,
        kept on the device)."""
        self._tl.append(timeline_tap(self.params, self.topo, state, dist))

    # ------------------------------------------------------------------ #
    def run_trace(self, oscs, interval_seconds: float,
                  tick_seconds: float) -> RunTrace:
        """Normalize everything recorded so far to a :class:`RunTrace`."""
        if not self._dec:
            raise ValueError("no intervals recorded")
        decisions = normalize_decisions(
            t=_host([d["t"] for d in self._dec]).astype(np.float64),
            warm=np.asarray([d["warm"] for d in self._dec]),
            **{k: _host([d[k] for d in self._dec]) for k in _RECORD})
        timeline = None
        if self._tl:
            timeline = {k: _host([s[k] for s in self._tl])
                        for k in self._tl[0]}
            timeline["t"] = timeline["t"].astype(np.float64)
        if torch.is_tensor(oscs):
            oscs = oscs.cpu().numpy()
        return RunTrace(decisions=decisions, timeline=timeline,
                        oscs=np.asarray(oscs, dtype=np.int64),
                        config=self.config,
                        interval_seconds=float(interval_seconds),
                        tick_seconds=float(tick_seconds))
