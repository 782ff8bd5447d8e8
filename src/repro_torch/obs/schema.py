"""Trace schema: the one record layout both execution paths emit.

The counterpart of the reference's ``repro/obs/schema.py``; the record
layout, :class:`TraceConfig`, :func:`normalize_decisions` and
:class:`RunTrace` (a numpy record) are copies, so a trace written by
either package reads back in the other.  :func:`timeline_tap` takes the
port's tensors: its five per-OST sums are one ``(5, E)`` launch of
:func:`~repro_torch.kernels.segment_reduce.ops.segment_sum` on the
fleet's OST map (each row its own ordered sum, so the result is
bit-equal to five launches).

Record kinds (``dial-trace-v2``; ``v1`` lacked ``diagnosis``):

``decision``  one row per (tuning interval, interface): the full
              provenance of that interface's Algorithm 1 pass -- chosen
              θ, per-config probabilities, how many configs cleared τ,
              the winning score, and every gate the row had to clear
              (volume, steadiness, warmup, tune mask) with the measured
              quantities behind them (``vol_r``/``vol_w``/``ratio``).
``timeline``  one row per (sampled tick, OST): cumulative read/write
              bytes, queued + in-pipeline bytes, active RPCs, remaining
              dirty-cache room of the attached OSCs, and the disturbance
              scales in effect -- sampled every ``stride`` ticks.
``diagnosis`` at most one per file: the counterfactual replay verdict
              for the traced run (:mod:`repro_torch.obs.diagnose`).

Masking convention (what makes the two paths diffable): rows that did
not reach Algorithm 1 (``decided`` false) carry the *applied* θ and
zeros for probs / score / n_candidates; ``ratio`` and ``steady`` are
only recorded once the snapshot history is warm (the fused ring buffer
holds zero placeholders during warmup where the host deque simply holds
fewer entries -- masking by ``warm`` removes the representational
difference without touching a single decision).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.segment_reduce.ops import segment_sum
from repro_torch.pfs.state import READ, WRITE

TRACE_SCHEMA = "dial-trace-v2"
#: schemas read_jsonl accepts (v1 files simply carry no diagnosis record)
TRACE_SCHEMAS = ("dial-trace-v1", "dial-trace-v2")

#: per-(interval, interface) decision provenance, canonical field order
DECISION_FIELDS = ("t", "decided", "ops", "theta", "changed",
                   "n_candidates", "score", "probs",
                   "vol_r", "vol_w", "active", "steady", "warm", "ratio")

#: per-(sampled tick, OST) fleet timeline, canonical field order
TIMELINE_FIELDS = ("t", "read_bytes", "write_bytes", "queue_bytes",
                   "active_rpcs", "dirty_room",
                   "bw_scale", "iops_scale", "bg_bytes", "nic_scale")


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Opt-in tracing knobs (hashable -- it keys the loop caches).

    ``stride`` downsamples the per-tick timeline: one sample every
    ``stride`` engine ticks (within each interval, at tick offsets
    ``stride-1, 2*stride-1, ...``; a remainder shorter than ``stride``
    is not sampled).  Decision records are per interval and never
    downsampled.  ``timeline=False`` keeps only the decision provenance,
    which adds no per-tick work at all.
    """

    stride: int = 20
    timeline: bool = True

    def __post_init__(self):
        if self.stride < 1:
            raise ValueError(f"stride must be >= 1, got {self.stride}")

    def samples(self, steps_per_interval: int) -> int:
        """Timeline samples one interval of ``steps_per_interval`` ticks
        takes."""
        return steps_per_interval // self.stride if self.timeline else 0

    def wants_sample(self, tick_in_interval: int,
                     steps_per_interval: int) -> bool:
        """Whether tick ``tick_in_interval`` (0-based) of an interval is
        followed by a sample: ticks ``stride-1, 2*stride-1, ...`` up to
        the last full stride."""
        s = self.stride
        return ((tick_in_interval + 1) % s == 0
                and tick_in_interval < self.samples(steps_per_interval) * s)


# ---------------------------------------------------------------------- #
# the timeline tap -- one function for both paths
# ---------------------------------------------------------------------- #
def timeline_tap(params, topo, state, dist=None) -> dict:
    """One timeline sample off a ``SimState`` (tensors on any device).

    Returns a dict of ``TIMELINE_FIELDS``: per-OST ``(n_osts,)`` tensors
    except ``t`` (the state's clock, as it holds it) and ``nic_scale``
    ``(n_clients,)``.  The five per-OST sums are one launch: a
    ``(5, n_osc)`` stack through the topology's OST map.  No host read.
    """
    s = state
    queued = (s.queue_bytes[READ] + s.queue_bytes[WRITE]
              + s.unready_bytes[READ] + s.unready_bytes[WRITE]
              + s.ready_bytes[READ] + s.ready_bytes[WRITE])
    room = torch.minimum(params.max_dirty_bytes - s.dirty_bytes,
                         params.grant_bytes - s.grant_used)
    sums = segment_sum(torch.stack([
        s.ctr_bytes_done[READ], s.ctr_bytes_done[WRITE], queued,
        s.active_rpcs[READ] + s.active_rpcs[WRITE], room]), topo.ost_map)
    d = topo.neutral if dist is None else dist
    return {
        "t": s.now,
        "read_bytes": sums[0], "write_bytes": sums[1],
        "queue_bytes": sums[2], "active_rpcs": sums[3],
        "dirty_room": sums[4],
        "bw_scale": d.bw_scale, "iops_scale": d.iops_scale,
        "bg_bytes": d.bg_bytes, "nic_scale": d.nic_scale,
    }


def _np(x) -> np.ndarray:
    """A tensor (any device), a number or an array, as numpy."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------- #
# normalization: raw per-path output -> the canonical masked record
# ---------------------------------------------------------------------- #
def normalize_decisions(t, decided, ops, theta, changed, n_candidates,
                        score, probs, vol_r, vol_w, active, steady, warm,
                        ratio, cur_theta) -> dict:
    """Apply the masking convention; every input has an ``(N, n, ...)``
    or broadcastable shape.  ``cur_theta`` is the θ applied at probe
    time -- what a row that never reached Algorithm 1 is actually
    running."""
    decided = np.asarray(decided, dtype=bool)
    warm = np.broadcast_to(np.asarray(warm, dtype=bool)[..., None]
                           if np.asarray(warm).ndim < decided.ndim
                           else np.asarray(warm, dtype=bool),
                           decided.shape)
    d2 = decided[..., None]
    return {
        "t": np.asarray(t, dtype=np.float64),
        "decided": decided,
        "ops": np.asarray(ops, dtype=np.int64),
        "theta": np.where(d2, np.asarray(theta, dtype=np.int64),
                          np.asarray(cur_theta, dtype=np.int64)),
        "changed": np.asarray(changed, dtype=bool) & decided,
        "n_candidates": np.asarray(n_candidates, dtype=np.int64) * decided,
        "score": np.asarray(score, dtype=np.float64) * decided,
        "probs": np.asarray(probs, dtype=np.float64) * d2,
        "vol_r": np.asarray(vol_r, dtype=np.float64),
        "vol_w": np.asarray(vol_w, dtype=np.float64),
        "active": np.asarray(active, dtype=bool),
        "steady": np.asarray(steady, dtype=bool) & warm,
        "warm": warm,
        "ratio": np.asarray(ratio, dtype=np.float64) * warm,
    }


@dataclasses.dataclass
class RunTrace:
    """One traced run, already normalized to the canonical schema.

    ``decisions`` maps ``DECISION_FIELDS`` to numpy arrays with a leading
    ``(n_intervals, n_interfaces)`` layout (``theta`` adds a trailing 2,
    ``probs`` a trailing |Θ|; ``t`` is ``(n_intervals,)``).
    ``timeline`` maps ``TIMELINE_FIELDS`` to ``(n_samples, n_osts)``
    arrays (``t`` is ``(n_samples,)``, ``nic_scale``
    ``(n_samples, n_clients)``); ``None`` when timeline tracing was off.
    """

    decisions: dict
    timeline: dict | None
    oscs: np.ndarray
    config: TraceConfig
    interval_seconds: float
    tick_seconds: float

    @property
    def n_intervals(self) -> int:
        return int(self.decisions["decided"].shape[0])

    @property
    def n_interfaces(self) -> int:
        return int(self.decisions["decided"].shape[1])

    # ------------------------------------------------------------------ #
    @classmethod
    def from_fused(cls, result, config: TraceConfig,
                   tick_seconds: float) -> "RunTrace":
        """Normalize a traced
        :class:`~repro_torch.pfs.loop_torch.FusedLoopResult`.

        The port's records are already the fleet's flat layout: a batch's
        element b has interface columns ``b * n + osc`` and OST tracks
        ``b * n_osts + ost``, the reference's flattening of its
        ``(B, N, ...)`` records, and one clock serves the batch.  So the
        result is the reference's ``RunTrace``, array for array.
        """
        raw = result.trace
        if raw is None or "t" not in raw:
            raise ValueError("result carries no trace -- was the loop "
                             "built with trace=TraceConfig(...)?")
        t = _np(raw["t"])
        if "decided" in raw:
            decisions = normalize_decisions(
                t, *(_np(raw[k]) for k in (
                    "decided", "ops", "theta", "changed", "n_candidates",
                    "score", "probs", "vol_r", "vol_w", "active", "steady",
                    "warm", "ratio", "cur_theta")))
            n_if = decisions["decided"].shape[1]
        else:                   # untuned run: timeline only
            decisions = {f: np.zeros((len(t), 0) if f != "t" else len(t))
                         for f in DECISION_FIELDS}
            decisions["t"] = t
            n_if = 0
        timeline = None
        if "timeline" in raw:   # (N, C, tracks) -> (N * C, tracks)
            timeline = {k: (lambda x: x.reshape(-1, *x.shape[2:]))(_np(v))
                        for k, v in raw["timeline"].items()}
        return cls(decisions=decisions, timeline=timeline,
                   oscs=np.arange(n_if, dtype=np.int64),
                   config=config,
                   interval_seconds=float(result.interval_seconds),
                   tick_seconds=float(tick_seconds))

    # ------------------------------------------------------------------ #
    def decision_rows(self):
        """Yield one JSON-safe dict per (interval, interface) row."""
        d = self.decisions
        for i in range(self.n_intervals):
            for j in range(self.n_interfaces):
                yield {
                    "kind": "decision",
                    "interval": i,
                    "osc": int(self.oscs[j]),
                    "t": float(d["t"][i]),
                    "decided": bool(d["decided"][i, j]),
                    "op": int(d["ops"][i, j]),
                    "theta": [int(x) for x in d["theta"][i, j]],
                    "changed": bool(d["changed"][i, j]),
                    "n_candidates": int(d["n_candidates"][i, j]),
                    "score": float(d["score"][i, j]),
                    "probs": [round(float(p), 9)
                              for p in d["probs"][i, j]],
                    "vol_r": float(d["vol_r"][i, j]),
                    "vol_w": float(d["vol_w"][i, j]),
                    "active": bool(d["active"][i, j]),
                    "steady": bool(d["steady"][i, j]),
                    "warm": bool(d["warm"][i, j]),
                    "ratio": float(d["ratio"][i, j]),
                }

    def timeline_rows(self):
        """Yield one JSON-safe dict per sample (per-OST values as lists,
        ``nic_scale`` per client)."""
        if self.timeline is None:
            return
        tl = self.timeline
        n_samples = tl["read_bytes"].shape[0]
        for i in range(n_samples):
            row = {"kind": "timeline", "sample": i,
                   "t": float(tl["t"][i])}
            for k in TIMELINE_FIELDS[1:]:
                row[k] = [float(x) for x in tl[k][i]]
            yield row

    # ------------------------------------------------------------------ #
    def validate(self) -> None:
        """Schema sanity: field coverage, shapes, monotone time axes."""
        missing = set(DECISION_FIELDS) - set(self.decisions)
        if missing:
            raise ValueError(f"decision trace missing fields {missing}")
        n, m = self.n_intervals, self.n_interfaces
        assert self.decisions["t"].shape == (n,)
        assert self.decisions["theta"].shape[:2] == (n, m)
        t = self.decisions["t"]
        if n > 1 and not np.all(np.diff(t) > 0):
            raise ValueError("decision timestamps not strictly increasing")
        if self.timeline is not None:
            missing = set(TIMELINE_FIELDS) - set(self.timeline)
            if missing:
                raise ValueError(f"timeline trace missing fields {missing}")
            tt = self.timeline["t"]
            if len(tt) > 1 and not np.all(np.diff(tt) > 0):
                raise ValueError("timeline timestamps not strictly "
                                 "increasing")
