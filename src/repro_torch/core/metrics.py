"""Designed client-side local metrics, for the whole fleet on the device.

Two consecutive fleet probes (:mod:`repro_torch.pfs.stats`) are
differenced into one interval snapshot per interface -- separate read
and write vectors, with op-specific members (paper SIII-A/B).  The
arithmetic is the reference's ``snapshot_arrays``
(``repro/core/metrics.py``) in the same op order, in float64; the model
inputs are rounded to float32 at the same point as there.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.pfs.state import F64, PAGE_SIZE, READ, WRITE
from repro_torch.pfs.stats import FleetStats

# Ordered feature names of each op's snapshot vector.  Keep stable: the
# GBDT models index by position.
READ_FEATURES = (
    "throughput_mbs",      # app-visible read MB/s this interval
    "rpc_rate",            # RPCs sent per second
    "avg_pages_per_rpc",   # mean formed-RPC size in pages
    "partial_rpc_frac",    # fraction of RPCs dispatched below the window
    "avg_rpc_latency_ms",  # mean sojourn of completed RPCs
    "avg_pending_mb",      # time-avg bytes waiting for a slot
    "avg_active_rpcs",     # time-avg RPCs in flight
    "slot_utilization",    # avg_active / rpcs_in_flight knob
    "req_rate",            # app requests per second
    "avg_req_kb",          # mean app request size
    "randomness",          # client-side offset-jump estimate [0,1]
    "cache_hit_rate",      # readahead-covered fraction of request bytes
    "window_pages_log2",   # knob in effect during the interval
    "rpcs_in_flight_log2",
)

WRITE_FEATURES = (
    "throughput_mbs",
    "rpc_rate",
    "avg_pages_per_rpc",
    "partial_rpc_frac",
    "avg_rpc_latency_ms",
    "avg_pending_mb",
    "avg_active_rpcs",
    "slot_utilization",
    "req_rate",
    "avg_req_kb",
    "randomness",
    "block_frac",          # fraction of interval the app sat grant-blocked
    "avg_dirty_mb",        # time-avg dirty cache occupancy
    "avg_grant_mb",        # time-avg grant consumption
    "window_pages_log2",
    "rpcs_in_flight_log2",
)

N_READ = len(READ_FEATURES)
N_WRITE = len(WRITE_FEATURES)

# positions of the knob features inside each op's snapshot vector
READ_KNOB_IDX = (READ_FEATURES.index("window_pages_log2"),
                 READ_FEATURES.index("rpcs_in_flight_log2"))
WRITE_KNOB_IDX = (WRITE_FEATURES.index("window_pages_log2"),
                  WRITE_FEATURES.index("rpcs_in_flight_log2"))


def feature_dim(op: int, k: int = 1) -> int:
    """Model input width: k+1 snapshots, then θ and Δθ (2 each)."""
    base = N_READ if op == READ else N_WRITE
    return base * (k + 1) + 4


@dataclasses.dataclass
class FleetSnapshot:
    """One interval's designed metrics for all probed interfaces."""

    t: float
    dt: float
    oscs: torch.Tensor          # (n,)
    read: torch.Tensor          # (n, N_READ) float64
    write: torch.Tensor         # (n, N_WRITE) float64
    read_volume: torch.Tensor   # (n,) bytes moved (model-selection signal)
    write_volume: torch.Tensor


def _log2_knob(x: torch.Tensor) -> torch.Tensor:
    """``log2`` of a knob column, exact on powers of two.

    Knob values are powers of two (the Θ grid), where ``frexp`` gives
    the exponent exactly whatever the backend's ``log2``; other values
    (only reachable by writing knobs outside Θ) use ``log2``.
    """
    x = x.to(F64)
    m, e = torch.frexp(x)
    return torch.where(m == 0.5, (e - 1).to(F64), torch.log2(x))


def snapshot_arrays(prev, cur):
    """The tensor core of :func:`snapshot_all` (the reference's
    ``snapshot_arrays``): two probes differenced in float64, in the
    reference's op order.

    ``prev`` / ``cur`` expose the :class:`FleetStats` field surface (a
    :class:`FleetStats`, or the fused loop's ``Probe``); their clock
    ``t`` is a float or a 0-dim tensor.  ``dt`` is a 0-dim float64
    tensor on the counters' device either way, so the host and the
    fused paths divide by it with the same operation.

    Returns ``(dt, read_mat, write_mat, read_volume, write_volume)``.
    """
    dev = cur.bytes_done.device
    dt = cur.t - prev.t
    if not torch.is_tensor(dt):
        dt = torch.tensor(dt, dtype=F64, device=dev)
    dt = torch.clamp_min(dt, 1e-9)

    def safe_div(a, b):
        ok = b > 0
        return torch.where(ok, a / torch.where(ok, b, 1.0), 0.0)

    def diff(name, op=None):
        a, b = getattr(cur, name), getattr(prev, name)
        if op is not None:
            a, b = a[op], b[op]
        return (a - b).to(F64)

    rif = cur.rpcs_in_flight.to(F64)

    def common(op: int) -> list:
        d_rpcs = diff("rpcs_sent", op)
        d_act = diff("active_integral", op)
        d_reqs = diff("req_count", op)
        return [
            diff("bytes_done", op) / dt / 1e6,
            d_rpcs / dt,
            safe_div(diff("rpc_bytes", op), d_rpcs) / PAGE_SIZE,
            safe_div(diff("partial_rpcs", op), d_rpcs),
            safe_div(diff("latency_sum", op), diff("rpcs_done", op)) * 1e3,
            diff("pending_integral", op) / dt / 2**20,
            d_act / dt,
            safe_div(d_act / dt, rif),
            d_reqs / dt,
            safe_div(diff("req_bytes", op), d_reqs) / 1024.0,
            cur.randomness[op].to(F64),
        ]

    knobs = [_log2_knob(cur.window_pages), _log2_knob(cur.rpcs_in_flight)]

    r = common(READ)
    r.append(safe_div(diff("cache_hit_bytes"), diff("req_bytes", READ)))
    read_mat = torch.stack(r + knobs, dim=1)

    w = common(WRITE)
    w.append(diff("block_time") / dt)
    w.append(diff("dirty_integral") / dt / 2**20)
    w.append(diff("grant_integral") / dt / 2**20)
    write_mat = torch.stack(w + knobs, dim=1)

    return (dt, read_mat, write_mat, diff("bytes_done", READ),
            diff("bytes_done", WRITE))


def snapshot_all(prev: FleetStats, cur: FleetStats) -> FleetSnapshot:
    """The designed metrics of every probed interface for one interval
    (:func:`snapshot_arrays` on two host-clock probes)."""
    _, read_mat, write_mat, read_vol, write_vol = snapshot_arrays(prev, cur)
    return FleetSnapshot(t=cur.t, dt=max(cur.t - prev.t, 1e-9),
                         oscs=cur.oscs, read=read_mat, write=write_mat,
                         read_volume=read_vol, write_volume=write_vol)


def fleet_feature_matrix(history: list, op: int, rows: torch.Tensor,
                         theta_feats: torch.Tensor) -> torch.Tensor:
    """Model inputs of interfaces ``rows`` against every candidate θ.

    ``history`` is ``[s_{t-k}, ..., s_t]``, ``theta_feats`` the ``(M, 2)``
    float64 log2 grid.  Returns ``(len(rows) * M, dim)`` float32,
    interface-major: row ``i * M + j`` is (H_t of ``rows[i]``, θ_j,
    θ_j - θ applied), each block rounded from float64 as the reference
    rounds it.
    """
    mats = [(h.read if op == READ else h.write)[rows] for h in history]
    hist = torch.cat(mats, dim=1)                  # (r, N*(k+1)) float64
    knobs = list(READ_KNOB_IDX if op == READ else WRITE_KNOB_IDX)
    cur = mats[-1][:, knobs]                       # (r, 2) applied θ
    r, m = hist.shape[0], theta_feats.shape[0]
    theta_tiled = theta_feats.repeat(r, 1)         # (r*M, 2) float64
    out = torch.empty((r * m, hist.shape[1] + 4), dtype=torch.float32,
                      device=hist.device)
    out[:, :-4] = hist.repeat_interleave(m, dim=0)
    out[:, -4:-2] = theta_tiled
    out[:, -2:] = theta_tiled - cur.repeat_interleave(m, dim=0)
    return out
