"""DIAL's tuning tick, plain PyTorch: probe, snapshot, gates, features,
forest scores and Algorithm 1 (Conditional Score Greedy).

The snapshot differences two probes of the cumulative counters into one
read and one write vector per interface (paper §III-A/B) in float64;
the model rows are (history ‖ θ ‖ Δθ) rounded once to float32; a forest
margin is the float32 sum of the reached leaves, tree by tree in
ascending order, then the base; the probability is the float32 sigmoid
of the margin clipped at ±30.  Algorithm 1 keeps the configurations
whose probability exceeds τ, MinMax-normalizes the survivors and takes
the first maximum of the regularized score.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from .engine import PAGE_SIZE, READ, WRITE

F64 = torch.float64
WINDOW_PAGES = (16, 64, 256, 1024)
RPCS_IN_FLIGHT = (1, 2, 4, 8, 16, 32)
N_READ, N_WRITE = 14, 16
READ_KNOB_IDX, WRITE_KNOB_IDX = (12, 13), (14, 15)

# probe field -> state field
PROBE = (("bytes_done", "ctr_bytes_done"), ("rpcs_sent", "ctr_rpcs_sent"),
         ("rpc_bytes", "ctr_rpc_bytes"),
         ("partial_rpcs", "ctr_partial_rpcs"),
         ("latency_sum", "ctr_latency_sum"), ("rpcs_done", "ctr_rpcs_done"),
         ("req_count", "ctr_req_count"), ("req_bytes", "ctr_req_bytes"),
         ("pending_integral", "ctr_pending_integral"),
         ("active_integral", "ctr_active_integral"),
         ("cache_hit_bytes", "ctr_cache_hit_bytes"),
         ("block_time", "ctr_block_time"),
         ("dirty_integral", "ctr_dirty_integral"),
         ("grant_integral", "ctr_grant_integral"),
         ("randomness", "randomness"), ("window_pages", "window_pages"),
         ("rpcs_in_flight", "rpcs_in_flight"))


@dataclasses.dataclass(frozen=True)
class Tuner:
    """Algorithm 1's and the gates' constants."""

    tau: float = 0.8
    alpha: float = 0.3
    beta: float = 0.25
    k: int = 1
    min_volume_bytes: float = 256 * 1024
    warmup_intervals: int = 2


def theta_grid() -> np.ndarray:
    """(24, 2) float64 configurations, window-major."""
    return np.array(list(itertools.product(WINDOW_PAGES, RPCS_IN_FLIGHT)),
                    dtype=np.float64)


def probe(st: dict, device) -> dict:
    """The counters the tuner reads, as float64 on ``device`` (the knobs
    as int64), and the clock."""
    out = {k: st[v].to(device=device,
                       dtype=torch.int64 if k in ("window_pages",
                                                  "rpcs_in_flight") else F64)
           for k, v in PROBE}
    out["t"] = float(st["now"])
    return out


def _log2_knob(x: torch.Tensor) -> torch.Tensor:
    x = x.to(F64)
    m, e = torch.frexp(x)
    return torch.where(m == 0.5, (e - 1).to(F64), torch.log2(x))


def snapshot(prev: dict, cur: dict):
    """``(read (n, 14), write (n, 16), read volume, write volume)``."""
    dev = cur["bytes_done"].device
    dt = torch.clamp_min(torch.tensor(cur["t"] - prev["t"], dtype=F64,
                                      device=dev), 1e-9)

    def safe_div(a, b):
        ok = b > 0
        return torch.where(ok, a / torch.where(ok, b, 1.0), 0.0)

    def diff(name, op=None):
        a, b = cur[name], prev[name]
        if op is not None:
            a, b = a[op], b[op]
        return (a - b).to(F64)

    rif = cur["rpcs_in_flight"].to(F64)

    def common(op):
        d_rpcs = diff("rpcs_sent", op)
        d_act = diff("active_integral", op)
        d_reqs = diff("req_count", op)
        return [diff("bytes_done", op) / dt / 1e6,
                d_rpcs / dt,
                safe_div(diff("rpc_bytes", op), d_rpcs) / PAGE_SIZE,
                safe_div(diff("partial_rpcs", op), d_rpcs),
                safe_div(diff("latency_sum", op), diff("rpcs_done", op)) * 1e3,
                diff("pending_integral", op) / dt / 2**20,
                d_act / dt,
                safe_div(d_act / dt, rif),
                d_reqs / dt,
                safe_div(diff("req_bytes", op), d_reqs) / 1024.0,
                cur["randomness"][op].to(F64)]

    knobs = [_log2_knob(cur["window_pages"]),
             _log2_knob(cur["rpcs_in_flight"])]
    r = common(READ)
    r.append(safe_div(diff("cache_hit_bytes"), diff("req_bytes", READ)))
    w = common(WRITE)
    w.append(diff("block_time") / dt)
    w.append(diff("dirty_integral") / dt / 2**20)
    w.append(diff("grant_integral") / dt / 2**20)
    return (torch.stack(r + knobs, dim=1), torch.stack(w + knobs, dim=1),
            diff("bytes_done", READ), diff("bytes_done", WRITE))


def features(ring: torch.Tensor, rows: torch.Tensor, n_feat: int,
             knob_idx, n_features: int, k: int) -> torch.Tensor:
    """``(len(rows), 24, n_features)`` float32 rows of the interfaces
    ``rows``: their ``(k+1)``-deep history oldest first, then θ and
    θ − the applied θ, each rounded once from float64, zero-padded."""
    theta = torch.log2(torch.as_tensor(theta_grid(), device=ring.device))
    h2 = ring[:, rows].transpose(0, 1).reshape(rows.shape[0], -1)
    last = k * n_feat
    cur = torch.stack([h2[:, last + knob_idx[0]], h2[:, last + knob_idx[1]]],
                      dim=1)
    w = h2.shape[1]
    x = torch.zeros((rows.shape[0], theta.shape[0], n_features),
                    dtype=torch.float32, device=ring.device)
    x[:, :, :w] = h2[:, None, :]
    x[:, :, w:w + 2] = theta
    x[:, :, w + 2:w + 4] = theta - cur[:, None, :]
    return x


def margins(x: torch.Tensor, op: torch.Tensor, forests: dict) -> torch.Tensor:
    """(N,) float32 margins of (N, F) float32 rows, forest ``op`` each
    (``forests``: ``feature`` (2, T, 2^D-1) int, ``threshold`` (2, T,
    2^D-1) float32, ``leaf`` (2, T, 2^D) float32, ``base`` (2,)
    float32, ``depth``)."""
    feature, threshold = forests["feature"], forests["threshold"]
    leaf, base, depth = forests["leaf"], forests["base"], forests["depth"]
    n = x.shape[0]
    _, t, n_int = feature.shape
    n_leaves = leaf.shape[2]
    forest = op.to(torch.int64)
    tree = torch.arange(t, device=x.device)[None, :]
    node_base = forest[:, None] * (t * n_int) + tree * n_int
    feat = feature.reshape(-1).to(torch.int64)
    thr = threshold.reshape(-1)
    idx = torch.zeros((n, t), dtype=torch.int64, device=x.device)
    for _ in range(depth):
        node = node_base + idx
        idx = 2 * idx + 1 + (x.gather(1, feat[node]) > thr[node]).to(
            torch.int64)
    pos = forest[:, None] * (t * n_leaves) + tree * n_leaves + (idx - n_int)
    vals = leaf.reshape(-1)[pos]
    acc = torch.zeros(n, dtype=torch.float32, device=x.device)
    for i in range(t):
        acc = acc + vals[:, i]
    return acc + base[forest]


def sigmoid32(m: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-torch.clamp(m, -30.0, 30.0)))


def algorithm1(probs: torch.Tensor, ops: torch.Tensor, current: torch.Tensor,
               tuner: Tuner) -> dict:
    """Algorithm 1 on every row: ``theta``, ``changed``,
    ``n_candidates``, ``score``."""
    inf = float("inf")
    thetas = torch.as_tensor(theta_grid(), device=probs.device)
    keep = probs > tuner.tau
    any_keep = keep.any(dim=1)
    t3 = thetas[None]
    lo = torch.where(keep[:, :, None], t3, inf).amin(dim=1)
    hi = torch.where(keep[:, :, None], t3, -inf).amax(dim=1)
    span = torch.where(hi - lo > 0, hi - lo, 1.0)
    norm = (t3 - lo[:, None, :]) / span[:, None, :]
    w_scores = probs * (1.0 + tuner.beta * norm.sum(dim=2))
    r_scores = probs * (1.0 + tuner.alpha * norm[:, :, 0]) + norm[:, :, 1]
    scores = torch.where((ops == WRITE)[:, None], w_scores, r_scores)
    scores = torch.where(keep, scores, -inf)
    j = torch.argmax(scores, dim=1)
    cur = current.to(torch.int64)
    theta = torch.where(any_keep[:, None], thetas[j].to(torch.int64), cur)
    return {"theta": theta,
            "changed": any_keep & (theta != cur).any(dim=1),
            "n_candidates": keep.sum(dim=1) * any_keep,
            "score": torch.where(any_keep,
                                 scores.gather(1, j[:, None])[:, 0], 0.0)}
