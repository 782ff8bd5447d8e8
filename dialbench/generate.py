"""The benchmark's inputs, made from a configuration, a traffic mix and
the seed: the fleet's workload rows and wiring, the Scenario Lab's
jittered variants with their disturbance schedules, and the GBDT pair.

Nothing here imports the program.  :mod:`dialbench.program` hands the
same inputs to the program in its own types, and the reference
(:mod:`dialbench.reference`) takes them as they are.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from dialbench.reference.engine import READ, WRITE, Fleet, Params, waves

OPS = {"read": READ, "write": WRITE}
ROW_DEFAULTS = {"randomness": 0.0, "n_threads": 1, "thread_rate": 1.2e9,
                "duty_cycle": 1.0, "period": 10.0}
ROW_FIELDS = ("req_size", "randomness", "n_threads", "thread_rate",
              "duty_cycle", "period")


@dataclasses.dataclass(frozen=True)
class Event:
    """A square-wave (or constant) background burst on some OSTs, in
    element-local OST ids: ``magnitude`` bytes/s while ``start <= t <
    end`` and ``(t - start) mod period < duty * period``."""

    kind: str
    targets: tuple
    magnitude: float
    start: float = 0.0
    end: float = math.inf
    period: float = 0.0
    duty: float = 1.0

    def active(self, t: np.ndarray) -> np.ndarray:
        act = (t >= self.start) & (t < self.end)
        if self.period > 0:
            act &= np.mod(t - self.start, self.period) < (self.duty
                                                           * self.period)
        return act


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One element: ``workloads`` as row dicts (client, op, osts, name
    and :data:`ROW_FIELDS`), ``events``, the starting θ."""

    n_clients: int
    n_osts: int
    workloads: tuple
    events: tuple
    initial_theta: tuple


def params(cfg: dict) -> Params:
    return Params(**cfg["sim_params"])


def _row(client: int, osts: tuple, spec: dict) -> dict:
    row = {**ROW_DEFAULTS, **{k: v for k, v in spec.items()
                              if k in ROW_FIELDS}}
    return {"client": client, "op": OPS[spec["op"]], "osts": tuple(osts),
            "name": spec["name"], **{k: float(row[k]) for k in ROW_FIELDS}}


def fleet_scenario(cfg: dict) -> Scenario:
    """A fleet configuration's one scenario: client ``c`` takes role
    ``c % len(roles)``; within its role, the ``(c // len(roles))``-th
    entry of the role's cycle, striped over ``stripe`` OSTs from ``c``."""
    n_c, n_o = cfg["n_clients"], cfg["n_osts"]
    roles = cfg["roles"]
    rows = []
    for c in range(n_c):
        role = roles[c % len(roles)]
        k = c // len(roles)
        osts = tuple((c + j) % n_o for j in range(min(role["stripe"], n_o)))
        rows.append(_row(c, osts, role["cycle"][k % len(role["cycle"])]))
    return Scenario(n_c, n_o, tuple(rows), (),
                    tuple(cfg["initial_theta"]))


def lab_scenarios(cfg: dict, n: int, seed: int, call: int = 0) -> list:
    """The ``call``-th set of ``n`` structure-preserving jitters of the
    lab configuration's base scenario, as a sweep draws a new set for
    every batch: each workload's request size, thread rate, randomness
    and period, each event's magnitude and phase, drawn from ``(seed,
    call)`` in a few vectorized draws."""
    base = cfg["scenario"]
    rows = [_row(w["client"], tuple(w["osts"]), w) for w in base["workloads"]]
    events = [Event(kind=e["kind"], targets=tuple(e["targets"]),
                    magnitude=float(e["magnitude"]),
                    start=float(e.get("start", 0.0)),
                    end=float(e.get("end", math.inf)),
                    period=float(e.get("period", 0.0)),
                    duty=float(e.get("duty", 1.0))) for e in base["events"]]
    jit = cfg["jitter"]
    rng = np.random.default_rng([int(seed), int(call), int(base["seed"])])
    n_r, n_e = len(rows), len(events)
    req = 2.0 ** rng.uniform(-jit["log2_req"], jit["log2_req"], (n, n_r))
    rate = rng.uniform(*jit["rate"], (n, n_r))
    rnd = rng.uniform(-jit["randomness"], jit["randomness"], (n, n_r))
    per = rng.uniform(*jit["period"], (n, n_r))
    mag = rng.uniform(*jit["burst"], (n, n_e))
    shift = rng.uniform(0.0, jit["phase_s"], (n, n_e))
    theta = tuple(base["initial_theta"])
    out = []
    for i in range(n):
        wls = tuple({**w, "req_size": float(w["req_size"] * req[i, r]),
                     "thread_rate": float(w["thread_rate"] * rate[i, r]),
                     "randomness": float(min(max(w["randomness"]
                                                 + rnd[i, r], 0.0), 1.0)),
                     "period": float(w["period"] * per[i, r])}
                    for r, w in enumerate(rows))
        evs = tuple(Event(ev.kind, ev.targets,
                          float(ev.magnitude * mag[i, e]),
                          ev.start + float(shift[i, e]),
                          ev.end if math.isinf(ev.end)
                          else ev.end + float(shift[i, e]),
                          ev.period, ev.duty)
                    for e, ev in enumerate(events))
        out.append(Scenario(base["n_clients"], base["n_osts"], wls, evs,
                            theta))
    return out


def flat_fleet(scens: list) -> Fleet:
    """Same-shaped scenarios as one block-diagonal fleet: element b's
    client ``c`` is ``b * C + c``, OST ``o`` ``b * O + o``, interface
    ``(c, o)`` ``b * C * O + c * O + o``, row ``r`` ``b * R + r``."""
    s0 = scens[0]
    n_c, n_o, n_r = s0.n_clients, s0.n_osts, len(s0.workloads)
    n_b = len(scens)
    osc_client = np.repeat(np.arange(n_c), n_o)
    osc_ost = np.tile(np.arange(n_o), n_c)
    b = np.arange(n_b)[:, None]
    entry_row, entry_osc = [], []
    for r, w in enumerate(s0.workloads):
        for o in w["osts"]:
            entry_row.append(r)
            entry_osc.append(w["client"] * n_o + o)
    entry_row, entry_osc = np.array(entry_row), np.array(entry_osc)
    op0 = np.array([w["op"] for w in s0.workloads], dtype=np.int64)
    wave = waves(op0, entry_row, entry_osc)
    rows = {"client": (b * n_c + np.array(
                [w["client"] for w in s0.workloads])[None]).reshape(-1),
            "op": np.tile(op0, n_b)}
    for f in ROW_FIELDS:
        rows[f] = np.array([[w[f] for w in s.workloads] for s in scens],
                           dtype=np.float64).reshape(-1)
    rows["stripe_len"] = np.tile(np.array(
        [len(w["osts"]) for w in s0.workloads], dtype=np.float64), n_b)
    return Fleet(
        n_clients=n_b * n_c, n_osts=n_b * n_o,
        osc_client=(b * n_c + osc_client[None]).reshape(-1),
        osc_ost=(b * n_o + osc_ost[None]).reshape(-1),
        rows=rows,
        entry_row=(b * n_r + entry_row[None]).reshape(-1),
        entry_osc=(b * n_c * n_o + entry_osc[None]).reshape(-1),
        wave=np.tile(wave, n_b))


def schedule(scens: list, p: Params, t0_tick: int, n_ticks: int) -> dict:
    """``(n_ticks, B * O)`` ``bg_bytes``: every element's events in its
    own OST columns (the other disturbance fields stay neutral)."""
    n_o = scens[0].n_osts
    t = (t0_tick + np.arange(n_ticks)) * p.tick
    bg = np.zeros((n_ticks, len(scens) * n_o))
    for b, s in enumerate(scens):
        for ev in s.events:
            if ev.kind != "bg_burst":
                raise ValueError(f"event kind {ev.kind!r} is not generated")
            cols = b * n_o + np.asarray(ev.targets, dtype=np.int64)
            bg[:, cols] += (ev.active(t) * ev.magnitude * p.tick)[:, None]
    return {"bg_bytes": bg}


# ---------------------------------------------------------------------- #
# the GBDT pair
# ---------------------------------------------------------------------- #
N_READ, N_WRITE = 14, 16


def feature_ranges(cfg: dict, scens: list, k: int) -> tuple:
    """``(lo, hi)`` float64 arrays of each model input, read then write:
    the snapshot features' ranges from the configuration's request sizes,
    thread rates and physics, then θ (log2) and Δθ."""
    p = cfg["sim_params"]
    ws = [w for s in scens[:64] for w in s.workloads]
    rate = min(max(w["n_threads"] * w["thread_rate"] for w in ws),
               p["ost_bandwidth"] * 4)
    req_lo = min(w["req_size"] for w in ws)
    req_hi = max(w["req_size"] for w in ws)
    mbs = rate / 1e6
    rpc_rate = rate / (16 * 4096)
    req_rate = rate / req_lo
    lat_ms = (p["setup_time_seq"] + p["setup_time_rand"] + p["rtt"]) * 1e3 * 8
    common = [(0.0, mbs), (0.0, rpc_rate), (1.0, 1024.0), (0.0, 1.0),
              (0.0, lat_ms), (0.0, p["max_dirty_bytes"] / 2**20),
              (0.0, 32.0), (0.0, 1.0), (0.0, req_rate),
              (req_lo / 1024, req_hi / 1024), (0.0, 1.0)]
    knobs = [(4.0, 10.0), (0.0, 5.0)]
    read = common + [(0.0, 1.0)] + knobs
    write = common + [(0.0, 1.0), (0.0, p["max_dirty_bytes"] / 2**20),
                      (0.0, p["grant_bytes"] / 2**20)] + knobs
    tail = knobs + [(-6.0, 6.0), (-5.0, 5.0)]
    out = []
    for snap in (read, write):
        rng = snap * (k + 1) + tail
        out.append((np.array([a for a, _ in rng]),
                    np.array([b for _, b in rng])))
    return tuple(out)


def forests(cfg: dict, scens: list, seed: int, device) -> dict:
    """The read/write forest pair, drawn on ``device`` from ``seed`` in a
    few calls: split features (a ``theta_share`` of the nodes split on θ
    or Δθ), thresholds on an ``n_bins`` grid of each feature's range,
    leaves uniform in ``±leaf_scale``, the base margins as configured.
    Float32 thresholds and leaves, int32 features; the write forest's
    width is the larger, the read forest's features stay below its own."""
    m = cfg["model"]
    k = m["k"]
    t, depth, n_bins = m["n_trees"], m["depth"], m["n_bins"]
    n_int = 2 ** depth - 1
    widths = (N_READ * (k + 1) + 4, N_WRITE * (k + 1) + 4)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    u = torch.rand((4, 2, t, n_int), generator=g, device=device,
                   dtype=torch.float64)
    leaf_u = torch.rand((2, t, 2 ** depth), generator=g, device=device,
                        dtype=torch.float64)
    feature = torch.empty((2, t, n_int), dtype=torch.int64, device=device)
    threshold = torch.empty((2, t, n_int), dtype=torch.float32,
                            device=device)
    ranges = feature_ranges(cfg, scens, k)
    for f, (width, (lo, hi)) in enumerate(zip(widths, ranges)):
        snap = width - 4
        on_theta = u[0, f] < m["theta_share"]
        pick_theta = snap + torch.floor(u[1, f] * 4).to(torch.int64)
        pick_snap = torch.floor(u[2, f] * snap).to(torch.int64)
        feat = torch.where(on_theta, pick_theta, pick_snap)
        lo_t = torch.as_tensor(lo, device=device)[feat]
        hi_t = torch.as_tensor(hi, device=device)[feat]
        b = torch.floor(u[3, f] * n_bins) + 1.0
        threshold[f] = (lo_t + (hi_t - lo_t) * b / (n_bins + 1)).to(
            torch.float32)
        feature[f] = feat
    leaf = ((leaf_u * 2.0 - 1.0) * m["leaf_scale"]).to(torch.float32)
    base = torch.tensor(m["base_margin"], dtype=torch.float32, device=device)
    return {"feature": feature.to(torch.int32), "threshold": threshold,
            "leaf": leaf, "base": base, "depth": depth,
            "n_features": max(widths), "widths": widths}
