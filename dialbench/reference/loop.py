"""One run of DIAL's closed loop: ``steps`` engine ticks an interval,
then (tuned) the tuning tick of every interface the gates and the tune
mask let decide.

A run starts as the program's fused loop starts one: the previous
probe is the starting state's, the ``(k+1)``-deep snapshot ring is
zeros and the interval counter 0.  The engine runs on its own device
(:func:`~dialbench.reference.engine.engine_device`), the tuning tick on
``device`` (the rows of the decided interfaces only:
the others change nothing).
"""

from __future__ import annotations

import torch

from .engine import READ, WRITE, Engine
from .tuning import (N_READ, N_WRITE, READ_KNOB_IDX, WRITE_KNOB_IDX, Tuner,
                     algorithm1, features, margins, probe, sigmoid32,
                     snapshot)

F64 = torch.float64


def run(engine: Engine, state: dict, n_intervals: int, steps: int,
        schedule=None, tuner: Tuner | None = None, forests: dict | None = None,
        tune_mask: torch.Tensor | None = None, device="cpu") -> dict:
    """Advance ``n_intervals``.  ``schedule(i)`` gives tick ``i``'s
    disturbance (a dict, see :meth:`Engine.step`) or is ``None``.
    ``forests`` ``None`` runs the engine alone.

    Returns ``state`` (the last, on the CPU), and tuned: ``records`` (one dict an
    interval: ``decided`` (n,) bool and, over ``rows``, the decided
    interfaces, ``ops``, ``probs`` (m, 24) float64 and Algorithm 1's
    outcome) and ``ring`` (read, write, read volume, write volume, each
    ``(k+1, n, ...)`` float64 on ``device``).
    """
    st = state
    n = engine.fleet.n_osc
    out = {"records": []}
    if forests is not None:
        k = tuner.k
        prev = probe(st, device)
        ring = [torch.zeros((k + 1, n, N_READ), dtype=F64, device=device),
                torch.zeros((k + 1, n, N_WRITE), dtype=F64, device=device),
                torch.zeros((k + 1, n), dtype=F64, device=device),
                torch.zeros((k + 1, n), dtype=F64, device=device)]
        mask = tune_mask.to(device)
        n_features = forests["n_features"]
    tick = 0
    for i in range(n_intervals):
        for j in range(steps):
            st = engine.step(st, None if schedule is None
                             else schedule(i * steps + j))
        if forests is None:
            continue
        cur = probe(st, device)
        parts = snapshot(prev, cur)
        prev = cur
        ring = [torch.cat([h[1:], s[None]]) for h, s in zip(ring, parts)]
        tick += 1
        vol_r, vol_w = parts[2], parts[3]
        ops = torch.where(vol_r >= vol_w, READ, WRITE)
        active = torch.maximum(vol_r, vol_w) >= tuner.min_volume_bytes
        v0 = torch.where(ops == READ, ring[2][0], ring[3][0])
        v1 = torch.where(ops == READ, vol_r, vol_w)
        ratio = v1 / torch.clamp_min(v0, 1.0)
        steady = (ratio >= 0.5) & (ratio <= 2.0)
        warm = tick >= tuner.warmup_intervals + k + 1
        decide = active & steady & mask & warm
        rows = torch.nonzero(decide)[:, 0]
        rec = {"decided": decide.cpu(), "rows": rows.cpu()}
        if rows.numel():
            op_rows = ops[rows]
            x = torch.where(
                (op_rows == READ)[:, None, None],
                features(ring[0], rows, N_READ, READ_KNOB_IDX, n_features, k),
                features(ring[1], rows, N_WRITE, WRITE_KNOB_IDX, n_features,
                         k))
            m = x.shape[1]
            sel = op_rows.to(torch.int32)[:, None].expand(-1, m).reshape(-1)
            probs = sigmoid32(margins(x.reshape(-1, n_features), sel,
                                      forests)).to(F64).reshape(-1, m)
            current = torch.stack([cur["window_pages"][rows],
                                   cur["rpcs_in_flight"][rows]], dim=1)
            dec = algorithm1(probs, op_rows, current, tuner)
            rec.update(ops=op_rows.cpu(), probs=probs.cpu(),
                       **{key: v.cpu() for key, v in dec.items()})
            apply = dec["changed"]
            wp = st["window_pages"].clone()
            rf = st["rpcs_in_flight"].clone()
            at = rows[apply].to(wp.device)
            wp[at] = dec["theta"][apply, 0].to(wp.device)
            rf[at] = dec["theta"][apply, 1].to(wp.device)
            st = {**st, "window_pages": wp, "rpcs_in_flight": rf}
        out["records"].append(rec)
    out["state"] = {k: v.cpu() if torch.is_tensor(v) else v
                    for k, v in st.items()}
    if forests is not None:
        out["ring"] = ring
    return out
