"""The comparison that decides ``correct``: what a checked call of the
program produced against the reference's run of the same call.

Four numbers, each held to a limit of the cell's own
(``limits/<cell>.json``):

``state_gap``          the engine state after the call: every float
                       field per interface, and the counters summed per
                       OST, each field's largest gap over the largest
                       magnitude the reference's field holds; the worst
                       field;
``ring_gap``           the snapshot history the call ends with, the same
                       way per feature column;
``prob_gap``           the largest gap of a forest probability, or of
                       Algorithm 1's winning score, over the rows both
                       decided;
``decision_mismatch``  interfaces whose ``decided`` differs, decided rows
                       whose θ, ``changed`` or candidate count differs,
                       and interfaces whose final knobs differ, over the
                       rows the reference decided.

An untuned call has only ``state_gap``.
"""

from __future__ import annotations

import torch

from dialbench.reference.engine import COUNTERS, FIELDS, KNOBS

F64 = torch.float64


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest ``|a - b|`` over the largest ``|b|`` (1 where ``b`` is
    all zero); ``inf`` where the shapes differ or a value is not
    finite."""
    if a.shape != b.shape:
        return float("inf")
    a, b = a.to(F64), b.to(F64)
    d = (a - b).abs().max() if a.numel() else torch.tensor(0.0, dtype=F64)
    if not torch.isfinite(d):
        return float("inf")
    scale = b.abs().max() if b.numel() else torch.tensor(0.0, dtype=F64)
    return float(d / (scale if scale > 0 else 1.0))


def _maxabs(a: torch.Tensor, b: torch.Tensor) -> float:
    d = float((a.to(F64) - b.to(F64)).abs().max())
    return d if d == d and d != float("inf") else float("inf")


def _worse(a: float, b: float) -> float:
    """The larger, a NaN counting as infinite."""
    return float("inf") if a != a or b != b else max(a, b)


def state_gap(prog: dict, ref: dict, osc_ost: torch.Tensor,
              n_osts: int) -> float:
    worst = 0.0
    for f in FIELDS + ("issued",):
        if f in KNOBS or f == "write_blocked":
            continue
        worst = _worse(worst, _gap(prog[f], ref[f]))
    for f in COUNTERS:
        p, r = prog[f].to(F64), ref[f].to(F64)
        per_ost = lambda v: torch.zeros(
            (*v.shape[:-1], n_osts), dtype=F64).index_add_(-1, osc_ost, v)
        worst = _worse(worst, _gap(per_ost(p), per_ost(r)))
    return worst


def ring_gap(prog: list, ref: list) -> float:
    """The snapshot history's worst gap per feature column; ``inf``
    where the program's history is not as long as the reference's."""
    if len(prog) != len(ref):
        return float("inf")
    worst = 0.0
    for p, r in zip(prog, ref):
        p, r = p.to(F64), r.to(F64)
        if p.dim() == 3:
            for j in range(r.shape[-1]):
                worst = _worse(worst, _gap(p[..., j], r[..., j]))
        else:
            worst = _worse(worst, _gap(p, r))
    return worst


def decisions(prog: dict, ref_records: list, prog_state: dict,
              ref_state: dict) -> tuple:
    """``(prob_gap, decision_mismatch)`` over a call's intervals."""
    prob_gap, bad, decided = 0.0, 0, 0
    n_int = prog["decided"].shape[0]
    if n_int != len(ref_records):
        return float("inf"), float("inf")
    for i, rec in enumerate(ref_records):
        p_dec = prog["decided"][i].bool()
        r_dec = rec["decided"].bool()
        bad += int((p_dec != r_dec).sum())
        rows = rec["rows"]
        decided += rows.numel()
        if not rows.numel():
            continue
        both = p_dec[rows]
        r_at = rows[both]
        if not r_at.numel():
            continue
        sel = both
        prob_gap = _worse(prob_gap, _maxabs(prog["probs"][i][r_at],
                                            rec["probs"][sel]))
        prob_gap = _worse(prob_gap, _maxabs(prog["score"][i][r_at],
                                            rec["score"][sel]))
        row_bad = ((prog["theta"][i][r_at] != rec["theta"][sel]).any(dim=1)
                   | (prog["changed"][i][r_at].bool() != rec["changed"][sel])
                   | (prog["n_candidates"][i][r_at]
                      != rec["n_candidates"][sel]))
        bad += int(row_bad.sum())
    for k in KNOBS:
        bad += int((prog_state[k] != ref_state[k]).sum())
    return prob_gap, bad / max(decided, 1)


def numbers(prog_out: dict, ref_out: dict, osc_ost, n_osts: int) -> dict:
    """The compared numbers of one checked call."""
    out = {"state_gap": state_gap(prog_out["state"], ref_out["state"],
                                  osc_ost, n_osts)}
    if "records" in prog_out:
        out["ring_gap"] = ring_gap(prog_out["ring"],
                                   [r.cpu() for r in ref_out["ring"]])
        out["prob_gap"], out["decision_mismatch"] = decisions(
            prog_out["records"], ref_out["records"], prog_out["state"],
            ref_out["state"])
    return out


def worst(readings: list) -> dict:
    """The worst reading of each number over several checked calls."""
    out: dict = {}
    for r in readings:
        for k, v in r.items():
            out[k] = _worse(out.get(k, 0.0), v)
    return out


def verdict(values: dict, limits: dict) -> bool:
    """Every number at or under its limit, and every limit read."""
    return set(values) == set(limits) and all(
        values[k] <= limits[k] for k in limits)
