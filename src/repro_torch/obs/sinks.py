"""Host-side trace sinks: JSONL, Chrome ``trace_event``, markdown.

A copy of the reference's ``repro/obs/sinks.py`` (numpy and the
standard library only): a file written by either package reads back in
the other, and the same arrays render the same Chrome trace and summary.

The JSONL sink is the lossless interchange format (one record per line,
first line a ``meta`` header; round-trips through :func:`read_jsonl`).
The Chrome sink renders the same records as a ``trace_event`` JSON that
opens directly in Perfetto / ``chrome://tracing``: one counter track
per OST (throughput, queue, dirty-cache room, disturbance scales) and
one thread per interface carrying its decisions as instant events —
applied θ changes stand out as named markers with the full Algorithm 1
provenance in ``args``.  Timestamps are simulated microseconds.
"""

from __future__ import annotations

import json

import numpy as np

from repro_torch.obs.schema import (TRACE_SCHEMA, TRACE_SCHEMAS, RunTrace,
                              TraceConfig)


# ---------------------------------------------------------------------- #
# JSONL
# ---------------------------------------------------------------------- #
def write_jsonl(trace: RunTrace, path: str,
                diagnosis: dict | None = None) -> str:
    meta = {
        "kind": "meta",
        "schema": TRACE_SCHEMA,
        "stride": trace.config.stride,
        "timeline": trace.config.timeline,
        "interval_seconds": trace.interval_seconds,
        "tick_seconds": trace.tick_seconds,
        "oscs": [int(x) for x in trace.oscs],
        "n_intervals": trace.n_intervals,
    }
    with open(path, "w") as f:
        f.write(json.dumps(meta) + "\n")
        for row in trace.decision_rows():
            f.write(json.dumps(row) + "\n")
        for row in trace.timeline_rows():
            f.write(json.dumps(row) + "\n")
        if diagnosis is not None:
            f.write(json.dumps({"kind": "diagnosis", **diagnosis},
                               sort_keys=True) + "\n")
    return path


def read_jsonl(path: str) -> RunTrace:
    """Rebuild a :class:`RunTrace` from its JSONL serialization.

    Accepts any schema in :data:`~repro_torch.obs.schema.TRACE_SCHEMAS`.
    Dispatch is by explicit ``kind`` — a ``diagnosis`` record (or any
    future kind) is surfaced via :func:`read_jsonl_diagnosis`, never
    misfiled as a timeline row.
    """
    with open(path) as f:
        meta = json.loads(f.readline())
        if meta.get("schema") not in TRACE_SCHEMAS:
            raise ValueError(f"not a {'/'.join(TRACE_SCHEMAS)} file: {path}")
        dec_rows, tl_rows = [], []
        for line in f:
            row = json.loads(line)
            if row["kind"] == "decision":
                dec_rows.append(row)
            elif row["kind"] == "timeline":
                tl_rows.append(row)

    oscs = np.asarray(meta["oscs"], dtype=np.int64)
    n, m = meta["n_intervals"], len(oscs)
    col = {j: idx for idx, j in enumerate(meta["oscs"])}
    n_probs = len(dec_rows[0]["probs"]) if dec_rows else 0
    dec = {
        "t": np.zeros(n),
        "decided": np.zeros((n, m), dtype=bool),
        "ops": np.zeros((n, m), dtype=np.int64),
        "theta": np.zeros((n, m, 2), dtype=np.int64),
        "changed": np.zeros((n, m), dtype=bool),
        "n_candidates": np.zeros((n, m), dtype=np.int64),
        "score": np.zeros((n, m)),
        "probs": np.zeros((n, m, n_probs)),
        "vol_r": np.zeros((n, m)), "vol_w": np.zeros((n, m)),
        "active": np.zeros((n, m), dtype=bool),
        "steady": np.zeros((n, m), dtype=bool),
        "warm": np.zeros((n, m), dtype=bool),
        "ratio": np.zeros((n, m)),
    }
    for r in dec_rows:
        i, j = r["interval"], col[r["osc"]]
        dec["t"][i] = r["t"]
        dec["decided"][i, j] = r["decided"]
        dec["ops"][i, j] = r["op"]
        dec["theta"][i, j] = r["theta"]
        dec["changed"][i, j] = r["changed"]
        dec["n_candidates"][i, j] = r["n_candidates"]
        dec["score"][i, j] = r["score"]
        dec["probs"][i, j] = r["probs"]
        for k in ("vol_r", "vol_w", "active", "steady", "warm", "ratio"):
            dec[k][i, j] = r[k]

    timeline = None
    if tl_rows:
        tl_rows.sort(key=lambda r: r["sample"])
        timeline = {"t": np.asarray([r["t"] for r in tl_rows])}
        from repro_torch.obs.schema import TIMELINE_FIELDS
        for k in TIMELINE_FIELDS[1:]:
            timeline[k] = np.asarray([r[k] for r in tl_rows])
    cfg = TraceConfig(stride=meta["stride"], timeline=meta["timeline"])
    return RunTrace(decisions=dec, timeline=timeline, oscs=oscs,
                    config=cfg,
                    interval_seconds=meta["interval_seconds"],
                    tick_seconds=meta["tick_seconds"])


def read_jsonl_diagnosis(path: str) -> dict | None:
    """The file's ``diagnosis`` record, if one was stamped."""
    with open(path) as f:
        meta = json.loads(f.readline())
        if meta.get("schema") not in TRACE_SCHEMAS:
            raise ValueError(f"not a {'/'.join(TRACE_SCHEMAS)} file: {path}")
        for line in f:
            row = json.loads(line)
            if row["kind"] == "diagnosis":
                return {k: v for k, v in row.items() if k != "kind"}
    return None


# ---------------------------------------------------------------------- #
# Chrome trace_event (Perfetto)
# ---------------------------------------------------------------------- #
_OST_PID = 1          # process grouping the per-OST counter tracks
_IF_PID = 2           # process grouping the per-interface decision rows
_DIAG_PID = 3         # process carrying diagnosis verdict markers


def chrome_trace(trace: RunTrace, diagnosis: dict | None = None) -> dict:
    """The run as a Chrome ``trace_event`` object (JSON-serializable).

    Counter events (``ph: "C"``) per OST — throughput derived from the
    cumulative byte counters between samples — and instant events
    (``ph: "i"``) per interface decision.  ``ts`` is simulated time in
    microseconds; events are emitted time-sorted.

    With ``diagnosis`` (a :mod:`repro_torch.obs.diagnose` report), a third
    process carries the verdict: one process-scoped instant at t=0
    naming the dominant cause (arm throughputs in ``args``) plus one
    instant per evidence row, landed on the *same* interval timestamps
    as the decision rows they explain, so cause markers line up with
    the decisions they indict in Perfetto.
    """
    events = [
        {"ph": "M", "pid": _OST_PID, "name": "process_name",
         "args": {"name": "osts"}},
        {"ph": "M", "pid": _IF_PID, "name": "process_name",
         "args": {"name": "interfaces"}},
    ]
    timed = []
    if trace.timeline is not None:
        tl = trace.timeline
        n_s, n_o = tl["read_bytes"].shape
        for o in range(n_o):
            events.append({"ph": "M", "pid": _OST_PID, "tid": o,
                           "name": "thread_name",
                           "args": {"name": f"ost{o}"}})
        t = tl["t"]
        for i in range(n_s):
            ts = t[i] * 1e6
            dt = (t[i] - t[i - 1]) if i else max(float(t[i]), 1e-9)
            for o in range(n_o):
                read_mbs = ((tl["read_bytes"][i, o]
                             - (tl["read_bytes"][i - 1, o] if i else 0.0))
                            / dt / 1e6)
                write_mbs = ((tl["write_bytes"][i, o]
                              - (tl["write_bytes"][i - 1, o] if i else 0.0))
                             / dt / 1e6)
                timed.append({"ph": "C", "pid": _OST_PID, "tid": o,
                              "name": f"ost{o}.throughput_mbs", "ts": ts,
                              "args": {"read": round(read_mbs, 3),
                                       "write": round(write_mbs, 3)}})
                timed.append({"ph": "C", "pid": _OST_PID, "tid": o,
                              "name": f"ost{o}.queue", "ts": ts,
                              "args": {"queue_mb":
                                       round(tl["queue_bytes"][i, o] / 1e6,
                                             3),
                                       "active_rpcs":
                                       round(float(tl["active_rpcs"][i, o]),
                                             2)}})
                timed.append({"ph": "C", "pid": _OST_PID, "tid": o,
                              "name": f"ost{o}.dirty_room_mb", "ts": ts,
                              "args": {"room":
                                       round(tl["dirty_room"][i, o] / 1e6,
                                             3)}})
                timed.append({"ph": "C", "pid": _OST_PID, "tid": o,
                              "name": f"ost{o}.disturbance", "ts": ts,
                              "args": {"bw": round(float(tl["bw_scale"][i, o]), 3),
                                       "iops": round(float(tl["iops_scale"][i, o]), 3),
                                       "bg_mb": round(tl["bg_bytes"][i, o] / 1e6, 3)}})

    d = trace.decisions
    for j in range(trace.n_interfaces):
        events.append({"ph": "M", "pid": _IF_PID, "tid": int(trace.oscs[j]),
                       "name": "thread_name",
                       "args": {"name": f"if{int(trace.oscs[j])}"}})
    for i in range(trace.n_intervals):
        ts = float(d["t"][i]) * 1e6
        for j in range(trace.n_interfaces):
            if not d["decided"][i, j]:
                continue
            th = d["theta"][i, j]
            name = (f"θ→{int(th[0])}x{int(th[1])}" if d["changed"][i, j]
                    else "hold")
            timed.append({
                "ph": "i", "s": "t", "pid": _IF_PID,
                "tid": int(trace.oscs[j]), "ts": ts, "name": name,
                "args": {
                    "op": "read" if int(d["ops"][i, j]) == 0 else "write",
                    "theta": [int(th[0]), int(th[1])],
                    "changed": bool(d["changed"][i, j]),
                    "n_candidates": int(d["n_candidates"][i, j]),
                    "score": round(float(d["score"][i, j]), 4),
                    "p_max": round(float(d["probs"][i, j].max())
                                   if d["probs"].shape[2] else 0.0, 4),
                }})
    if diagnosis is not None:
        cause = diagnosis.get("cause", "unknown")
        events.append({"ph": "M", "pid": _DIAG_PID, "name": "process_name",
                       "args": {"name": "diagnosis"}})
        events.append({"ph": "M", "pid": _DIAG_PID, "tid": 0,
                       "name": "thread_name",
                       "args": {"name": f"cause:{cause}"}})
        timed.append({"ph": "i", "s": "p", "pid": _DIAG_PID, "tid": 0,
                      "ts": 0.0, "name": f"verdict:{cause}",
                      "args": {"losing": diagnosis.get("losing"),
                               "arms": diagnosis.get("arms", {}),
                               "n_evidence_total":
                               diagnosis.get("n_evidence_total")}})
        for row in diagnosis.get("evidence", []):
            if "t" not in row:       # arm-summary rows carry no timestamp
                continue
            # land on the trace's own interval timestamp (the evidence
            # rounds t for the report; the raw floats must match the
            # decision instants exactly to line up in Perfetto)
            i = row.get("interval", -1)
            ts = (float(d["t"][i]) * 1e6 if 0 <= i < len(d["t"])
                  else float(row["t"]) * 1e6)
            timed.append({"ph": "i", "s": "p", "pid": _DIAG_PID, "tid": 0,
                          "ts": ts, "name": cause,
                          "args": {k: v for k, v in row.items()
                                   if k != "t"}})
    timed.sort(key=lambda e: e["ts"])
    return {"traceEvents": events + timed,
            "displayTimeUnit": "ms",
            "otherData": {"schema": TRACE_SCHEMA}}


def write_chrome(trace: RunTrace, path: str,
                 diagnosis: dict | None = None) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(trace, diagnosis=diagnosis), f)
    return path


# ---------------------------------------------------------------------- #
# markdown summary
# ---------------------------------------------------------------------- #
def render_summary(trace: RunTrace, title: str = "trace",
                   diagnosis: dict | None = None) -> str:
    """Human-readable digest: gate outcomes, θ trajectory, hot OSTs —
    plus the counterfactual verdict when a diagnosis rides along."""
    d = trace.decisions
    n, m = trace.n_intervals, trace.n_interfaces
    lines = [f"# Trace summary — {title}", ""]
    lines.append(f"{n} intervals × {m} interfaces "
                 f"(interval {trace.interval_seconds:.3g} s, timeline "
                 f"stride {trace.config.stride} ticks).")
    lines.append("")
    if m:
        total = n * m
        gates = {
            "decided": int(d["decided"].sum()),
            "cold (warmup)": int((~d["warm"]).sum()),
            "idle (volume gate)": int((d["warm"] & ~d["active"]).sum()),
            "bursty (steadiness gate)": int(
                (d["warm"] & d["active"] & ~d["steady"]).sum()),
        }
        lines.append("| gate outcome | rows | share |")
        lines.append("|---|---|---|")
        for k, v in gates.items():
            lines.append(f"| {k} | {v} | {100 * v / total:.1f}% |")
        lines.append("")
        changes = int(d["changed"].sum())
        lines.append(f"Algorithm 1 applied **{changes}** θ change(s); "
                     f"mean candidates past τ on decided rows: "
                     f"{float(d['n_candidates'][d['decided']].mean()) if d['decided'].any() else 0:.1f}.")
        lines.append("")
        lines.append("## θ changes")
        lines.append("")
        any_change = False
        for i in range(n):
            for j in np.nonzero(d["changed"][i])[0]:
                any_change = True
                th = d["theta"][i, j]
                lines.append(
                    f"- t={d['t'][i]:.2f}s if{int(trace.oscs[j])}: "
                    f"θ→({int(th[0])}, {int(th[1])}) "
                    f"[{'read' if int(d['ops'][i, j]) == 0 else 'write'} "
                    f"model, {int(d['n_candidates'][i, j])} candidates, "
                    f"score {float(d['score'][i, j]):.3f}]")
        if not any_change:
            lines.append("- none")
        lines.append("")
    if trace.timeline is not None and len(trace.timeline["t"]):
        tl = trace.timeline
        span = max(float(tl["t"][-1]) - float(tl["t"][0]), 1e-9)
        lines.append("## OST timeline")
        lines.append("")
        lines.append("| OST | read MB/s | write MB/s | peak queue MB | "
                     "min dirty room MB |")
        lines.append("|---|---|---|---|---|")
        for o in range(tl["read_bytes"].shape[1]):
            rd = (tl["read_bytes"][-1, o] - tl["read_bytes"][0, o]) / span
            wr = (tl["write_bytes"][-1, o] - tl["write_bytes"][0, o]) / span
            lines.append(f"| {o} | {rd / 1e6:.1f} | {wr / 1e6:.1f} | "
                         f"{tl['queue_bytes'][:, o].max() / 1e6:.1f} | "
                         f"{tl['dirty_room'][:, o].min() / 1e6:.1f} |")
        lines.append("")
    if diagnosis is not None:
        lines.append("## Diagnosis")
        lines.append("")
        lines.append(f"Dominant cause: **{diagnosis.get('cause', '?')}** "
                     f"(losing: {diagnosis.get('losing')}).")
        arms = diagnosis.get("arms", {})
        if arms:
            lines.append("")
            lines.append("| arm | MB/s |")
            lines.append("|---|---|")
            for arm, mbs in arms.items():
                lines.append(f"| {arm} | {float(mbs):.1f} |")
        n_ev = diagnosis.get("n_evidence_total", 0)
        shown = len(diagnosis.get("evidence", []))
        lines.append("")
        lines.append(f"{n_ev} evidence row(s) ({shown} in report); see "
                     f"the JSONL `diagnosis` record for the full rows.")
        lines.append("")
    return "\n".join(lines)
