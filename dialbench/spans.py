"""The program's own host spans as the per-layer metrics read them.

The program records a span at each boundary of the lab path's layers
(``repro_torch.obs.timers``: ``(name, start_ns, end_ns, id, parent,
root)``, stamped on ``time.perf_counter_ns()``, the clock of the
harness's call stamps) and keeps the finished ones in a ring.  Here,
all the arithmetic: the spans of the measured window, their sums and
self times by name, their stamps on the profiler's clock, and the
profiled call's device idle time that no span covers.  The drivers load
the program; this module loads nothing of it and reads no more than the
ring the loaded program keeps.  Every function returns ``None`` where
the program records no spans.
"""

from __future__ import annotations

import statistics
import sys
import time

from dialbench import trace

RECORDER = "repro_torch.obs.timers"


def _ring():
    """Every finished span in the loaded program's ring, or ``None``
    where the program is not loaded or records no spans."""
    read = getattr(sys.modules.get(RECORDER), "spans", None)
    return None if read is None else read()


def window(ctx):
    """The spans inside the measured window: each starts at or after the
    first call's start and ends at or before the last call's end (the
    set-up's warm calls and the traced run's profiled call fall
    outside); ``None`` where there are none."""
    ring = _ring()
    if ring is None or not ctx["calls"]:
        return None
    lo = round(ctx["calls"][0][0] * 1e9)
    hi = round(ctx["calls"][-1][1] * 1e9)
    return [s for s in ring if s[1] >= lo and s[2] <= hi] or None


def total_ns(spans, name: str) -> int:
    """The summed duration of the spans named ``name``."""
    return sum(s[2] - s[1] for s in spans if s[0] == name)


def self_ns(spans, name: str) -> int:
    """The spans named ``name``: their summed duration less the part of
    each that its child spans cover."""
    kids = {}
    for s in spans:
        if s[4] is not None:
            kids.setdefault(s[4], []).append(s)
    out = 0
    for s in spans:
        if s[0] == name:
            inner = sorted(kids.get(s[3], ()), key=lambda k: k[1])
            out += s[2] - s[1] - trace.busy_ns(inner, s[1], s[2])
    return out


def ms_per_interval(ctx, name: str, less: str | None = None):
    """The window's spans named ``name`` (less those named ``less``),
    ms an interval of the window's calls."""
    spans = window(ctx)
    if spans is None:
        return None
    ns = total_ns(spans, name) - (total_ns(spans, less) if less else 0)
    return ns / 1e6 / sum(c.intervals for _, _, c in ctx["calls"])


def profiler_offset_ns() -> int:
    """What puts a ``perf_counter_ns`` stamp on ``torch.profiler``'s
    clock (kineto stamps its events on ``time.time_ns()``): the median
    offset of a few back-to-back paired reads of the two clocks."""
    return statistics.median_low(
        time.time_ns() - time.perf_counter_ns() for _ in range(5))


def on_profiler_clock():
    """Every span in the program's ring as ``(name, start_ns, end_ns)``
    on the profiler's clock, sorted by start; ``None`` without a
    recorder."""
    ring = _ring()
    if ring is None:
        return None
    offset = profiler_offset_ns()
    return sorted(((s[0], s[1] + offset, s[2] + offset) for s in ring),
                  key=lambda s: s[1])


def unspanned_idle_pct(ctx, spans=None):
    """The profiled call's device idle time (over the idle window that
    ``device_idle_pct`` reads) that no program span covers, in % of the
    idle time; idle time under the profiler's own host ranges
    (:data:`dialbench.trace.PROFILER_RANGES`) is left out of both.
    ``spans``: ``(name, start, end)`` on the profiler's clock (default:
    the program's, :func:`on_profiler_clock`)."""
    p = ctx["profile"]
    if p is None or p["idle"] is None:
        return None
    spans = on_profiler_clock() if spans is None else spans
    if not spans:
        return None
    lo, hi = p["idle"]
    profiler = [r for r in p["host"] if r[0] in trace.PROFILER_RANGES]

    def idle_ns(host) -> int:
        busy = sorted(list(p["device"]) + host, key=lambda r: r[1])
        return hi - lo - trace.busy_ns(busy, lo, hi)

    base = idle_ns(profiler)
    if base <= 0:
        return None
    return 100.0 * idle_ns(profiler + list(spans)) / base
