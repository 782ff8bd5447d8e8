"""The arithmetic of the per-layer metrics, from what a traced run
collected (``ctx``, see :func:`dialbench.harness.run`).

``ctx["calls"]``     the window's calls: ``(host start, host end, Call)``;
``ctx["cache"]``     the program's loop-cache counters before and after
                     the window (``None`` where the driver has none);
``ctx["profile"]``   one call of the cell under the profiler: device
                     activities and host ranges, the call's window, its
                     replays, the benchmark's marks, the idle window
                     (:func:`dialbench.trace.active_window`);
``ctx["launches"]``  the kernel launches of one interval with their
                     shapes;
``ctx["ab"]``        device ms per interval of the tuned loop and of an
                     untuned one, alternated.

Every function returns ``None`` where it finds nothing to read.
"""

from __future__ import annotations

import statistics

from dialbench import roofline, trace


def _timed(ctx) -> list:
    return [(t0, t1, c) for t0, t1, c in ctx["calls"]
            if c.device_ms is not None]


def host_ms_per_interval(ctx):
    """The calls' run on the host clock (the whole call where the driver
    times no run of its own) less their device span, an interval."""
    calls = _timed(ctx)
    if not calls:
        return None
    n = sum(c.intervals for _, _, c in calls)
    host = sum((t1 - t0 if c.run_s is None else c.run_s) * 1e3
               - c.device_ms * c.intervals for t0, t1, c in calls)
    return host / n


def build_ms_per_interval(ctx):
    """The program's scenario build and stack, host clock, an
    interval."""
    calls = [c for _, _, c in ctx["calls"] if c.build_s is not None]
    if not calls:
        return None
    return (sum(c.build_s for c in calls) * 1e3
            / sum(c.intervals for c in calls))


def device_ms_per_interval(ctx):
    """The replays' span on the device's clock, an interval."""
    calls = _timed(ctx)
    if not calls:
        return None
    n = sum(c.intervals for _, _, c in calls)
    return sum(c.device_ms * c.intervals for _, _, c in calls) / n


def _cache_delta(ctx, key: str):
    before, after = ctx["cache"]
    if before is None:
        return None
    return after[key] - before[key]


def captures_per_call(ctx):
    """The CUDA-graph captures of the window's calls, a call."""
    d = _cache_delta(ctx, "captures")
    return None if d is None else d / len(ctx["calls"])


def capture_ms_per_interval(ctx):
    """The seconds the window's captures took (capture and
    instantiation, the program's counter), an interval."""
    d = _cache_delta(ctx, "capture_s")
    if d is None:
        return None
    return d * 1e3 / sum(c.intervals for _, _, c in ctx["calls"])


def kernels_per_interval(ctx, mark: str = "replays"):
    """Device operations that start inside the profiled call's replays
    (which are waited for inside their mark), host transfers left out,
    a replay."""
    p = ctx["profile"]
    if p is None or mark not in p["marks"] or not p["device"]:
        return None
    lo, hi = p["marks"][mark]
    n = sum(1 for name, s, e, _ in p["device"]
            if lo <= s < hi
            and not name.startswith(("Memcpy HtoD", "Memcpy DtoH")))
    return n / p["replays"]


def tune_us_per_ifc(ctx):
    """The tuned interval's device time over the untuned one's, per
    interface: the median of the alternated pairs' differences, so that
    a pair whose two runs sit in one mode of the device is what
    counts."""
    ab = ctx["ab"]
    if not ab:
        return None
    diffs = [t - s for t, s in zip(ab["tuned"], ab["static"])]
    return statistics.median(diffs) * 1e3 / ctx["n_osc"]


def roofline_pct(ctx, kernel: str, needle: str):
    """The least time of one interval's launches of ``kernel`` (their
    shapes from ``ctx["launches"]``) over the time the profiled call
    spent in the kernels named with ``needle``, per interval run, in %.
    The call runs whole intervals (its replays, and the eager warm-up
    interval of a capture), so its launches are a multiple of one
    interval's; ``None`` where they are not."""
    p, launches = ctx["profile"], ctx["launches"]
    if p is None or not launches:
        return None
    n, bound_s = roofline.bound_s(launches, kernel)
    count, secs = trace.kernel_time(p["device"], p["lo"], p["hi"], needle)
    if not n or not count or count % n or secs <= 0:
        return None
    return 100.0 * bound_s * (count // n) / secs


def device_idle_pct(ctx):
    """The idle window's wall less its device busy union, in % (the
    window the driver names: a fleet session's replays, first
    operation to last; a lab call, start to last operation), the idle
    time spent in the profiler's own work left out of both."""
    p = ctx["profile"]
    if p is None or p["idle"] is None:
        return None
    lo, hi = p["idle"]
    busy = trace.busy_per_device_ns(p["device"], lo, hi)
    return 100.0 * (1.0 - busy / (hi - lo - p["profiler_idle_ns"]))


def straggler_pct(ctx):
    """(max - min) / mean of each device's mean device ms per interval
    over the window's sharded calls, in %."""
    per = [c.per_device_ms for _, _, c in ctx["calls"] if c.per_device_ms]
    if not per or any(v is None for row in per for v in row):
        return None
    means = [statistics.fmean(col) for col in zip(*per)]
    return 100.0 * (max(means) - min(means)) / statistics.fmean(means)
