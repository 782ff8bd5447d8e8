"""Reading a ``torch.profiler`` trace: device activity, its union over a
window, the idle gaps and what the host was doing in them.

Times are nanoseconds on the profiler's clock, which the host ranges
and the device activities share.
"""

from __future__ import annotations

import collections


def _span(ev) -> tuple:
    """``(start_ns, end_ns)`` of a kineto event (torch versions name the
    accessors in ns or in us)."""
    if hasattr(ev, "start_ns"):
        start, dur = ev.start_ns(), ev.duration_ns()
    else:
        start, dur = ev.start_us() * 1000, ev.duration_us() * 1000
    return int(start), int(start + dur)


def events(prof) -> tuple:
    """``(device, host)``: device activities (kernels, copies, sets) as
    ``(name, start_ns, end_ns, device index)`` and host ranges
    (operators, runtime calls, the benchmark's marks) as ``(name,
    start_ns, end_ns)``, each sorted by start."""
    from torch.autograd import DeviceType

    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        start, end = _span(ev)
        if end <= start:
            continue
        if ev.device_type() == DeviceType.CUDA:
            marked = getattr(ev, "is_user_annotation", lambda: False)()
            if marked or ev.name().startswith("dialbench."):
                continue            # a host mark's shadow on the device
            device.append((ev.name(), start, end, ev.device_index()))
        else:
            host.append((ev.name(), start, end))
    device.sort(key=lambda r: r[1])
    host.sort(key=lambda r: r[1])
    return device, host


def union(spans, lo: int, hi: int) -> list:
    """The merged ``[start, end)`` intervals of ``spans`` clipped to
    ``[lo, hi)``."""
    out = []
    for rec in spans:
        s, e = max(rec[1], lo), min(rec[2], hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_ns(spans, lo: int, hi: int) -> int:
    return sum(e - s for s, e in union(spans, lo, hi))


def busy_per_device_ns(device, lo: int, hi: int) -> float:
    """The device busy union inside the window, averaged over the
    devices that ran anything."""
    by = {}
    for rec in device:
        by.setdefault(rec[3], []).append(rec)
    if not by:
        return 0.0
    return sum(busy_ns(v, lo, hi) for v in by.values()) / len(by)


def gaps(spans, lo: int, hi: int) -> list:
    """The idle ``(start, end)`` intervals of ``[lo, hi)``."""
    out, at = [], lo
    for s, e in union(spans, lo, hi):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def window(host, mark: str) -> tuple | None:
    """The ``[start, end)`` of the host range named ``mark``."""
    for name, s, e in host:
        if name == mark:
            return s, e
    return None


def active_window(device, start: int, end: int,
                  from_first_op: bool) -> tuple | None:
    """``(lo, hi)``: from ``start`` (or, ``from_first_op``, the first
    device operation that starts inside ``[start, end)``) to the end of
    the last device operation that starts inside it; ``None`` where
    none does.  Ending at the device's last operation leaves out what
    follows it on the host, such as the profiler's own buffer flush."""
    inside = [(s, e) for _, s, e, _ in device if start <= s < end]
    if not inside:
        return None
    lo = min(s for s, _ in inside) if from_first_op else start
    return lo, max(e for _, e in inside)


def top_ops(device, lo: int, hi: int, n: int = 10) -> list:
    """``[[name, seconds], ...]``: the device operations that took most
    time inside the window, summed by name."""
    total = collections.Counter()
    for name, s, e, _ in device:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            total[name] += e - s
    return [[name, ns / 1e9] for name, ns in total.most_common(n)]


# host ranges of the profiler's own work (CUPTI's activity buffers):
# the device idles there only because the profiler is on
PROFILER_RANGES = ("Buffer Flush", "Activity Buffer Request")


def gap_labels(device, host, lo: int, hi: int, skip=()) -> list:
    """``[(what the host was doing, idle ns), ...]``, one a gap of the
    window: the innermost host range that covers the gap's middle
    (ranges named in ``skip`` are passed over; ``(none)`` where none
    does)."""
    spans = [(name, s, e) for name, s, e in host if name not in skip]
    out = []
    active, j = [], 0
    for gs, ge in gaps(device, lo, hi):
        mid = (gs + ge) // 2
        while j < len(spans) and spans[j][1] <= mid:
            active.append(spans[j])
            j += 1
        active = [a for a in active if a[2] > mid]
        inner = min(active, key=lambda a: a[2] - a[1], default=None)
        out.append((inner[0] if inner else "(none)", ge - gs))
    return out


def idle_by_host(device, host, lo: int, hi: int, skip=(), n: int = 10):
    """``[[what the host was doing, seconds], ...]``: the window's idle
    time summed by :func:`gap_labels`, largest first."""
    total = collections.Counter()
    for name, ns in gap_labels(device, host, lo, hi, skip):
        total[name] += ns
    return [[name, ns / 1e9] for name, ns in total.most_common(n)]


def profiler_idle_ns(device, host, lo: int, hi: int, skip=()) -> int:
    """The window's idle time while the host did the profiler's own work
    (:data:`PROFILER_RANGES`)."""
    return sum(ns for name, ns in gap_labels(device, host, lo, hi, skip)
               if name in PROFILER_RANGES)


def kernel_time(device, lo: int, hi: int, needle: str) -> tuple:
    """``(launches, seconds)`` of the device kernels whose name holds
    ``needle`` inside the window."""
    count, ns = 0, 0
    for name, s, e, _ in device:
        if needle in name and s >= lo and e <= hi:
            count += 1
            ns += e - s
    return count, ns / 1e9

