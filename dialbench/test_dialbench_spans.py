"""The readers of the program's host spans (``dialbench/spans.py`` and
the seven ``metrics/*.lab.py`` that read it), on a hand-made window and
span log, and on the program's own recorder after a run."""

from __future__ import annotations

import pathlib
import sys

import pytest

from dialbench import harness, spans
from dialbench.program import Call

BASE = pathlib.Path(__file__).resolve().parent
READERS = ("scenario_build_ms_per_interval.lab", "stack_ms_per_interval.lab",
           "schedule_ms_per_interval.lab", "prepare_ms_per_interval.lab",
           "warmup_ms_per_interval.lab", "finish_ms_per_interval.lab",
           "device_idle_unspanned_pct.lab")
MS = 1_000_000
OFFSET = 7 * 10**15            # a profiler-clock offset for the tests


# one lab call's spans: (name, start ms, end ms, index of the parent)
LAYOUT = (("lab.build", 0, 3, None), ("lab.build", 3, 7, None),
          ("lab.stack", 7, 9, None), ("lab.run_batch", 9, 39, None),
          ("lab.schedule", 9, 14, 3), ("loop.prepare", 14, 15, 3),
          ("loop.graph_free", 15, 16, 3), ("loop.warmup", 16, 22, 3),
          ("loop.capture", 22, 25, 3), ("loop.instantiate", 25, 26, 3),
          ("loop.intervals", 26, 28, 3), ("loop.finish", 28, 38, 3),
          ("loop.wait", 28, 36, 11))


def _call(t0_ms: int, log: list, n: int = 10):
    """One call's spans from ``t0_ms`` (ms on the span clock), appended
    to ``log``; returns the call's ``(start s, end s, Call)``."""
    first = len(log) + 1
    for i, (name, lo, hi, up) in enumerate(LAYOUT):
        parent = None if up is None else first + up
        root = first + i if up is None else first + 3
        log.append((name, (t0_ms + lo) * MS, (t0_ms + hi) * MS, first + i,
                    parent, root))
    return (t0_ms / 1e3, (t0_ms + 39) / 1e3, Call(n, 40960.0, 90.0))


@pytest.fixture
def window(monkeypatch):
    """Two warm calls, a window of two calls, and the profiled call
    after it, their spans in the program's ring; the window's ``ctx``."""
    log = []
    _call(0, log)
    _call(100, log)
    calls = [_call(1000, log), _call(2000, log)]
    _call(9000, log)
    monkeypatch.setattr(spans, "_ring", lambda: log)
    return {"calls": calls, "n_osc": 8, "cache": (None, None),
            "profile": None, "launches": None, "ab": None}


def test_the_window_leaves_out_warm_and_profiled_calls(window):
    got = spans.window(window)
    assert len(got) == 2 * len(LAYOUT)
    assert {s[1] // (1000 * MS) for s in got} == {1, 2}


def test_readers_sum_their_spans_an_interval(window):
    want = {"scenario_build_ms_per_interval.lab": 2 * 7.0 / 20,
            "stack_ms_per_interval.lab": 2 * 2.0 / 20,
            "schedule_ms_per_interval.lab": 2 * 5.0 / 20,
            "prepare_ms_per_interval.lab": 2 * 1.0 / 20,
            "warmup_ms_per_interval.lab": 2 * 6.0 / 20,
            # the finish less its wait for the device
            "finish_ms_per_interval.lab": 2 * 2.0 / 20}
    for name, value in want.items():
        assert harness.reader(BASE, name)(window) == pytest.approx(value), \
            name


def test_self_time_leaves_the_children_out(window):
    got = spans.window(window)
    # the run: 30 ms, its children 5+1+1+6+3+1+2+10 = 29 ms
    assert spans.self_ns(got, "lab.run_batch") == 2 * 1 * MS
    # the finish: 10 ms less the 8 ms wait
    assert spans.self_ns(got, "loop.finish") == 2 * 2 * MS
    assert spans.self_ns(got, "lab.build") == 2 * 7 * MS
    assert spans.total_ns(got, "loop.wait") == 2 * 8 * MS


def test_self_time_counts_overlapping_children_once():
    log = [("p", 0, 100, 1, None, 1), ("a", 10, 50, 2, 1, 1),
           ("b", 40, 70, 3, 1, 1), ("c", 45, 60, 4, 3, 1)]
    assert spans.self_ns(log, "p") == 100 - 60
    assert spans.self_ns(log, "b") == 30 - 15


def test_the_offset_puts_a_stamp_on_the_wall_clock():
    import time

    stamp = time.perf_counter_ns() + spans.profiler_offset_ns()
    assert abs(stamp - time.time_ns()) < MS


def _profile(device, host, idle):
    return {"device": device, "host": host, "lo": idle[0], "hi": idle[1],
            "replays": 10, "marks": {}, "idle": idle,
            "profiler_idle_ns": 0, "n_devices": 1}


def test_unspanned_idle_share(window):
    # a window of 1,000 ns: the device busy 100-200 and 600-700, idle 800
    device = [("k", 100, 200, 0), ("k", 600, 700, 0)]
    flush = [("Buffer Flush", 300, 400)]          # 100 ns of the idle
    ctx = {**window, "profile": _profile(device, flush, (0, 1000))}
    # no span at all reads nothing; spans elsewhere only, 100
    assert spans.unspanned_idle_pct(ctx, spans=[]) is None
    far = [("lab.build", 5000, 6000)]
    assert spans.unspanned_idle_pct(ctx, spans=far) == pytest.approx(100.0)
    # spans over 0-100 and 200-300: 200 of the 700 idle ns not the
    # profiler's; the rest (400-600, 700-1000) uncovered
    cover = [("lab.build", 0, 100), ("lab.stack", 200, 300)]
    assert spans.unspanned_idle_pct(ctx, spans=cover) == pytest.approx(
        100.0 * 500 / 700)
    # nested and overlapping spans over the whole window: 0
    whole = [("lab.run_batch", 0, 1000), ("loop.wait", 350, 650),
             ("lab.build", 900, 1000)]
    assert spans.unspanned_idle_pct(ctx, spans=whole) == 0.0
    # a span over the profiler's range alone covers nothing counted
    assert spans.unspanned_idle_pct(
        ctx, spans=[("lab.stack", 300, 400)]) == pytest.approx(100.0)


def test_unspanned_idle_share_converts_the_programs_spans(window,
                                                         monkeypatch):
    log = [("lab.run_batch", 0, 600, 1, None, 1)]
    monkeypatch.setattr(spans, "_ring", lambda: log)
    monkeypatch.setattr(spans, "profiler_offset_ns", lambda: OFFSET)
    device = [("k", OFFSET + 600, OFFSET + 700, 0)]
    ctx = {**window, "profile": _profile(device, [],
                                         (OFFSET + 0, OFFSET + 1000))}
    got = harness.reader(BASE, "device_idle_unspanned_pct.lab")(ctx)
    assert got == pytest.approx(100.0 * 300 / 900)


def test_every_reader_reads_nothing_without_spans(monkeypatch):
    """A program without the recorder (a version older than these
    span readers) or without spans in the window: every reader ``None``,
    and the idle reader ``None`` without a profile."""
    calls = [(1.0, 2.0, Call(10, 40960.0, 90.0))]
    device = [("k", 100, 200, 0)]
    ctx = {"calls": calls, "n_osc": 8, "cache": (None, None),
           "profile": _profile(device, [], (0, 1000)), "launches": None,
           "ab": None}
    from repro_torch.obs import timers

    monkeypatch.delattr(timers, "spans")
    for name in READERS:
        assert harness.reader(BASE, name)(ctx) is None, name
    monkeypatch.undo()
    monkeypatch.delitem(sys.modules, spans.RECORDER)
    assert spans._ring() is None
    monkeypatch.undo()
    monkeypatch.setattr(spans, "_ring", lambda: [])
    for name in READERS:
        assert harness.reader(BASE, name)(ctx) is None, name
    assert spans.unspanned_idle_pct({**ctx, "profile": None}) is None


def test_readers_on_the_programs_own_spans(tiny_cell):
    """The cell at a CPU size, traced: the six span readers read the
    program's spans (no capture on the CPU: the warm-up reads 0), and
    the build and stack account for the benchmark's build timing."""
    cell = tiny_cell("lab-noisy.b4096")
    result, _ = harness.run(cell, 2**33 + 7, 0.2, True, "cpu")
    m = {k: v["value"] for k, v in result["metrics"].items()}
    for name in READERS[:6]:
        assert name in m, name
    assert m["warmup_ms_per_interval.lab"] == 0.0
    for name in ("scenario_build_ms_per_interval.lab",
                 "stack_ms_per_interval.lab", "schedule_ms_per_interval.lab",
                 "prepare_ms_per_interval.lab",
                 "finish_ms_per_interval.lab"):
        assert m[name] > 0, name
    parts = (m["scenario_build_ms_per_interval.lab"]
             + m["stack_ms_per_interval.lab"])
    assert parts <= m["build_ms_per_interval.lab"]
    # no device, no idle window: the idle reader reads nothing
    assert "device_idle_unspanned_pct.lab" not in m
    assert result["correct"]
