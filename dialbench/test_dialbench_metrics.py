"""The per-layer metrics' arithmetic, the trace reading and the
comparison's numbers, on made-up inputs."""

from __future__ import annotations

import pytest
import torch

from dialbench import compare, readings, roofline, trace
from dialbench.program import Call


def _ctx(**kw):
    ctx = {"calls": [], "n_osc": 8192, "cache": (None, None),
           "profile": None, "launches": None, "ab": None}
    ctx.update(kw)
    return ctx


def test_host_and_device_ms_per_interval():
    calls = [(0.0, 2.0, Call(20, 163840.0, 80.0)),
             (2.0, 3.7, Call(20, 163840.0, 70.0))]
    ctx = _ctx(calls=calls)
    assert readings.device_ms_per_interval(ctx) == pytest.approx(75.0)
    # (2000 - 1600) + (1700 - 1400) = 700 ms over 40 intervals
    assert readings.host_ms_per_interval(ctx) == pytest.approx(17.5)
    assert readings.build_ms_per_interval(ctx) is None


def test_a_timed_run_and_build_split_the_call():
    # a lab call: 3.0 s of wall, 1.5 s of it the program's build, 1.2 s
    # its run_batch, of which 10 x 80 ms on the device
    calls = [(0.0, 3.0, Call(10, 20480.0, 80.0, build_s=1.5, run_s=1.2)),
             (3.0, 6.2, Call(10, 20480.0, 90.0, build_s=1.7, run_s=1.3))]
    ctx = _ctx(calls=calls)
    assert readings.build_ms_per_interval(ctx) == pytest.approx(160.0)
    # (1200 - 800) + (1300 - 900) = 800 ms over 20 intervals
    assert readings.host_ms_per_interval(ctx) == pytest.approx(40.0)


def test_no_device_span_reads_nothing():
    ctx = _ctx(calls=[(0.0, 1.0, Call(6, 48.0, None))])
    assert readings.device_ms_per_interval(ctx) is None
    assert readings.host_ms_per_interval(ctx) is None
    assert readings.device_idle_pct(ctx) is None
    assert readings.roofline_pct(ctx, "segment_sum", "segment_sum") is None
    assert readings.tune_us_per_ifc(ctx) is None


def test_captures_over_the_window():
    calls = [(0.0, 1.0, Call(10, 1.0, 80.0))] * 4
    ctx = _ctx(calls=calls, cache=({"captures": 3, "capture_s": 2.0},
                                   {"captures": 7, "capture_s": 7.2}))
    assert readings.captures_per_call(ctx) == 1.0
    assert readings.capture_ms_per_interval(ctx) == pytest.approx(130.0)
    ctx["cache"] = ({"captures": 3, "capture_s": 2.0},) * 2
    assert readings.captures_per_call(ctx) == 0.0
    assert readings.captures_per_call(_ctx(calls=calls)) is None
    assert readings.capture_ms_per_interval(_ctx(calls=calls)) is None


def test_tune_us_per_ifc():
    ctx = _ctx(ab={"tuned": [80.0, 81.0, 79.0], "static": [72.0, 71.0,
                                                          73.0]})
    assert readings.tune_us_per_ifc(ctx) == pytest.approx(8.0 * 1e3 / 8192)


def test_tune_us_per_ifc_pairs_the_runs():
    """A mode switch of the device between pairs moves both runs of a
    pair: the median of the pairs' differences stands, where the
    difference of the two medians would not."""
    ctx = _ctx(ab={"tuned": [67.0, 83.0, 83.0, 67.0, 83.0],
                   "static": [66.0, 82.0, 82.0, 66.0, 66.0]})
    assert readings.tune_us_per_ifc(ctx) == pytest.approx(1.0 * 1e3 / 8192)


def _profile(device, lo=0, hi=1000, replays=2, marks=None, idle=None,
             flush=0):
    return {"device": device, "host": [], "lo": lo, "hi": hi,
            "replays": replays, "marks": marks or {}, "n_devices": 1,
            "idle": (lo, hi) if idle is None else idle,
            "profiler_idle_ns": flush}


def test_union_gaps_and_idle_share():
    dev = [("k", 100, 200, 0), ("k", 150, 300, 0), ("m", 500, 600, 0)]
    assert trace.union(dev, 0, 1000) == [[100, 300], [500, 600]]
    assert trace.gaps(dev, 0, 1000) == [(0, 100), (300, 500), (600, 1000)]
    assert trace.busy_ns(dev, 0, 1000) == 300
    ctx = _ctx(profile=_profile(dev))
    assert readings.device_idle_pct(ctx) == pytest.approx(70.0)
    ctx = _ctx(profile=_profile(dev, idle=(100, 600)))
    assert readings.device_idle_pct(ctx) == pytest.approx(40.0)
    ctx["profile"]["idle"] = None
    assert readings.device_idle_pct(ctx) is None


def test_the_profilers_own_stalls_leave_the_idle_window():
    # the device idles [300, 500) while the host flushes the profiler's
    # buffers, and [600, 1000) in the program's own host work
    dev = [("k", 100, 300, 0), ("k", 500, 600, 0)]
    host = [("dialbench.profiled", 0, 1000), ("Buffer Flush", 320, 480),
            ("aten::zeros", 700, 900)]
    assert trace.profiler_idle_ns(dev, host, 100, 1000,
                                  skip=("dialbench.profiled",)) == 200
    ctx = _ctx(profile=_profile(dev, idle=(100, 1000), flush=200))
    # busy 300 of 900 - 200
    assert readings.device_idle_pct(ctx) == pytest.approx(100 * 4 / 7)


def test_active_window_leaves_out_the_host_before_and_after():
    # the replays' mark is (50, 900); the device runs from 120 to 700;
    # what follows on the host (a flush) is outside, and an operation
    # that starts before the mark belongs to another part
    dev = [("prep", 10, 60, 0), ("k", 120, 300, 0), ("k", 310, 700, 0)]
    assert trace.active_window(dev, 50, 900, True) == (120, 700)
    assert trace.active_window(dev, 50, 900, False) == (50, 700)
    assert trace.active_window(dev, 800, 900, True) is None


def test_busy_is_averaged_over_devices():
    dev = [("k", 0, 500, 0), ("k", 0, 250, 1)]
    assert trace.busy_per_device_ns(dev, 0, 1000) == pytest.approx(375.0)


def test_idle_is_attributed_to_the_innermost_host_range():
    dev = [("k", 100, 200, 0), ("k", 400, 500, 0)]
    host = [("dialbench.profiled", 0, 1000), ("dialbench.finish", 500, 1000),
            ("aten::copy_", 600, 700)]
    out = dict(trace.idle_by_host(dev, host, 0, 1000,
                                  skip=("dialbench.profiled",)))
    # gaps: [0, 100) and [200, 400) have no inner range, [500, 1000)'s
    # middle (750) lies in finish alone
    assert out == {"(none)": 300 / 1e9, "dialbench.finish": 500 / 1e9}


def test_top_ops_by_name():
    dev = [("a", 0, 10, 0), ("b", 10, 40, 0), ("a", 40, 60, 0)]
    assert trace.top_ops(dev, 0, 100) == [["a", 30e-9], ["b", 30e-9]]


def test_kernels_per_interval_counts_inside_the_replays():
    # the replays are waited for inside their mark (8, 75); transfers to
    # and from the host are not counted, nor what the finish runs after
    dev = [("Memcpy HtoD (Pageable -> Device)", 0, 5, 0), ("k", 10, 20, 0),
           ("k", 30, 40, 0), ("Memcpy DtoD (Device -> Device)", 45, 50, 0),
           ("k", 60, 70, 0), ("Memcpy DtoH (Device -> Pageable)", 72, 74, 0),
           ("k", 80, 90, 0)]
    ctx = _ctx(profile=_profile(dev, lo=0, hi=100, replays=2,
                                marks={"replays": (8, 75)}))
    assert readings.kernels_per_interval(ctx) == 2.0


def test_roofline_pct_against_kernel_time():
    shape = {"cols": 1, "entries": 8192, "segments": 32}
    t_bound = roofline.bound(roofline.segment_sum(**shape))[0]
    # two replays, each one launch of 3,500 ns
    dev = [("segment_sum_kernel", 0, 3500, 0),
           ("segment_sum_kernel", 5000, 8500, 0)]
    ctx = _ctx(profile=_profile(dev, hi=10000),
               launches=[("segment_sum", shape)])
    assert readings.roofline_pct(ctx, "segment_sum", "segment_sum") == \
        pytest.approx(100 * t_bound / 3500e-9)
    # a call that also ran a capture's eager interval: three intervals'
    # launches, each against its bound
    ctx["profile"]["device"].append(("segment_sum_kernel", 9000, 9700, 0))
    assert readings.roofline_pct(ctx, "segment_sum", "segment_sum") == \
        pytest.approx(100 * 3 * t_bound / 7700e-9)
    # a launch count that is no whole number of intervals reads nothing
    ctx["launches"] = [("segment_sum", shape)] * 2
    assert readings.roofline_pct(ctx, "segment_sum", "segment_sum") is None


def test_straggler_pct():
    calls = [(0, 1, Call(10, 1.0, 80.0, (80.0, 88.0))),
             (1, 2, Call(10, 1.0, 80.0, (80.0, 88.0)))]
    assert readings.straggler_pct(_ctx(calls=calls)) == pytest.approx(
        100 * 8 / 84)


def test_gap_is_relative_to_the_reference_field():
    a = torch.tensor([1.0, 2.0, 4.0], dtype=torch.float64)
    b = torch.tensor([1.0, 2.0, 4.5], dtype=torch.float64)
    assert compare._gap(a, b) == pytest.approx(0.5 / 4.5)
    assert compare._gap(a, a) == 0.0
    assert compare._gap(a, a[:2]) == float("inf")
    assert compare._gap(torch.tensor([float("nan")]),
                        torch.tensor([1.0])) == float("inf")


def test_worst_counts_nan_as_failing():
    w = compare.worst([{"x": 0.0}, {"x": float("nan")}])
    assert w["x"] == float("inf")
    assert not compare.verdict(w, {"x": 1.0})
    assert compare.verdict({"x": 0.5}, {"x": 1.0})
    assert not compare.verdict({"x": 0.5}, {"x": 1.0, "y": 1.0})


def test_decision_mismatch_counts_rows():
    n = 4
    prog = {"decided": torch.tensor([[True, True, False, False]]),
            "theta": torch.tensor([[[256, 8], [64, 2], [256, 8], [1, 1]]]),
            "changed": torch.tensor([[True, True, False, False]]),
            "n_candidates": torch.tensor([[3, 2, 0, 0]]),
            "score": torch.zeros(1, n, dtype=torch.float64),
            "probs": torch.zeros(1, n, 24, dtype=torch.float64)}
    ref = [{"decided": torch.tensor([True, True, False, False]),
            "rows": torch.tensor([0, 1]),
            "theta": torch.tensor([[256, 8], [64, 4]]),
            "changed": torch.tensor([True, True]),
            "n_candidates": torch.tensor([3, 2]),
            "score": torch.zeros(2, dtype=torch.float64),
            "probs": torch.zeros(2, 24, dtype=torch.float64)}]
    knobs = {"window_pages": torch.zeros(n), "rpcs_in_flight": torch.zeros(n)}
    gap, bad = compare.decisions(prog, ref, knobs, knobs)
    assert gap == 0.0 and bad == pytest.approx(1 / 2)
