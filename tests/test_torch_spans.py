"""The port's host spans (``repro_torch.obs.timers``) and where the lab
path records them.

The recorder: nesting sets ``parent`` and ``root``, the ring stays
bounded, ``spans(lo, hi)`` selects by window, ``PhaseTimers`` records
through it, and a span put on the profiler's clock with
``profiler_offset_ns`` lands where ``torch.profiler`` puts a
``record_function`` range around the same block.  The lab path: ``build`` / ``stack_scenarios`` record
``lab.build`` / ``lab.stack``; a fused ``run_batch`` records the tree
``lab.run_batch`` -> ``lab.schedule``, ``loop.prepare``,
``loop.intervals``, ``loop.finish`` -> ``loop.wait``, once per shard
in the mesh's order on a mesh; on the card a capture that replaces
a graph records ``loop.graph_free``, ``loop.warmup``, ``loop.capture``
and ``loop.instantiate``, and ``last_run``'s seconds are theirs.
Imports no JAX, so it runs on the card too.
"""

import time

import numpy as np
import pytest
import torch

from repro_torch.convert import model_from_numpy
from repro_torch.core.metrics import feature_dim
from repro_torch.lab import batch as B
from repro_torch.lab import scenarios as S
from repro_torch.obs import timers
from repro_torch.obs.timers import (PhaseTimers, profiler_offset_ns,
                                    span, spans)
from repro_torch.pfs.state import READ, WRITE


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA-graph capture has no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These sizes run fastest on one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _since(t0: int) -> dict:
    """``{name: [span, ...]}`` of the spans finished since ``t0``."""
    out = {}
    for s in spans(t0):
        out.setdefault(s[0], []).append(s)
    return out


def _by_id(t0: int) -> dict:
    return {s[3]: s for s in spans(t0)}


# --------------------------------------------------------------------- #
# the recorder
# --------------------------------------------------------------------- #
def test_nesting_sets_parent_and_root():
    t0 = time.perf_counter_ns()
    with span("a") as a:
        with span("b") as b:
            with span("c") as c:
                pass
        with span("d") as d:
            pass
    with span("e") as e:
        pass
    got = _by_id(t0)
    assert got[a.id] == ("a", a.start_ns, a.end_ns, a.id, None, a.id)
    assert got[b.id][4:] == (a.id, a.id)
    assert got[c.id][4:] == (b.id, a.id)
    assert got[d.id][4:] == (a.id, a.id)
    assert got[e.id][4:] == (None, e.id)
    # finished innermost first; stamps nest
    assert [s[0] for s in spans(t0)] == ["c", "b", "d", "a", "e"]
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns \
        <= d.start_ns <= d.end_ns <= a.end_ns <= e.start_ns
    assert got[a.id][1:3] == (a.start_ns, a.end_ns)
    assert a.seconds == (a.end_ns - a.start_ns) / 1e9


def test_span_that_raises_is_recorded_and_unwound():
    t0 = time.perf_counter_ns()
    with pytest.raises(ValueError):
        with span("outer"):
            with span("inner"):
                raise ValueError("boom")
    with span("after") as after:
        pass
    got = _since(t0)
    assert set(got) == {"outer", "inner", "after"}
    assert got["after"][0][4] is None and got["after"][0][5] == after.id


def test_ring_is_bounded():
    ring = timers._RING
    assert ring.maxlen == timers.RING_SPANS == 1 << 17
    t0 = time.perf_counter_ns()
    with span("first") as first:
        pass
    for _ in range(timers.RING_SPANS):
        with span("filler"):
            pass
    assert len(ring) == timers.RING_SPANS
    names = {s[0] for s in spans(t0)}
    assert names == {"filler"} and first.id not in _by_id(t0)


def test_spans_selects_by_window():
    with span("before"):
        pass
    lo = time.perf_counter_ns()
    with span("inside") as inside:
        pass
    hi = time.perf_counter_ns()
    with span("after"):
        pass
    assert [s[0] for s in spans(lo, hi)] == ["inside"]
    assert [s[0] for s in spans(lo)][:2] == ["inside", "after"]
    assert "before" in [s[0] for s in spans(hi_ns=hi)]
    assert "after" not in [s[0] for s in spans(hi_ns=hi)]
    # a span that straddles an end of the window is not inside it
    assert spans(inside.start_ns + 1, hi) == []
    assert spans(lo, inside.end_ns - 1) == []


def test_phase_timers_record_through_the_spans():
    t = PhaseTimers()
    t0 = time.perf_counter_ns()
    with t.phase("dispatch"):
        time.sleep(0.002)
    with pytest.raises(KeyError):
        with t.phase("dispatch", device="cpu"):
            raise KeyError
    s = t.summary()
    assert list(s) == ["dispatch"] and s["dispatch"]["calls"] == 2
    got = _since(t0)["dispatch"]
    assert len(got) == 2
    assert s["dispatch"]["seconds"] == pytest.approx(
        sum(e - b for _, b, e, *_ in got) / 1e9, abs=1e-12)
    assert s["dispatch"]["seconds"] >= 0.002


def _kineto_range(prof, name: str) -> tuple:
    """``(start_ns, end_ns)`` of the profiler's range named ``name``."""
    for ev in prof.profiler.kineto_results.events():
        if ev.name() == name:
            if hasattr(ev, "start_ns"):
                start, dur = ev.start_ns(), ev.duration_ns()
            else:
                start, dur = ev.start_us() * 1000, ev.duration_us() * 1000
            return int(start), int(start + dur)
    raise AssertionError(f"no range {name!r} in the trace")


def test_converted_span_lands_on_the_profiler_range():
    """A ``record_function`` range and a program span around the same
    block agree within 1 ms at both ends once the span is converted."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with record_function(f"block{i}"):
                with span(f"block{i}") as s:
                    x = torch.ones(256, 256)
                    for _ in range(20):
                        x = x @ x / 256.0
                    time.sleep(0.003)
            if i == 2:
                last = s
    start, end = _kineto_range(prof, "block2")
    offset = profiler_offset_ns()
    assert abs(last.start_ns + offset - start) < 1_000_000
    assert abs(last.end_ns + offset - end) < 1_000_000
    assert end - start >= 3_000_000


def test_profiler_offset_follows_the_wall_clock():
    a = time.perf_counter_ns() + profiler_offset_ns()
    assert abs(a - time.time_ns()) < 1_000_000
    # the offset is read anew each call: within microseconds of itself
    assert abs(profiler_offset_ns() - profiler_offset_ns()) < 10_000


# --------------------------------------------------------------------- #
# the lab path's spans
# --------------------------------------------------------------------- #
def _random_forest(rng, n_features, n_trees, depth):
    n_internal = 2 ** depth - 1
    threshold = (rng.choice([-1.0, 1.0], (n_trees, n_internal))
                 * 10.0 ** rng.uniform(-1, 3, (n_trees, n_internal)))
    return dict(
        feature=rng.integers(0, n_features, (n_trees, n_internal)),
        threshold=threshold.astype(np.float32),
        leaf=rng.normal(0.1, 0.5, (n_trees, 2 ** depth)).astype(np.float32),
        base_score=0.2, depth=depth, n_features=n_features)


def _model(device):
    rng = np.random.default_rng(5)
    return model_from_numpy(*(_random_forest(rng, feature_dim(op), 8, 3)
                              for op in (READ, WRITE)), device=device)


def _batch(n: int, device):
    specs = S.variants(S.get_scenario("noisy_neighbor"), n, seed=1)
    return B.stack_scenarios([S.build(s) for s in specs], ragged=False,
                             device=device)


def test_build_and_stack_record_their_spans():
    t0 = time.perf_counter_ns()
    batch = _batch(3, "cpu")
    got = _since(t0)
    assert sorted(got) == ["lab.build", "lab.stack"]
    assert len(got["lab.build"]) == 3 and len(got["lab.stack"]) == 1
    assert all(s[4] is None for v in got.values() for s in v)
    assert len(batch) == 3


def _children(t0: int, root_name: str) -> tuple:
    """The last span named ``root_name`` since ``t0`` and its children's
    names, in finishing order, by the child's own id."""
    by_id = _by_id(t0)
    root = [s for s in by_id.values() if s[0] == root_name][-1]
    kids = {}
    for s in by_id.values():
        if s[5] == root[3] and s[3] != root[3]:
            kids.setdefault(by_id[s[4]][0], []).append(s[0])
    return root, kids


def test_fused_run_batch_records_the_tree():
    model = _model("cpu")
    batch = _batch(2, "cpu")
    t0 = time.perf_counter_ns()
    B.run_batch(batch, model, seconds=1.0, interval=0.5, fused=True)
    root, kids = _children(t0, "lab.run_batch")
    assert root[4] is None
    assert kids == {"lab.run_batch": ["lab.schedule", "loop.prepare",
                                      "loop.intervals", "loop.finish"],
                    "loop.finish": ["loop.wait"]}
    for s in spans(t0):
        assert len(s) == 6
        assert root[1] <= s[1] <= s[2] <= root[2]


def test_host_run_batch_records_its_schedule():
    model = _model("cpu")
    batch = _batch(2, "cpu")
    t0 = time.perf_counter_ns()
    B.run_batch(batch, model, seconds=1.0, interval=0.5)
    _, kids = _children(t0, "lab.run_batch")
    assert kids == {"lab.run_batch": ["lab.schedule"]}


def test_sharded_run_batch_records_the_loop_spans_per_shard():
    from repro_torch.distributed.sharding import fleet_mesh

    model = _model("cpu")
    batch = _batch(3, "cpu")
    t0 = time.perf_counter_ns()
    B.run_batch(batch, model, seconds=1.0, interval=0.5, fused=True,
                mesh=fleet_mesh(devices=["cpu"] * 2))
    _, kids = _children(t0, "lab.run_batch")
    assert kids["lab.run_batch"] == (["lab.schedule"]
                                     + ["loop.prepare", "loop.intervals"] * 2
                                     + ["loop.finish"] * 2)
    assert kids["loop.finish"] == ["loop.wait"] * 2


def test_capture_spans_on_the_card(cuda):
    """A capture that replaces a graph (a batch of new content on the
    same loop): ``loop.graph_free``, then ``loop.warmup``,
    ``loop.capture`` and ``loop.instantiate``, each under the call's
    root; ``last_run``'s seconds are the spans'."""
    model = _model(cuda)
    B.run_batch(_batch(3, cuda), model, seconds=1.0, fused=True)
    specs = S.variants(S.get_scenario("noisy_neighbor"), 3, seed=2)
    fresh = B.stack_scenarios([S.build(s) for s in specs], ragged=False,
                              device=cuda)
    t0 = time.perf_counter_ns()
    B.run_batch(fresh, model, seconds=1.0, fused=True)
    loop = next(v[0] for v in B._FUSED_LOOPS.values() if v[1] is model)
    run = loop.last_run
    assert run["captured_now"] and run["replays"] == 2
    split = run["instantiate_s"] is not None
    _, kids = _children(t0, "lab.run_batch")
    assert kids["lab.run_batch"] == (
        ["lab.schedule", "loop.prepare", "loop.graph_free", "loop.warmup",
         "loop.capture"] + ["loop.instantiate"] * split
        + ["loop.intervals", "loop.finish"])
    assert kids["loop.finish"] == ["loop.wait"]
    got = _since(t0)
    dur = {k: (v[-1][2] - v[-1][1]) / 1e9 for k, v in got.items()}
    assert run["capture_s"] == dur["loop.capture"]
    assert run["instantiate_s"] == (dur["loop.instantiate"] if split
                                    else None)
    assert run["setup_s"] == pytest.approx(
        dur["loop.warmup"] + dur["loop.capture"]
        + dur.get("loop.instantiate", 0.0), abs=1e-12)
