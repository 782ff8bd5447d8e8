"""The port's observability (``repro_torch.obs``) on the CPU.

Held against the reference (``repro/obs``), which imports in this
process: the reference's numpy ``run_fleet(backend="numpy",
trace=TraceConfig(stride=5))`` with its ``HostTracer`` on a 4 x 2 mixed
sim is the oracle for both of the port's traces, the fused loop's and
the host loop's: the flags and θ equal, ``t``, scores, probabilities
and the gate metrics within rtol 1e-5 / atol 1e-8, every timeline
field within rtol 1e-5 / atol 1e-6 (the bars of the reference's own
``tests/test_obs.py::test_host_trace_mirrors_fused_trace``).  The port's
two traces are equal to each other bit for bit, tracing leaves θ and
the final state bit for bit unchanged, and the sinks read each other's
files and render the same arrays identically.  Also: the sample ticks,
the timeline tap's one ``(K, E)`` launch, ``run_batch(trace=...)`` on
both paths (the placeholder record of never-tuned elements), the loop
cache's keys, timers and provenance.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core.fleet import run_fleet as ref_run_fleet  # noqa: E402
from repro.core.gbdt import DenseForest  # noqa: E402
from repro.core.model import DIALModel as RefModel  # noqa: E402
from repro.obs import schema as RS  # noqa: E402
from repro.obs import sinks as RK  # noqa: E402
from repro.obs.host import HostTracer as RefHostTracer  # noqa: E402
from repro_torch.convert import model_from_numpy  # noqa: E402
from repro_torch.core.fleet import run_fleet  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.segment_reduce.ops import segment_sum  # noqa: E402
from repro_torch.lab import batch as B  # noqa: E402
from repro_torch.lab import scenarios as S  # noqa: E402
from repro_torch.obs import schema as TS  # noqa: E402
from repro_torch.obs import sinks as TK  # noqa: E402
from repro_torch.obs.host import HostTracer  # noqa: E402
from repro_torch.obs.timers import (PhaseTimers, collect_provenance,  # noqa: E402
                                    compile_execute_split)
from repro_torch.pfs.engine_torch import FusedEngine  # noqa: E402
from repro_torch.pfs.loop_torch import FusedLoop  # noqa: E402
from repro_torch.pfs.workloads import table_from_sim  # noqa: E402
from test_torch_loop import forests, port_sim, ref_sim  # noqa: E402

EXACT = ("decided", "ops", "theta", "changed", "n_candidates", "active",
         "steady", "warm")
CLOSE = ("t", "score", "probs", "vol_r", "vol_w", "ratio")
CFG = TS.TraceConfig(stride=5)
SECONDS = 4.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These sizes run fastest on one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def forest_pair():
    return forests()


@pytest.fixture(scope="module")
def model(forest_pair):
    return model_from_numpy(*forest_pair, device="cpu")


@pytest.fixture(scope="module")
def ref_trace(forest_pair):
    """The reference's numpy host loop with its HostTracer."""
    model = RefModel(*(DenseForest(**f) for f in forest_pair))
    fleet = ref_run_fleet(ref_sim("mixed"), model, seconds=SECONDS,
                          interval=0.5, backend="numpy",
                          trace=RS.TraceConfig(stride=5))
    return fleet.trace


@pytest.fixture(scope="module")
def runs(model):
    """The port's fused and host loops on the mixed sim, traced and not:
    ``{(backend, traced): (sim, fleet)}``."""
    out = {}
    for backend in ("torch-fused", "torch"):
        for traced in (True, False):
            sim = port_sim("mixed")
            fleet = run_fleet(sim, model, seconds=SECONDS, interval=0.5,
                              device="cpu", backend=backend,
                              trace=CFG if traced else None)
            out[backend, traced] = (sim, fleet)
    return out


def _ref_run_trace(trace):
    """A port RunTrace as the reference's (the same numpy arrays)."""
    return RS.RunTrace(
        decisions=trace.decisions, timeline=trace.timeline,
        oscs=trace.oscs,
        config=RS.TraceConfig(stride=trace.config.stride,
                              timeline=trace.config.timeline),
        interval_seconds=trace.interval_seconds,
        tick_seconds=trace.tick_seconds)


# --------------------------------------------------------------------- #
# the copied schema
# --------------------------------------------------------------------- #
def test_schema_constants_equal_reference():
    assert TS.TRACE_SCHEMA == RS.TRACE_SCHEMA
    assert TS.TRACE_SCHEMAS == RS.TRACE_SCHEMAS
    assert TS.DECISION_FIELDS == RS.DECISION_FIELDS
    assert TS.TIMELINE_FIELDS == RS.TIMELINE_FIELDS
    with pytest.raises(ValueError, match="stride"):
        TS.TraceConfig(stride=0)
    assert TS.TraceConfig() == TS.TraceConfig(stride=20, timeline=True)
    assert hash(TS.TraceConfig(stride=5)) == hash(CFG)


@pytest.mark.parametrize("stride,steps", [(5, 100), (20, 100), (30, 100),
                                          (7, 50), (100, 100), (120, 100),
                                          (1, 3)])
def test_sample_ticks_equal_reference(stride, steps):
    """The sample ticks: ``stride-1, 2*stride-1, ...``, a remainder
    shorter than the stride unsampled; the fused loop takes as many."""
    mine = TS.TraceConfig(stride=stride)
    ref = RefHostTracer(RS.TraceConfig(stride=stride))
    want = [i for i in range(steps) if ref.wants_sample(i, steps)]
    assert [i for i in range(steps) if mine.wants_sample(i, steps)] == want
    assert mine.samples(steps) == len(want)
    assert HostTracer(mine).wants_sample(steps - 1, steps) == \
        ref.wants_sample(steps - 1, steps)
    assert TS.TraceConfig(stride=stride, timeline=False).samples(steps) == 0


def test_normalize_decisions_equals_reference():
    rng = np.random.default_rng(3)
    n_int, n, m = 4, 6, 24
    args = dict(
        t=np.arange(1, n_int + 1) * 0.5,
        decided=rng.random((n_int, n)) < 0.5,
        ops=rng.integers(0, 2, (n_int, n)),
        theta=rng.integers(1, 1024, (n_int, n, 2)),
        changed=rng.random((n_int, n)) < 0.5,
        n_candidates=rng.integers(0, 24, (n_int, n)),
        score=rng.random((n_int, n)), probs=rng.random((n_int, n, m)),
        vol_r=rng.random((n_int, n)) * 1e6,
        vol_w=rng.random((n_int, n)) * 1e6,
        active=rng.random((n_int, n)) < 0.5,
        steady=rng.random((n_int, n)) < 0.5,
        warm=np.array([False, False, True, True]),
        ratio=rng.random((n_int, n)) * 3,
        cur_theta=rng.integers(1, 1024, (n_int, n, 2)))
    got, want = TS.normalize_decisions(**args), RS.normalize_decisions(**args)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


def test_timeline_tap_is_one_launch_bit_equal_to_bincount():
    """The tap's five per-OST sums, one ``(5, E)`` call, equal
    ``np.bincount`` of each row and five separate calls, bit for bit,
    and the disturbance columns are the tick's row."""
    sim = port_sim("mixed")
    table, wstate = table_from_sim(sim)
    state = FusedEngine(sim.params, sim.topo, table, 37).run_interval(
        sim.state, wstate)[0]
    tap = TS.timeline_tap(sim.params, sim.topo, state)
    ids = sim.topo.osc_ost.numpy()
    s = state
    rows = {"read_bytes": s.ctr_bytes_done[0], "write_bytes":
            s.ctr_bytes_done[1],
            "queue_bytes": (s.queue_bytes[0] + s.queue_bytes[1]
                            + s.unready_bytes[0] + s.unready_bytes[1]
                            + s.ready_bytes[0] + s.ready_bytes[1]),
            "active_rpcs": s.active_rpcs[0] + s.active_rpcs[1],
            "dirty_room": torch.minimum(
                sim.params.max_dirty_bytes - s.dirty_bytes,
                sim.params.grant_bytes - s.grant_used)}
    for k, v in rows.items():
        want = np.bincount(ids, weights=v.numpy(), minlength=2)
        assert np.array_equal(tap[k].numpy(), want), k
        assert torch.equal(tap[k], segment_sum(v, sim.topo.ost_map)), k
    assert float(tap["t"]) == state.now
    for k in ("bw_scale", "iops_scale", "nic_scale"):
        assert torch.equal(tap[k], torch.ones_like(tap[k])), k
    assert torch.equal(tap["bg_bytes"], torch.zeros(2, dtype=torch.float64))
    # the tap against the reference's on the same (numpy) state
    ref_state = type("S", (), {f.name: (getattr(s, f.name).numpy()
                                        if torch.is_tensor(getattr(s, f.name))
                                        else getattr(s, f.name))
                               for f in dataclasses.fields(s)})
    ref_topo = type("T", (), dict(osc_ost=ids, n_osts=2, n_clients=4))
    want = RS.timeline_tap(sim.params, ref_topo, ref_state)
    for k in TS.TIMELINE_FIELDS:
        assert np.array_equal(np.asarray(tap[k]), np.asarray(want[k])), k


# --------------------------------------------------------------------- #
# the traces against the reference's host tracer
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", ["torch-fused", "torch"])
def test_trace_matches_reference_host_tracer(runs, ref_trace, backend):
    got = runs[backend, True][1].trace
    got.validate()
    ref_trace.validate()
    assert isinstance(got, TS.RunTrace)
    assert (got.n_intervals, got.n_interfaces) == \
        (ref_trace.n_intervals, ref_trace.n_interfaces) == (8, 8)
    assert set(got.decisions) == set(TS.DECISION_FIELDS)
    for f in EXACT:
        np.testing.assert_array_equal(got.decisions[f],
                                      ref_trace.decisions[f], err_msg=f)
    for f in CLOSE:
        np.testing.assert_allclose(got.decisions[f], ref_trace.decisions[f],
                                   rtol=1e-5, atol=1e-8, err_msg=f)
    assert got.timeline is not None and set(got.timeline) == \
        set(TS.TIMELINE_FIELDS)
    for f in TS.TIMELINE_FIELDS:
        assert got.timeline[f].shape == ref_trace.timeline[f].shape, f
        np.testing.assert_allclose(got.timeline[f], ref_trace.timeline[f],
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(got.oscs, ref_trace.oscs)
    assert got.interval_seconds == ref_trace.interval_seconds
    assert got.tick_seconds == ref_trace.tick_seconds
    assert ref_trace.decisions["decided"].any()
    assert ref_trace.decisions["changed"].any()
    assert (~ref_trace.decisions["warm"]).any()


def test_host_trace_equals_fused_trace(runs):
    """The port's two traces are one record, bit for bit."""
    fused = runs["torch-fused", True][1].trace
    host = runs["torch", True][1].trace
    for f in TS.DECISION_FIELDS:
        np.testing.assert_array_equal(host.decisions[f], fused.decisions[f],
                                      err_msg=f)
        assert host.decisions[f].dtype == fused.decisions[f].dtype, f
    for f in TS.TIMELINE_FIELDS:
        np.testing.assert_array_equal(host.timeline[f], fused.timeline[f],
                                      err_msg=f)


@pytest.mark.parametrize("backend", ["torch-fused", "torch"])
def test_tracing_is_neutral(runs, backend):
    """θ, every decision record and every state field bit-equal to the
    untraced run's."""
    sim_t, fleet_t = runs[backend, True]
    sim_u, fleet_u = runs[backend, False]
    assert fleet_u.trace is None
    assert len(fleet_t.decisions) == len(fleet_u.decisions) == 8
    for a, b in zip(fleet_t.decisions, fleet_u.decisions):
        assert torch.equal(a.oscs, b.oscs) and torch.equal(a.ops, b.ops)
        for f in dataclasses.fields(a.decisions):
            assert torch.equal(getattr(a.decisions, f.name),
                               getattr(b.decisions, f.name)), f.name
    for f in dataclasses.fields(sim_t.state):
        a, b = getattr(sim_t.state, f.name), getattr(sim_u.state, f.name)
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), f.name


def test_fused_trace_raw_records(runs):
    """The loop's raw records: ``(n_intervals, ...)`` tensors, the
    timeline ``(n_intervals, samples, tracks)``, ``run_trace`` their
    normalized form; an untraced loop refuses ``run_trace``."""
    loop = runs["torch-fused", True][1].loop
    assert loop.trace_config == CFG and loop.n_samples == 20
    untraced = runs["torch-fused", False][1].loop
    assert untraced.n_samples == 0
    with pytest.raises(ValueError, match="without trace"):
        untraced.run_trace(None)
    sim = port_sim("mixed")
    table, wstate = table_from_sim(sim)
    res = loop.run(table, sim.state, wstate, 3)
    raw = res.trace
    assert raw["t"].shape == (3,) and raw["warm"].dtype == torch.bool
    assert raw["cur_theta"].shape == (3, 8, 2)
    assert raw["timeline"]["read_bytes"].shape == (3, 20, 2)
    assert raw["timeline"]["nic_scale"].shape == (3, 20, 4)
    tr = loop.run_trace(res)
    tr.validate()
    assert tr.timeline["t"].shape == (60,)
    np.testing.assert_allclose(tr.timeline["t"][:3],
                               [5 * 0.005, 10 * 0.005, 15 * 0.005])
    with pytest.raises(ValueError, match="no trace"):
        TS.RunTrace.from_fused(runs["torch-fused", False][1].loop.run(
            table, sim.state, wstate, 1), CFG, 0.005)


def test_untuned_traced_loop_is_timeline_only(model):
    """``tuned=False`` with a trace: the clock and the timeline, equal to
    the host tracer's samples of the same ticks."""
    sim = port_sim("readheavy")
    table, wstate = table_from_sim(sim)
    cfg = TS.TraceConfig(stride=30)
    loop = FusedLoop(sim.params, sim.topo, 100, None, tuned=False,
                     trace=cfg)
    res = loop.run(table, sim.state, wstate, 2)
    assert res.decisions == [] and set(res.trace) == {"t", "timeline"}
    tr = loop.run_trace(res)
    tr.validate()
    assert tr.n_interfaces == 0 and tr.timeline["t"].shape == (6,)
    tracer = HostTracer(cfg, sim.params, sim.topo)
    eng = FusedEngine(sim.params, sim.topo, table, 100)
    st, ws = sim.state, wstate
    for _ in range(2):
        st, ws = eng.run_interval(st, ws, tracer=tracer)
    assert len(tracer._tl) == 6
    for f in TS.TIMELINE_FIELDS:
        want = np.stack([np.asarray(s[f]) for s in tracer._tl])
        np.testing.assert_array_equal(tr.timeline[f], want, err_msg=f)
    with pytest.raises(ValueError, match="no intervals"):
        tracer.run_trace(np.arange(6), 0.5, 0.005)


def test_stride_longer_than_interval_has_no_timeline(model):
    sim = port_sim("mixed")
    fleet = run_fleet(sim, model, seconds=1.0, interval=0.5, device="cpu",
                      backend="torch-fused",
                      trace=TS.TraceConfig(stride=150))
    assert fleet.trace.timeline is None and fleet.loop.n_samples == 0
    host = run_fleet(port_sim("mixed"), model, seconds=1.0, interval=0.5,
                     device="cpu", trace=TS.TraceConfig(stride=150))
    assert host.trace.timeline is None
    for f in TS.DECISION_FIELDS:
        np.testing.assert_array_equal(host.trace.decisions[f],
                                      fleet.trace.decisions[f], err_msg=f)


# --------------------------------------------------------------------- #
# run_batch(trace=...)
# --------------------------------------------------------------------- #
def _batch():
    spec = S.get_scenario("degraded_ost")
    return B.stack_scenarios([S.build(s) for s in S.variants(spec, 3,
                                                             seed=4)],
                             device="cpu")


def test_run_batch_trace_fused_and_host(model):
    """Elements 0 and 2 tuned, element 1 never: tracing is neutral, the
    fused trace's timeline covers every element (OST track
    ``b * n_osts + ost``), never-tuned columns carry the placeholder
    record, and the host path's decisions equal the fused path's."""
    cfg = TS.TraceConfig(stride=10)
    ba, bb, bh = _batch(), _batch(), _batch()
    n = ba.n_osc
    cols = np.concatenate([np.arange(n), 2 * n + np.arange(n)])
    ra = B.run_batch(ba, model, seconds=3.0, interval=0.5, fused=True,
                     tune_cols=cols)
    rb = B.run_batch(bb, model, seconds=3.0, interval=0.5, fused=True,
                     tune_cols=cols, trace=cfg)
    for f in dataclasses.fields(ba.state):
        a, b = getattr(ba.state, f.name), getattr(bb.state, f.name)
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), f.name
    for x, y in zip(ra.decisions, rb.decisions):
        assert torch.equal(x.oscs, y.oscs)
        assert torch.equal(x.decisions.theta, y.decisions.theta)
    trace = TS.RunTrace.from_fused(rb, cfg, bb.params.tick)
    trace.validate()
    d = trace.decisions
    assert trace.n_interfaces == 3 * n
    assert d["decided"][:, :n].any() or d["decided"][:, 2 * n:].any()
    u = slice(n, 2 * n)
    assert not d["decided"][:, u].any() and not d["changed"][:, u].any()
    for f in ("ops", "n_candidates", "score", "probs", "vol_r", "vol_w",
              "active", "steady", "ratio"):
        assert not d[f][:, u].any(), f
    want = np.stack([bb.stacked("window_pages")[1],
                     bb.stacked("rpcs_in_flight")[1]], axis=-1)
    np.testing.assert_array_equal(d["theta"][:, u],
                                  np.broadcast_to(want, d["theta"][:, u].shape))
    assert d["vol_r"][:, :n].any()
    tl = trace.timeline
    o = bb.topo.n_osts
    assert tl["read_bytes"].shape == (6 * 10, 3 * o)
    assert tl["nic_scale"].shape == (60, 3 * bb.topo.n_clients)
    assert tl["t"][-1] == bb.state.now
    # the last sample follows the run's last tick: each element's OST
    # tracks are its own sums of the final counters
    done = bb.stacked("ctr_bytes_done")
    osc_ost = bb.topo.osc_ost.numpy()
    for e in range(3):
        for op, f in ((0, "read_bytes"), (1, "write_bytes")):
            want = np.bincount(osc_ost, weights=done[e, op], minlength=o)
            np.testing.assert_array_equal(tl[f][-1, e * o:(e + 1) * o],
                                          want, err_msg=f)
    # the host path: the same decisions, a timeline of its own ticks
    fleet = B.run_batch(bh, model, seconds=3.0, interval=0.5,
                        tune_cols=cols, trace=cfg)
    th = fleet.trace
    th.validate()
    cols_t = th.oscs
    np.testing.assert_array_equal(th.decisions["t"], d["t"])
    for f in ("decided", "theta", "changed", "probs", "score", "ratio",
              "steady", "warm"):
        np.testing.assert_array_equal(th.decisions[f], d[f][:, cols_t],
                                      err_msg=f)
    for f in TS.TIMELINE_FIELDS:
        np.testing.assert_array_equal(th.timeline[f], tl[f], err_msg=f)
    with pytest.raises(ValueError, match="untuned host batches"):
        B.run_batch(_batch(), None, seconds=1.0, trace=cfg)


def test_loop_cache_keys_on_trace(model):
    B.reset_loop_cache_stats()
    cfg = TS.TraceConfig(stride=10)
    batch = _batch()
    # 77 ticks an interval: keys no other test made
    loops = [B._cached_loop(batch.params, batch.fleet, 77, model, None, t)
             for t in (None, cfg, TS.TraceConfig(stride=10), None)]
    assert len(set(loops)) == 2
    assert loops[0] is loops[3] and loops[1] is loops[2]
    assert loops[0].trace_config is None and loops[1].trace_config == cfg
    s = B.loop_cache_stats()
    assert (s["misses"], s["hits"]) == (2, 2)


# --------------------------------------------------------------------- #
# sinks: files and renders shared with the reference
# --------------------------------------------------------------------- #
DIAGNOSIS = {"cause": "gate_blocked", "losing": True,
             "arms": {"factual": 1.0, "pin_best_static": 2.0},
             "n_evidence_total": 2,
             "evidence": [{"interval": 3, "osc": 1, "t": 2.0},
                          {"pin_best_static_mbs": 2.0}]}


def _assert_traces_close(a, b):
    assert (a.n_intervals, a.n_interfaces) == (b.n_intervals,
                                                b.n_interfaces)
    assert (a.config.stride, a.config.timeline) == (b.config.stride,
                                                    b.config.timeline)
    np.testing.assert_array_equal(a.oscs, b.oscs)
    for f in TS.DECISION_FIELDS:
        np.testing.assert_allclose(a.decisions[f], b.decisions[f],
                                   rtol=1e-6, atol=1e-9, err_msg=f)
    for f in TS.TIMELINE_FIELDS:
        np.testing.assert_allclose(a.timeline[f], b.timeline[f],
                                   rtol=1e-6, atol=1e-9, err_msg=f)


def test_jsonl_read_both_ways(runs, ref_trace, tmp_path):
    port = runs["torch-fused", True][1].trace
    p = TK.write_jsonl(port, str(tmp_path / "port.jsonl"),
                       diagnosis=DIAGNOSIS)
    back = RK.read_jsonl(p)
    back.validate()
    _assert_traces_close(port, back)
    assert RK.read_jsonl_diagnosis(p) == TK.read_jsonl_diagnosis(p)
    assert TK.read_jsonl_diagnosis(p)["cause"] == "gate_blocked"
    r = RK.write_jsonl(ref_trace, str(tmp_path / "ref.jsonl"))
    back = TK.read_jsonl(r)
    back.validate()
    assert isinstance(back, TS.RunTrace)
    _assert_traces_close(ref_trace, back)
    assert TK.read_jsonl_diagnosis(r) is None
    # the same bytes from either writer, and again after a read
    mine = TK.write_jsonl(port, str(tmp_path / "p2.jsonl"))
    theirs = RK.write_jsonl(_ref_run_trace(port), str(tmp_path / "r2.jsonl"))
    again = TK.write_jsonl(TK.read_jsonl(mine), str(tmp_path / "p3.jsonl"))
    text = open(mine).read()
    assert text == open(theirs).read() == open(again).read()
    (tmp_path / "bad.jsonl").write_text('{"kind": "meta", "schema": "x"}\n')
    for read in (TK.read_jsonl, TK.read_jsonl_diagnosis):
        with pytest.raises(ValueError, match="not a"):
            read(str(tmp_path / "bad.jsonl"))


@pytest.mark.parametrize("diagnosis", [None, DIAGNOSIS])
def test_chrome_and_summary_equal_reference(runs, diagnosis):
    port = runs["torch", True][1].trace
    ref = _ref_run_trace(port)
    doc = TK.chrome_trace(port, diagnosis=diagnosis)
    assert doc == RK.chrome_trace(ref, diagnosis=diagnosis)
    timed = [e["ts"] for e in doc["traceEvents"] if e["ph"] != "M"]
    assert timed == sorted(timed) and any(
        e["ph"] == "C" for e in doc["traceEvents"])
    md = TK.render_summary(port, title="mixed", diagnosis=diagnosis)
    assert md == RK.render_summary(ref, title="mixed", diagnosis=diagnosis)
    assert "mixed" in md and "OST timeline" in md


# --------------------------------------------------------------------- #
# timers and provenance
# --------------------------------------------------------------------- #
def test_phase_timers():
    t = PhaseTimers()
    with t.phase("dispatch"):
        pass
    with t.phase("device", device="cpu"):
        pass
    t.add("dispatch", 0.5)
    s = t.summary()
    assert s["dispatch"]["calls"] == 2 and s["dispatch"]["seconds"] >= 0.5
    assert s["device"]["calls"] == 1
    t.reset()
    assert t.summary() == {}


def test_compile_execute_split(model):
    """On the CPU a loop runs eagerly: nothing to capture."""
    sim = port_sim("mixed")
    table, wstate = table_from_sim(sim)
    loop = FusedLoop(sim.params, sim.topo, 100, model)
    out = compile_execute_split(loop, table, sim.state, wstate, 2)
    assert out["compile_s"] == 0.0 and out["execute_s"] > 0
    assert out["out"].n_intervals == 2
    out = compile_execute_split(lambda x: x + 1, 1)
    assert out["out"] == 2 and out["compile_s"] == 0.0


def test_collect_provenance():
    p = collect_provenance()
    for key in ("git_sha", "git_dirty", "platform", "python",
                "torch_version", "cuda_version", "device_count",
                "device_kind", "loop_cache"):
        assert key in p, key
    assert p["torch_version"] == torch.__version__
    assert set(p["loop_cache"]) >= {"hits", "misses", "size", "captures"}
    if not torch.cuda.is_available():
        assert (p["device_count"], p["device_kind"]) == (0, "none")


def test_cpu_tracing_launches_nothing(model):
    LAUNCHES.clear()
    run_fleet(port_sim("readheavy"), model, seconds=1.5, interval=0.5,
              device="cpu", backend="torch-fused", trace=CFG)
    assert dict(LAUNCHES) == {}
