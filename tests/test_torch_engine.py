"""The port's engine against the reference's numpy engine.

The same mixed vpic/bdcats/dlio/filebench table (with overlapping
stripes, so the demand runs in two waves) goes through the reference's
``run_interval`` and the port's :class:`FusedEngine` on the CPU.  Both
are float64; every probe counter and fluid field is held within 1e-6
relative (the reference's own fused-vs-numpy bar), after one tick and
after a 100-tick interval, and the port's state conserves bytes per op.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.pfs import PFSSim as RefSim  # noqa: E402
from repro.pfs import workloads as RW  # noqa: E402
from repro.pfs.engine import READ, WRITE  # noqa: E402
from repro.pfs.state import Disturbance as RefDisturbance  # noqa: E402
from repro_torch.convert import state_from_numpy, table_from_numpy  # noqa: E402
from repro_torch.pfs import workloads as TW  # noqa: E402
from repro_torch.pfs.engine import PFSSim  # noqa: E402
from repro_torch.pfs.engine_torch import FusedEngine  # noqa: E402
from repro_torch.pfs.state import Disturbance  # noqa: E402

FIELDS = (
    "ctr_bytes_done", "ctr_rpcs_sent", "ctr_rpc_bytes", "ctr_partial_rpcs",
    "ctr_latency_sum", "ctr_rpcs_done", "ctr_req_count", "ctr_req_bytes",
    "ctr_cache_hit_bytes", "ctr_block_time", "ctr_pending_integral",
    "ctr_active_integral", "ctr_dirty_integral", "ctr_grant_integral",
    "randomness", "pending", "queue_rpcs", "queue_bytes", "active_rpcs",
    "setup_work", "unready_bytes", "ready_bytes", "dirty_bytes",
    "grant_used", "write_blocked",
)
TABLE_FIELDS = ("client", "op", "req_size", "randomness", "n_threads",
                "thread_rate", "duty_cycle", "period", "stripe_len", "wave",
                "entry_row", "entry_osc", "row_valid")


def mixed_workloads(W):
    """The paper's evaluation mix on 16 clients x 4 OSTs, with two
    overlapping same-client stripes that force a second wave."""
    wls = [W.vpic_write(c, dims=1 + c % 3) for c in range(4)]
    wls += [W.bdcats_read(c, m) for c, m in
            zip(range(4, 8), ("partial", "strided", "full", "partial"))]
    wls += [W.dlio_reader(c, "bert" if c % 2 else "megatron",
                          n_threads=2 + c % 3, osts=(c % 4,))
            for c in range(8, 12)]
    wls += [W.sequential_stream(c, READ, 4 * 2**20, ost=c % 4) if c % 2
            else W.random_stream(c, WRITE, 256 * 1024, ost=c % 4,
                                 n_threads=2) for c in range(12, 16)]
    wls.append(W.bdcats_read(4, "full", osts=(2, 3)))
    wls.append(W.vpic_write(0, dims=1, osts=(2, 3)))
    return wls


def both_sims():
    ref = RefSim(n_clients=16, n_osts=4, seed=0)
    port = PFSSim(16, 4, device="cpu")
    for w in mixed_workloads(RW):
        ref.attach(w)
    for w in mixed_workloads(TW):
        port.attach(w)
    return ref, port


def assert_close(ref_state, state, rtol=1e-6):
    assert state.tick_index == ref_state.tick_index
    assert state.now == ref_state.now
    for f in FIELDS:
        a = np.asarray(getattr(ref_state, f), dtype=float)
        b = getattr(state, f).double().numpy()
        err = np.max(np.abs(a - b) / np.maximum(np.abs(a), 1.0))
        assert err <= rtol, (f, err)
    np.testing.assert_array_equal(state.window_pages.numpy(),
                                  ref_state.window_pages)


def check_conservation(s):
    """Per op, submitted bytes == completed + in-pipeline bytes."""
    g = lambda f: getattr(s, f).numpy()
    pipe = lambda op: (g("pending")[op] + g("queue_bytes")[op]
                       + g("unready_bytes")[op] + g("ready_bytes")[op])
    np.testing.assert_allclose(g("ctr_req_bytes")[READ],
                               g("ctr_bytes_done")[READ] + pipe(READ),
                               rtol=1e-9, atol=1e-3)
    np.testing.assert_allclose(g("ctr_req_bytes")[WRITE],
                               g("ctr_bytes_done")[WRITE],
                               rtol=1e-9, atol=1e-3)
    np.testing.assert_allclose(g("dirty_bytes"), pipe(WRITE), rtol=1e-9,
                               atol=1e-3)


def test_table_matches_reference():
    ref, port = both_sims()
    rt, rws = RW.table_from_sim(ref)
    tt, tws = TW.table_from_sim(port)
    assert (tt.n_waves, tt.n_osc, len(tt)) == (rt.n_waves, rt.n_osc, len(rt))
    assert tt.n_waves == 2 and tt.names == rt.names
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(tt, f).numpy(), getattr(rt, f),
                                      err_msg=f)
    np.testing.assert_array_equal(tws.done_base.numpy(), rws.done_base)


@pytest.mark.parametrize("n_ticks", [1, 100])
def test_interval_matches_reference(n_ticks):
    ref, port = both_sims()
    rt, rws = RW.table_from_sim(ref)
    tt, tws = TW.table_from_sim(port)
    ref_state, rws = RW.run_interval(ref.params, ref.topo, rt, ref.state,
                                     rws, n_ticks)
    state, tws = FusedEngine(port.params, port.topo, tt,
                             n_ticks).run_interval(port.state, tws)
    assert_close(ref_state, state)
    np.testing.assert_allclose(tws.issued.numpy(), rws.issued, rtol=1e-9,
                               atol=1e-3)
    np.testing.assert_allclose(tt.done_bytes(state, tws).numpy(),
                               rt.done_bytes(ref_state, rws), rtol=1e-9,
                               atol=1e-3)
    check_conservation(state)


def test_converted_state_continues_like_reference():
    """A mid-run reference state and table carried across through
    ``convert`` (with knobs moved off the defaults and a disturbance
    schedule) keep tracking the reference."""
    ref, _ = both_sims()
    rt, rws = RW.table_from_sim(ref)
    ref.set_knobs(np.arange(0, 64, 3), window_pages=16, rpcs_in_flight=32)
    state0, rws = RW.run_interval(ref.params, ref.topo, rt, ref.state, rws, 37)
    rng = np.random.default_rng(4)
    sched = RefDisturbance(bw_scale=rng.uniform(0.3, 1.0, (40, 4)),
                           iops_scale=rng.uniform(0.5, 1.0, (40, 4)),
                           bg_bytes=rng.uniform(0.0, 4e6, (40, 4)),
                           nic_scale=rng.uniform(0.5, 1.0, (40, 16)))
    ref_state, rws2 = RW.run_interval(ref.params, ref.topo, rt, state0, rws,
                                      40, schedule=sched)

    port = PFSSim(16, 4, device="cpu")
    state = state_from_numpy(
        {f.name: getattr(state0, f.name) for f in dataclasses.fields(state0)},
        device="cpu")
    table = table_from_numpy({f: getattr(rt, f) for f in TABLE_FIELDS},
                             n_osc=rt.n_osc, n_waves=rt.n_waves,
                             device="cpu")
    wstate = TW.WorkloadState(issued=torch.as_tensor(rws.issued),
                              done_base=torch.as_tensor(rws.done_base))
    tsched = Disturbance(**{f: torch.as_tensor(getattr(sched, f))
                            for f in ("bw_scale", "iops_scale", "bg_bytes",
                                      "nic_scale")})
    state, wstate = FusedEngine(port.params, port.topo, table,
                                40).run_interval(state, wstate, tsched)
    assert_close(ref_state, state)
    np.testing.assert_allclose(wstate.issued.numpy(), rws2.issued,
                               rtol=1e-9, atol=1e-3)


def test_neutral_disturbance_is_identity():
    _, port = both_sims()
    table, ws = TW.table_from_sim(port)
    eng = FusedEngine(port.params, port.topo, table, 30)
    a, _ = eng.run_interval(port.state, ws)
    b, _ = eng.run_interval(port.state, ws, Disturbance.neutral(
        4, 16, "cpu", n_ticks=30))
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_set_knobs_and_attach_base():
    port = PFSSim(2, 2, device="cpu")
    port.set_knobs([1, 3], window_pages=[16, 64], rpcs_in_flight=4)
    np.testing.assert_array_equal(port.window_pages.numpy(), [256, 16, 256, 64])
    np.testing.assert_array_equal(port.rpcs_in_flight.numpy(), [8, 4, 8, 4])
    port.state.ctr_bytes_done[READ, 2] = 5.0
    port.attach(TW.sequential_stream(1, READ, 2**20, ost=0))
    assert port.done_base == [5.0] and port.issued == [0.0]


def test_segment_sums_batched_per_tick(monkeypatch):
    """A tick's reductions go through few segment sums: ``engine_step``
    5 (its per-OST sums paired where their inputs are ready together),
    ``demand_step`` 1 + 3 a wave (a wave's eight per-interface sums in
    one call).  Each call is one kernel launch on the card."""
    from repro_torch.pfs import state as TS
    from repro_torch.pfs.state import engine_step

    calls = {"engine": [], "demand": []}

    def counting(key, fn):
        def wrapped(values, smap):
            calls[key].append(tuple(values.shape))
            return fn(values, smap)
        return wrapped

    monkeypatch.setattr(TS, "segment_sum", counting("engine",
                                                    TS.segment_sum))
    monkeypatch.setattr(TW, "segment_sum", counting("demand",
                                                    TW.segment_sum))
    _, port = both_sims()
    tt, tws = TW.table_from_sim(port)
    demand, _ = tt.demand_step(port.params, tws, port.state)
    engine_step(port.params, port.topo, port.state, demand)
    n_osc = port.topo.n_osc
    assert [s[0] if len(s) == 2 else 1 for s in calls["engine"]] \
        == [1, 2, 2, 2, 1]
    assert len(calls["demand"]) == 1 + 3 * tt.n_waves == 7
    assert calls["demand"].count((8, len(tt.entry_osc))) == tt.n_waves
    assert all(s[-1] == n_osc for s in calls["engine"])
