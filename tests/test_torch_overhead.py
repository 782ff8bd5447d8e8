"""Paper Table III's overhead timing on the CPU (``measure_overhead=``).

Held against the reference's ``repro/core/agent.py`` and
``repro/core/fleet.py`` in-process (the reference's numpy host path
imports without the x64 alias): with ``measure_overhead=True`` the
port's ``FleetAgent`` (through ``run_with_agents``), ``DIALAgent`` and
``ReferenceLoopAgent`` decide exactly as without it, and their timing
lists have the reference's lengths on the same run.  A measured stage
boundary synchronizes a CUDA device and an unmeasured one never does
(``stage_clock``, with ``torch.cuda.synchronize`` counted); the fused
and sharded backends refuse the option.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core.agent import DIALAgent as RefDIALAgent  # noqa: E402
from repro.core.agent import SimClientPort as RefClientPort  # noqa: E402
from repro.core.agent import run_with_agents as ref_run_with_agents  # noqa: E402
from repro.core.agent import run_with_loop_agents as ref_run_loop  # noqa: E402
from repro_torch.core import agent as A  # noqa: E402
from repro_torch.core.fleet import run_fleet  # noqa: E402
from repro_torch.pfs.engine_torch import FusedEngine  # noqa: E402
from repro_torch.pfs.state import READ, WRITE  # noqa: E402
from repro_torch.pfs.workloads import table_from_sim  # noqa: E402
from test_torch_loop import (_ref_model, forests, port_sim,  # noqa: E402
                             ref_sim, traj)

FIELDS = ("snapshot_ms", "inference_ms", "end_to_end_ms")
CLIENTS = [0, 1, 2, 3]


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
    from repro_torch.convert import model_from_numpy
    return model_from_numpy(*forest_pair, device="cpu")


def lengths(timings: dict) -> dict:
    return {(op, f): len(getattr(timings[op], f))
            for op in (READ, WRITE) for f in FIELDS}


def assert_measured(timings: dict) -> None:
    for op in (READ, WRITE):
        tm = timings[op]
        assert len(tm.snapshot_ms) == len(tm.inference_ms) == \
            len(tm.end_to_end_ms)
        assert all(v >= 0 for f in FIELDS for v in getattr(tm, f))
        s = tm.summary()
        assert set(s) == set(FIELDS)
        if tm.end_to_end_ms:
            assert s["end_to_end_ms"] >= s["inference_ms"]


def test_fleet_agent_measured_equals_unmeasured(forest_pair, model):
    plain = A.run_with_agents(port_sim("mixed"), model, CLIENTS,
                              seconds=3.0, device="cpu")
    measured = A.run_with_agents(port_sim("mixed"), model, CLIENTS,
                                 seconds=3.0, measure_overhead=True,
                                 device="cpu")
    ref = ref_run_with_agents(ref_sim("mixed"), _ref_model(forest_pair),
                              CLIENTS, seconds=3.0, measure_overhead=True)
    assert traj(measured.decisions) == traj(plain.decisions) == \
        traj(ref.decisions)
    assert lengths(measured.timings) == lengths(ref.timings)
    assert sum(lengths(measured.timings).values()) > 0
    assert sum(lengths(plain.timings).values()) == 0
    assert_measured(measured.timings)


def test_loop_agents_measured_equals_unmeasured(forest_pair, model):
    rows = lambda ds: [(o, op, d.theta, d.changed)  # noqa: E731
                       for o, op, d in ds]
    plain = A.run_with_loop_agents(port_sim("mixed"), model, CLIENTS,
                                   seconds=3.0, device="cpu")
    measured = A.run_with_loop_agents(port_sim("mixed"), model, CLIENTS,
                                      seconds=3.0, measure_overhead=True,
                                      device="cpu")
    ref = ref_run_loop(ref_sim("mixed"), _ref_model(forest_pair), CLIENTS,
                       seconds=3.0, measure_overhead=True)
    for p, m, r in zip(plain, measured, ref):
        assert rows(m.decisions) == rows(p.decisions) == rows(r.decisions)
        assert lengths(m.timings) == lengths(r.timings)
        assert sum(lengths(p.timings).values()) == 0
        assert_measured(m.timings)
    assert sum(sum(lengths(m.timings).values()) for m in measured) > 0


def test_dial_agents_measured_equals_unmeasured(forest_pair, model):
    """One DIALAgent per client, ticked after each interval."""
    runs = {}
    for measure in (False, True):
        sim = port_sim("mixed")
        agents = [A.DIALAgent(A.SimClientPort(sim, c), model,
                              measure_overhead=measure, device="cpu")
                  for c in CLIENTS]
        table, wstate = table_from_sim(sim)
        engine = FusedEngine(sim.params, sim.topo, table, 100)
        for _ in range(6):
            sim.state, wstate = engine.run_interval(sim.state, wstate)
            for a in agents:
                a.tick()
        runs[measure] = agents
    rsim = ref_sim("mixed")
    ref = [RefDIALAgent(RefClientPort(rsim, c), _ref_model(forest_pair),
                        measure_overhead=True) for c in CLIENTS]
    for _ in range(6):
        for _ in range(100):
            rsim.step()
        for a in ref:
            a.tick()
    rows = lambda ds: [(o, op, d.theta, d.changed)  # noqa: E731
                       for o, op, d in ds]
    for p, m, r in zip(runs[False], runs[True], ref):
        assert rows(m.decisions) == rows(p.decisions) == rows(r.decisions)
        assert lengths(m.timings) == lengths(r.timings)
        assert_measured(m.timings)
    assert sum(sum(lengths(m.timings).values()) for m in runs[True]) > 0


def test_stage_clock_syncs_only_when_measured(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    A.stage_clock(cuda, False)
    A.stage_clock(cpu, True)
    A.stage_clock(cpu, False)
    assert calls == []
    t0 = A.stage_clock(cuda, True)
    assert calls == [cuda] and A.stage_clock(cuda, False) >= t0


@pytest.mark.parametrize("backend", ["torch-fused", "torch-sharded"])
def test_fused_backends_refuse_measure_overhead(model, backend):
    with pytest.raises(ValueError, match="measure_overhead"):
        run_fleet(port_sim("mixed"), model, seconds=1.0, backend=backend,
                  measure_overhead=True, device="cpu")
    assert np.isfinite(A.AgentTimings().summary()["snapshot_ms"])
