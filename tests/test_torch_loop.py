"""The port's fused tuning loop and per-interface agents on the CPU.

``run_fleet(backend="torch-fused")`` (:class:`repro_torch.pfs.loop_torch.
FusedLoop`, every interval's decisions on the device) is held against:

- the port's host loop ``run_fleet(backend="torch")``: decision records
  identical (interfaces, ops, θ, ``changed``, candidates, scores and
  probabilities exact), knobs equal, every state field within 1e-6
  relative (bit-equality is expected and observed; 1e-6 is the bar);
- the reference's ``run_fleet(backend="numpy")``: θ trajectories equal;
- the reference's own ``FusedLoop`` (``repro/pfs/loop_jax.py``), run in a
  subprocess: the factual run and four interventions, decision records
  identical and counters within 1e-6.  Under jax 0.9.0
  ``repro.pfs.loop_jax`` imports only with the alias
  ``jax.experimental.enable_x64 = jax.enable_x64``; the child sets it
  before importing the reference, and this process never does.

Also: ``k = 2`` histories, a ``tune_mask`` subset, host ticks continuing
after ``ingest_fused``, out-of-band knob changes seen by the next
decision, the untuned loop against ``FusedEngine``, the tensor clock
against the float clock, and the per-interface agents
(``core/agent.py``) against the reference's.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core.agent import run_with_agents as ref_run_with_agents  # noqa: E402
from repro.core.agent import run_with_loop_agents as ref_run_with_loop_agents  # noqa: E402
from repro.core.fleet import run_fleet as ref_run_fleet  # noqa: E402
from repro.core.gbdt import GBDTClassifier, GBDTParams  # noqa: E402
from repro.core.metrics import feature_dim  # noqa: E402
from repro.pfs import PFSSim as RefSim  # noqa: E402
from repro.pfs import workloads as RW  # noqa: E402
from repro.pfs.engine import READ, WRITE  # noqa: E402
from repro_torch.convert import model_from_numpy  # noqa: E402
from repro_torch.core.agent import (DIALAgent, ReferenceLoopAgent,  # noqa: E402
                                    SimClientPort, run_with_agents,
                                    run_with_loop_agents)
from repro_torch.core.fleet import FleetAgent, SimFleetPort, run_fleet  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.pfs import workloads as TW  # noqa: E402
from repro_torch.pfs.engine import PFSSim  # noqa: E402
from repro_torch.pfs.engine_torch import FusedEngine  # noqa: E402
from repro_torch.pfs.loop_torch import FusedLoop, Intervention  # noqa: E402
from repro_torch.pfs.state import engine_step  # noqa: E402
from repro_torch.pfs.workloads import table_from_sim  # noqa: E402

FOREST_FIELDS = ("feature", "threshold", "leaf", "base_score", "depth",
                 "n_features")
ARMS = ("factual", "neutral", "pin", "gates_open", "freeze")
PIN = (1024, 32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These sizes run fastest on one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------- #
# scenarios and models
# --------------------------------------------------------------------- #
def _mixed(W, sim):
    """4 clients x 2 OSTs: sequential and random readers and writers."""
    sim.attach(W.sequential_stream(0, READ, 4 * 2**20, ost=0))
    sim.attach(W.random_stream(1, WRITE, 64 * 1024, ost=1, n_threads=2))
    sim.attach(W.sequential_stream(2, WRITE, 2 * 2**20, ost=0, n_threads=2))
    sim.attach(W.random_stream(3, READ, 256 * 1024, ost=1))
    sim.set_knobs(np.arange(sim.n_osc), window_pages=64, rpcs_in_flight=2)
    return sim


def _readheavy(W, sim):
    """3 clients x 2 OSTs, two readers and one writer."""
    sim.attach(W.sequential_stream(0, READ, 8 * 2**20, ost=0, n_threads=2))
    sim.attach(W.random_stream(1, READ, 256 * 1024, ost=1, n_threads=2))
    sim.attach(W.sequential_stream(2, WRITE, 1 * 2**20, ost=1))
    sim.set_knobs(np.arange(sim.n_osc), window_pages=16, rpcs_in_flight=1)
    return sim


SIMS = {"mixed": ((4, 2), _mixed), "readheavy": ((3, 2), _readheavy)}


def port_sim(name):
    (c, o), build = SIMS[name]
    return build(TW, PFSSim(c, o, device="cpu"))


def ref_sim(name):
    (c, o), build = SIMS[name]
    return build(RW, RefSim(n_clients=c, n_osts=o, seed=0))


def forests(k=1, seed=0, n_trees=8, depth=3):
    """Small forests fitted on seeded data (mostly positive labels, so
    the tuner clears τ and moves θ), as reference field dicts."""
    rng = np.random.default_rng(seed)

    def forest(dim):
        x = rng.normal(size=(400, dim)).astype(np.float32)
        y = (x[:, 0] + x[:, -1] > -1.0).astype(float)
        f = GBDTClassifier(GBDTParams(n_trees=n_trees, max_depth=depth)).fit(
            x, y).forest
        return {name: getattr(f, name) for name in FOREST_FIELDS}

    return forest(feature_dim(READ, k)), forest(feature_dim(WRITE, k))


@pytest.fixture(scope="module")
def forest_pair():
    return forests()


@pytest.fixture(scope="module")
def model(forest_pair):
    return model_from_numpy(*forest_pair, device="cpu")


def below_tau_model():
    """Every probability sigmoid(-5) < τ: Algorithm 1 always keeps the
    applied θ, so each decision shows what the loop believes is applied."""
    def forest(dim):
        return dict(feature=np.zeros((1, 1), dtype=np.int32),
                    threshold=np.zeros((1, 1), dtype=np.float32),
                    leaf=np.zeros((1, 2), dtype=np.float32),
                    base_score=-5.0, depth=1, n_features=dim)
    return model_from_numpy(forest(feature_dim(READ)),
                            forest(feature_dim(WRITE)), device="cpu")


def traj(decisions):
    return [(r.oscs.tolist(), r.ops.tolist(), np.asarray(
        r.decisions.theta).tolist(), np.asarray(r.decisions.changed).tolist())
        for r in decisions]


def assert_records_equal(a, b):
    """Decision records identical, probabilities and scores included."""
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert torch.equal(ra.oscs, rb.oscs) and torch.equal(ra.ops, rb.ops)
        for f in dataclasses.fields(ra.decisions):
            assert torch.equal(getattr(ra.decisions, f.name),
                               getattr(rb.decisions, f.name)), f.name


def assert_states_close(a, b, rtol=1e-6):
    """Knobs equal; every other field within ``rtol`` (floor 1)."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if not torch.is_tensor(x):
            assert x == pytest.approx(y, rel=1e-12), f.name
            continue
        if not x.is_floating_point():
            assert torch.equal(x, y), f.name
            continue
        x, y = x.numpy(), np.asarray(y, dtype=np.float64)
        err = np.max(np.abs(x - y) / np.maximum(np.abs(x), 1.0))
        assert err <= rtol, (f.name, err)


def host_run(name, model, seconds=4.0, oscs=None):
    sim = port_sim(name)
    return sim, run_fleet(sim, model, oscs=oscs, seconds=seconds,
                          interval=0.5, device="cpu")


@pytest.fixture(scope="module")
def host_runs(model):
    return {name: host_run(name, model) for name in SIMS}


# --------------------------------------------------------------------- #
# the fused loop against the port's host loop and the reference's
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", sorted(SIMS))
def test_fused_matches_host_and_reference(forest_pair, model, host_runs,
                                          name):
    sim_h, fleet_h = host_runs[name]
    sim_f = port_sim(name)
    LAUNCHES.clear()
    fleet_f = run_fleet(sim_f, model, seconds=4.0, interval=0.5,
                        device="cpu", backend="torch-fused")
    assert dict(LAUNCHES) == {}          # the CPU runs the plain versions
    assert fleet_f.loop.last_run == {"graph": False, "replays": 0}
    assert len(fleet_f.decisions) == len(fleet_h.decisions) == 8
    assert fleet_f._ticks == fleet_h._ticks == 8
    assert any(r.decisions.changed.any() for r in fleet_f.decisions)
    assert_records_equal(fleet_f.decisions, fleet_h.decisions)
    assert_states_close(sim_h.state, sim_f.state)
    assert sim_f.issued == pytest.approx(sim_h.issued, rel=1e-12)

    from repro.core.model import DIALModel as RefModel
    from repro.core.gbdt import DenseForest as RefForest
    ref_model = RefModel(read_forest=RefForest(**forest_pair[0]),
                         write_forest=RefForest(**forest_pair[1]))
    ref = ref_sim(name)
    ref_fleet = ref_run_fleet(ref, ref_model, seconds=4.0, interval=0.5,
                              backend="numpy")
    assert traj(fleet_f.decisions) == traj(ref_fleet.decisions)
    np.testing.assert_array_equal(sim_f.window_pages.numpy(),
                                  ref.window_pages)
    np.testing.assert_array_equal(sim_f.rpcs_in_flight.numpy(),
                                  ref.rpcs_in_flight)


def test_fused_k2_history_matches_host():
    """k = 2: the fused (k+1)-deep ring against the host agent's deque."""
    model2 = model_from_numpy(*forests(k=2), k=2, device="cpu")
    sim_h = port_sim("mixed")
    table, wstate = table_from_sim(sim_h)
    engine = FusedEngine(sim_h.params, sim_h.topo, table, 100)
    fleet = FleetAgent(SimFleetPort(sim_h), model2, k=2, device="cpu")
    for _ in range(8):
        sim_h.state, wstate = engine.run_interval(sim_h.state, wstate)
        fleet.tick()

    sim_f = port_sim("mixed")
    table_f, wstate_f = table_from_sim(sim_f)
    loop = FusedLoop(sim_f.params, sim_f.topo, 100, model2, k=2)
    result = loop.run(table_f, sim_f.state, wstate_f, 8)
    assert sum(len(r) for r in fleet.decisions) > 0
    assert_records_equal(result.decisions, fleet.decisions)
    assert all(h.shape[0] == 3 for h in result.hist)
    assert_states_close(sim_h.state, result.state)


def test_fused_schedule_matches_host(model):
    """A disturbed whole-run schedule: the fused loop takes each
    interval's rows, as the host engine takes them per interval."""
    from repro_torch.pfs.state import Disturbance

    rng = np.random.default_rng(5)
    n, steps = 5, 100
    sim = port_sim("mixed")
    t = lambda shape, lo, hi: torch.as_tensor(  # noqa: E731
        rng.uniform(lo, hi, (n * steps, shape)))
    sched = Disturbance(bw_scale=t(sim.n_osts, 0.3, 1.2),
                        iops_scale=t(sim.n_osts, 0.5, 1.5),
                        bg_bytes=t(sim.n_osts, 0.0, 2e6),
                        nic_scale=t(sim.n_clients, 0.5, 1.0))
    table, ws = table_from_sim(sim)
    engine = FusedEngine(sim.params, sim.topo, table, steps)
    fleet = FleetAgent(SimFleetPort(sim), model, device="cpu")
    for i in range(n):
        rows = Disturbance(*(getattr(sched, f.name)[i * steps:(i + 1) * steps]
                             for f in dataclasses.fields(Disturbance)))
        sim.state, ws = engine.run_interval(sim.state, ws, schedule=rows)
        fleet.tick()
    sim_f = port_sim("mixed")
    table_f, wstate_f = table_from_sim(sim_f)
    loop = FusedLoop(sim_f.params, sim_f.topo, steps, model)
    result = loop.run(table_f, sim_f.state, wstate_f, n, schedule=sched)
    assert sum(len(r) for r in fleet.decisions) > 0
    assert_records_equal(result.decisions, fleet.decisions)
    assert_states_close(sim.state, result.state)
    with pytest.raises(ValueError, match="ticks"):
        loop.run(table_f, sim_f.state, wstate_f, n + 1, schedule=sched)


def test_fused_tune_mask_keeps_other_knobs(model):
    oscs = torch.tensor([0, 1, 2])
    sim_h, fleet_h = host_run("mixed", model, seconds=3.0, oscs=oscs)
    sim_f = port_sim("mixed")
    fleet_f = run_fleet(sim_f, model, oscs=oscs, seconds=3.0, interval=0.5,
                        device="cpu", backend="torch-fused")
    assert any(len(r) for r in fleet_f.decisions)
    assert_records_equal(fleet_f.decisions, fleet_h.decisions)
    assert all(set(r.oscs.tolist()) <= {0, 1, 2} for r in fleet_f.decisions)
    assert torch.equal(sim_f.window_pages, sim_h.window_pages)
    assert (sim_f.window_pages[3:] == 64).all()
    assert (sim_f.rpcs_in_flight[3:] == 2).all()


def test_host_ticks_continue_after_ingest_fused(model, host_runs):
    """4 fused intervals, then 4 host ticks == 8 host ticks."""
    sim_h, fleet_h = host_runs["mixed"]
    sim_m = port_sim("mixed")
    fleet_m = run_fleet(sim_m, model, seconds=2.0, interval=0.5,
                        device="cpu", backend="torch-fused")
    table, wstate = table_from_sim(sim_m)
    engine = FusedEngine(sim_m.params, sim_m.topo, table, 100)
    for _ in range(4):
        sim_m.state, wstate = engine.run_interval(sim_m.state, wstate)
        fleet_m.tick()
    # the first host tick after the run decides (its history was adopted)
    assert len(fleet_h.decisions[4]) > 0
    assert_records_equal(fleet_m.decisions, fleet_h.decisions)
    assert_states_close(sim_h.state, sim_m.state)


@pytest.mark.parametrize("kind", ["fleet", "loop", "fused"])
def test_decision_sees_out_of_band_knob_change(kind):
    """Knobs flipped behind the tuner's back between intervals (or
    between two fused runs) reach the next decision's applied θ."""
    model = below_tau_model()
    sim = port_sim("mixed")
    steps = 100
    table, wstate = table_from_sim(sim)
    engine = FusedEngine(sim.params, sim.topo, table, steps)
    if kind == "fleet":
        agents = [FleetAgent(SimFleetPort(sim), model, device="cpu")]
        results = lambda r: [r.decisions.one(i)  # noqa: E731
                             for i in range(len(r))]
    elif kind == "loop":
        agents = [ReferenceLoopAgent(SimClientPort(sim, c), model)
                  for c in range(sim.n_clients)]
        results = lambda r: [d for _, _, d in r]  # noqa: E731
    if kind == "fused":
        loop = FusedLoop(sim.params, sim.topo, steps, model)
        first = loop.run(table, sim.state, wstate, 4)
        sim.state, wstate = first.state, first.wstate
        seen = [d.theta for r in first.decisions
                for d in (r.decisions.one(i) for i in range(len(r)))]
        assert seen and all(t == (64, 2) for t in seen)
    else:
        for _ in range(4):
            sim.state, wstate = engine.run_interval(sim.state, wstate)
            for a in agents:
                a.tick()

    sim.set_knobs(np.arange(sim.n_osc), window_pages=256, rpcs_in_flight=8)
    if kind == "fused":
        decided = loop.run(table, sim.state, wstate, 6).decisions
        decisions = [r.decisions.one(i) for r in decided
                     for i in range(len(r))]
    else:
        decisions = []
        for _ in range(6):
            sim.state, wstate = engine.run_interval(sim.state, wstate)
            for a in agents:
                decisions += results(a.tick())
    assert decisions, "no decidable rows after the flip; test is vacuous"
    for d in decisions:
        assert d.theta == (256, 8), "stale applied θ"
        assert not d.changed


def test_untuned_loop_equals_fused_engine():
    sim = port_sim("mixed")
    table, wstate = table_from_sim(sim)
    engine = FusedEngine(sim.params, sim.topo, table, 100)
    st, ws = sim.state, wstate
    for _ in range(3):
        st, ws = engine.run_interval(st, ws)
    loop = FusedLoop(sim.params, sim.topo, 100, None, tuned=False)
    result = loop.run(table, sim.state, wstate, 3)
    assert result.decisions == [] and result.trace is None
    assert result.hist is None and result.n_intervals == 3
    for f in dataclasses.fields(st):
        a, b = getattr(st, f.name), getattr(result.state, f.name)
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), f.name
    assert torch.equal(ws.issued, result.wstate.issued)


# --------------------------------------------------------------------- #
# interventions, and the reference's fused loop in a subprocess
# --------------------------------------------------------------------- #
CHILD = r"""
import sys
import jax
import jax.experimental
# jax 0.9.0 moved enable_x64; the reference imports the old name
jax.experimental.enable_x64 = jax.enable_x64
import numpy as np
from repro.core.gbdt import DenseForest
from repro.core.model import DIALModel
from repro.pfs import PFSSim
from repro.pfs import workloads as W
from repro.pfs.engine import READ, WRITE
from repro.pfs.loop_jax import FusedLoop, Intervention
from repro.pfs.workloads import table_from_sim

src, out, arms, pin = sys.argv[1], sys.argv[2], sys.argv[3].split(","), \
    tuple(int(v) for v in sys.argv[4].split(","))
z = np.load(src)
fields = ("feature", "threshold", "leaf", "base_score", "depth", "n_features")
model = DIALModel(*(DenseForest(**{f: z[f"{op}_{f}"][()] for f in fields})
                    for op in ("read", "write")))

def build():
    sim = PFSSim(n_clients=4, n_osts=2, seed=0)
    sim.attach(W.sequential_stream(0, READ, 4 * 2**20, ost=0))
    sim.attach(W.random_stream(1, WRITE, 64 * 1024, ost=1, n_threads=2))
    sim.attach(W.sequential_stream(2, WRITE, 2 * 2**20, ost=0, n_threads=2))
    sim.attach(W.random_stream(3, READ, 256 * 1024, ost=1))
    sim.set_knobs(np.arange(sim.n_osc), window_pages=64, rpcs_in_flight=2)
    return sim

sim = build()
loop = FusedLoop(sim.params, sim.topo, 100, model, seg_backend="jax")
n = sim.n_osc
ivs = {"factual": None, "neutral": Intervention.neutral(n),
       "pin": Intervention.pin(n, pin), "gates_open": Intervention.gates_open(n),
       "freeze": Intervention.freeze_theta(n)}
res = {}
for arm in arms:
    sim = build()
    table, wstate = table_from_sim(sim)
    r = loop.run(table, sim.state, wstate, 8, intervene=ivs[arm])
    for k, v in r.trace.items():
        res[f"{arm}/trace/{k}"] = np.asarray(v)
    for k in ("window_pages", "rpcs_in_flight", "ctr_bytes_done",
              "ctr_rpcs_sent", "ctr_rpc_bytes", "ctr_partial_rpcs",
              "ctr_latency_sum", "ctr_rpcs_done", "ctr_req_count",
              "ctr_req_bytes", "ctr_cache_hit_bytes", "ctr_block_time",
              "ctr_pending_integral", "ctr_active_integral",
              "ctr_dirty_integral", "ctr_grant_integral"):
        res[f"{arm}/state/{k}"] = np.asarray(getattr(r.state, k))
np.savez(out, **res)
"""


@pytest.fixture(scope="module")
def reference_fused(forest_pair, tmp_path_factory):
    """Start the reference's fused loop in a child process (it runs
    while the other tests do); the value waits for its results."""
    d = tmp_path_factory.mktemp("ref_fused")
    src, out = d / "forests.npz", d / "out.npz"
    np.savez(src, **{f"{op}_{f}": np.asarray(forest[f])
                     for op, forest in zip(("read", "write"), forest_pair)
                     for f in FOREST_FIELDS})
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", CHILD, str(src), str(out), ",".join(ARMS),
         ",".join(map(str, PIN))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def result():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log[-3000:]
        with np.load(out) as z:
            return {k: z[k] for k in z.files}

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def start_reference_early(reference_fused):
    """Start the child with the module's first test."""


@pytest.fixture(scope="module")
def port_arms(model):
    """The port's loop on the mixed sim, factual and intervened."""
    n = port_sim("mixed").n_osc
    ivs = {"factual": None, "neutral": Intervention.neutral(n),
           "pin": Intervention.pin(n, PIN),
           "gates_open": Intervention.gates_open(n),
           "freeze": Intervention.freeze_theta(n)}
    out = {}
    loop = None
    for arm in ARMS:
        sim = port_sim("mixed")
        table, wstate = table_from_sim(sim)
        loop = loop or FusedLoop(sim.params, sim.topo, 100, model)
        out[arm] = loop.run(table, sim.state, wstate, 8,
                            intervene=ivs[arm])
    return out


def test_neutral_intervention_is_bit_neutral(port_arms):
    a, b = port_arms["factual"], port_arms["neutral"]
    for key in a.trace:
        assert torch.equal(a.trace[key], b.trace[key]), key
    for f in dataclasses.fields(a.state):
        x, y = getattr(a.state, f.name), getattr(b.state, f.name)
        assert (torch.equal(x, y) if torch.is_tensor(x) else x == y), f.name


def test_interventions_pin_freeze_and_open_gates(port_arms):
    fact = port_arms["factual"]
    assert bool(fact.trace["changed"][fact.trace["decided"]].any())
    pin = port_arms["pin"].state
    assert (pin.window_pages == PIN[0]).all()
    assert (pin.rpcs_in_flight == PIN[1]).all()
    frozen = port_arms["freeze"]
    assert (frozen.state.window_pages == 64).all()
    assert (frozen.state.rpcs_in_flight == 2).all()
    assert bool(frozen.trace["changed"][frozen.trace["decided"]].any())
    gated = (~fact.trace["decided"]) & port_arms["gates_open"].trace[
        "decided"]
    warm = torch.arange(8) >= 3                      # warm-up 2, k = 1
    assert bool(gated[warm].any()), "no gated row was opened"
    assert not bool(port_arms["gates_open"].trace["decided"][~warm].any())


@pytest.mark.parametrize("arm", ARMS)
def test_matches_reference_fused_loop(port_arms, reference_fused, arm):
    """Decision records identical to the reference's FusedLoop (run in a
    subprocess) per intervention arm, the probabilities exact; the
    Algorithm 1 score within 1e-12 relative (XLA may contract the
    reference's ``f * (1 + a x) + y`` into fused multiply-adds, 1 ulp
    from the numpy order the port follows); counters within 1e-6."""
    ref = reference_fused()
    mine = port_arms[arm]
    for key, got in mine.trace.items():
        want = ref[f"{arm}/trace/{key}"]
        if key == "score":
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                       atol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=key)
    for k in ("window_pages", "rpcs_in_flight"):
        np.testing.assert_array_equal(getattr(mine.state, k).numpy(),
                                      ref[f"{arm}/state/{k}"])
    for key, want in ref.items():
        if key.startswith(f"{arm}/state/ctr_"):
            got = getattr(mine.state, key.rsplit("/", 1)[1]).numpy()
            err = np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0))
            assert err <= 1e-6, (key, err)


# --------------------------------------------------------------------- #
# the device clock, and the per-interface agents
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("ticks", [1, 100])
def test_tensor_clock_is_bit_equal_to_float_clock(ticks):
    sim = port_sim("mixed")
    table, wstate = table_from_sim(sim)
    st_f, ws_f = sim.state, wstate
    st_t = dataclasses.replace(
        sim.state, now=torch.tensor(sim.state.now, dtype=torch.float64),
        tick_index=torch.tensor(sim.state.tick_index))
    ws_t = wstate
    for _ in range(ticks):
        demand_f, ws_f = table.demand_step(sim.params, ws_f, st_f)
        st_f = engine_step(sim.params, sim.topo, st_f, demand_f)
        demand_t, ws_t = table.demand_step(sim.params, ws_t, st_t)
        st_t = engine_step(sim.params, sim.topo, st_t, demand_t)
    assert torch.is_tensor(st_t.now) and torch.is_tensor(st_t.tick_index)
    assert isinstance(st_f.now, float)
    assert float(st_t.now) == st_f.now and int(st_t.tick_index) == ticks
    for f in dataclasses.fields(st_f):
        if f.name not in ("now", "tick_index"):
            assert torch.equal(getattr(st_f, f.name),
                               getattr(st_t, f.name)), f.name
    assert torch.equal(ws_f.issued, ws_t.issued)


def _ref_model(forest_pair):
    from repro.core.gbdt import DenseForest as RefForest
    from repro.core.model import DIALModel as RefModel
    return RefModel(read_forest=RefForest(**forest_pair[0]),
                    write_forest=RefForest(**forest_pair[1]))


def test_run_with_agents_matches_reference(forest_pair, model):
    clients = [0, 1, 3]
    sim = port_sim("mixed")
    fleet = run_with_agents(sim, model, clients, seconds=3.0, device="cpu")
    ref = ref_sim("mixed")
    ref_fleet = ref_run_with_agents(ref, _ref_model(forest_pair), clients,
                                    seconds=3.0)
    assert any(len(r) for r in fleet.decisions)
    assert traj(fleet.decisions) == traj(ref_fleet.decisions)
    np.testing.assert_array_equal(sim.window_pages.numpy(), ref.window_pages)


class OpaquePort:
    """A per-interface port that hides the simulator behind it."""

    def __init__(self, port):
        self._port = port

    def osc_ids(self):
        return self._port.osc_ids()

    def probe(self, osc):
        return self._port.probe(osc)

    def set_knobs(self, osc, window_pages, rpcs_in_flight):
        self._port.set_knobs(osc, window_pages, rpcs_in_flight)


def test_loop_agents_match_reference_and_dial_agents(forest_pair, model):
    """One ReferenceLoopAgent per client against the reference's, and one
    DIALAgent per client (the fleet path) against both."""
    clients = [0, 1, 2, 3]
    sim = port_sim("mixed")
    agents = run_with_loop_agents(sim, model, clients, seconds=3.0,
                                  device="cpu")
    ref = ref_sim("mixed")
    ref_agents = ref_run_with_loop_agents(ref, _ref_model(forest_pair),
                                          clients, seconds=3.0)
    rows = lambda ds: [(o, op, d.theta, d.changed)  # noqa: E731
                       for o, op, d in ds]
    assert sum(len(a.decisions) for a in agents) > 0
    for mine, theirs in zip(agents, ref_agents):
        assert rows(mine.decisions) == rows(theirs.decisions)
    np.testing.assert_array_equal(sim.window_pages.numpy(), ref.window_pages)
    np.testing.assert_array_equal(sim.rpcs_in_flight.numpy(),
                                  ref.rpcs_in_flight)

    # even clients take the simulator's tensors directly (SimFleetPort),
    # odd ones an opaque port, probed interface by interface
    # (LoopFleetPort)
    sim_d = port_sim("mixed")
    dial = [DIALAgent(SimClientPort(sim_d, c) if c % 2 == 0
                      else OpaquePort(SimClientPort(sim_d, c)),
                      model, device="cpu") for c in clients]
    assert [type(a._fleet.port).__name__ for a in dial] == [
        "SimFleetPort", "LoopFleetPort"] * 2
    table, wstate = table_from_sim(sim_d)
    engine = FusedEngine(sim_d.params, sim_d.topo, table, 100)
    for _ in range(6):
        sim_d.state, wstate = engine.run_interval(sim_d.state, wstate)
        for a in dial:
            a.tick()
    for mine, loop_agent in zip(dial, agents):
        assert rows(mine.decisions) == rows(loop_agent.decisions)
    assert torch.equal(sim_d.window_pages, sim.window_pages)
