"""The multi-device fleet on the CPU: a batch split over a mesh.

``fleet_mesh(devices=[...])`` names devices explicitly; three ``"cpu"``
entries make a 3-device mesh here, and a batch of 5 elements pads to 6
(two per shard, the last shard's second element a phantom copy of
element 0 whose tune mask is off).  Every sharded run is held bit for
bit to the unsharded one: ``run_batch(fused=True, mesh=)`` (θ,
decisions, the whole state, the snapshot ring, traced records with a
timeline, an intervention), ``evaluate(mesh=)``, ``run_sweep(mesh=)`` on
``SMOKE`` cut small, ``diagnose_many(mesh=)`` and ``run_fleet(backend=
"torch-sharded")``; and the refusals.  The reference's
``tests/test_shard.py`` holds its ``shard_map`` program the same way.
"""

import dataclasses
import importlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.convert import model_from_numpy  # noqa: E402
from repro_torch.core.fleet import run_fleet  # noqa: E402
from repro_torch.distributed.sharding import (FLEET_AXIS,  # noqa: E402
                                              fleet_batch_size, fleet_mesh,
                                              pad_fleet, shard_elements,
                                              unpad_fleet)
from repro_torch.lab import fuzz as F  # noqa: E402
from repro_torch.lab.batch import (loop_cache_stats, model_on,  # noqa: E402
                                   run_batch, stack_scenarios)
from repro_torch.lab.evaluate import evaluate  # noqa: E402
from repro_torch.lab.scenarios import build, get_scenario  # noqa: E402
from repro_torch.launch.mesh import make_fleet_mesh  # noqa: E402
from repro_torch.obs.schema import TraceConfig  # noqa: E402
from repro_torch.pfs.loop_torch import Intervention  # noqa: E402
from repro_torch.pfs.state import SimState  # noqa: E402
from test_torch_loop import forests, port_sim  # noqa: E402

# the module (``repro_torch.obs`` exports a function ``diagnose``)
D = importlib.import_module("repro_torch.obs.diagnose")
MESH3 = fleet_mesh(devices=["cpu"] * 3)
# five elements over three devices: two per shard, one phantom; two
# structures, so the batch stacks ragged
FIVE = ("failing_ost", "noisy_neighbor", "degraded_ost", "dlio_bert",
        "failing_ost")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These sizes run fastest on one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return model_from_numpy(*forests(), device="cpu")


def assert_states_equal(a: SimState, b: SimState) -> None:
    for f in dataclasses.fields(SimState):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if torch.is_tensor(x):
            assert torch.equal(x, y), f.name
        else:
            assert x == y, f.name


def assert_results_equal(a, b) -> None:
    assert_states_equal(a.state, b.state)
    assert torch.equal(a.wstate.issued, b.wstate.issued)
    assert torch.equal(a.wstate.done_base, b.wstate.done_base)
    assert a.trace.keys() == b.trace.keys()
    for k, v in a.trace.items():
        if k == "timeline":
            assert v.keys() == b.trace[k].keys()
            for tk, tv in v.items():
                assert torch.equal(tv, b.trace[k][tk]), tk
        else:
            assert torch.equal(v, b.trace[k]), k
    for x, y in zip(a.hist, b.hist):
        assert torch.equal(x, y)
    assert len(a.decisions) == len(b.decisions)
    for r, s in zip(a.decisions, b.decisions):
        assert torch.equal(r.oscs, s.oscs) and torch.equal(r.ops, s.ops)
        assert torch.equal(r.decisions.theta, s.decisions.theta)
        assert torch.equal(r.decisions.probs, s.decisions.probs)


def test_fleet_mesh_counts_and_refusals():
    assert FLEET_AXIS == "fleet"
    assert MESH3 == (torch.device("cpu"),) * 3
    assert fleet_mesh(2, devices=["cpu", "cpu", "cpu"]) == MESH3[:2]
    with pytest.raises(ValueError, match="no devices"):
        fleet_mesh(devices=[])
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        for make in (fleet_mesh, make_fleet_mesh):
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
    else:
        assert len(fleet_mesh()) == n == len(make_fleet_mesh())
        assert fleet_mesh(1) == (torch.device("cuda", 0),)
        with pytest.raises(ValueError, match="visible"):
            fleet_mesh(n + 1)


def test_pad_unpad_identity():
    tree = {"a": np.arange(10).reshape(5, 2),
            "b": (torch.arange(5.0), torch.zeros(5, 3, dtype=torch.bool))}
    assert fleet_batch_size(tree) == 5
    padded, n_pad = pad_fleet(tree, 3)
    assert n_pad == 1 and fleet_batch_size(padded) == 6
    np.testing.assert_array_equal(padded["a"][5], tree["a"][0])
    assert torch.equal(padded["b"][0][5], tree["b"][0][0])
    back = unpad_fleet(padded, n_pad)
    np.testing.assert_array_equal(back["a"], tree["a"])
    assert torch.equal(back["b"][0], tree["b"][0])
    assert torch.equal(back["b"][1], tree["b"][1])
    same, none = pad_fleet(tree, 5)
    assert none == 0 and same is tree and unpad_fleet(tree, 0) is tree
    assert [s.tolist() for s in shard_elements(5, 3)] == \
        [[0, 1], [2, 3], [4, 0]]
    assert [s.tolist() for s in shard_elements(1, 3)] == [[0], [0], [0]]
    with pytest.raises(ValueError, match="empty"):
        fleet_batch_size({})


def _five():
    return stack_scenarios([build(get_scenario(n)) for n in FIVE],
                           device="cpu")


@pytest.mark.parametrize("mode", ["tuned", "traced", "intervened"])
def test_run_batch_mesh_bit_equal(model, mode):
    """A padded 3-device mesh gives the unsharded run bit for bit."""
    trace = intervene = None
    if mode == "traced":
        trace = TraceConfig(stride=25)
    if mode == "intervened":
        b, n = len(FIVE), _five().n_osc
        intervene = Intervention(
            pin_mask=np.zeros((b, n), bool),
            pin_theta=np.zeros((b, n, 2), np.int64),
            force_gates=np.zeros((b, n), bool),
            freeze=np.zeros((b, n), bool))
        intervene.pin_mask[1] = True
        intervene.pin_theta[1] = (1024, 32)
        intervene.force_gates[2] = True
        intervene.freeze[4] = True
    runs = []
    for mesh in (None, MESH3):
        batch = _five()
        res = run_batch(batch, model, seconds=2.0, fused=True, mesh=mesh,
                        trace=trace, intervene=intervene)
        runs.append((batch, res))
    (b1, r1), (b2, r2) = runs
    assert_results_equal(r1, r2)
    assert_states_equal(b1.state, b2.state)
    np.testing.assert_array_equal(b1.throughput(2.0)["total_mbs"],
                                  b2.throughput(2.0)["total_mbs"])
    assert sum(len(r) for r in r1.decisions) > 0
    if mode == "traced":
        assert "timeline" in r2.trace and "vol_r" in r2.trace
    if mode == "intervened":
        assert (b2.stacked("window_pages")[1] == 1024).all()


def test_tune_cols_and_untuned_elements_under_mesh(model):
    """Only element 3 tuned: the other elements (and the phantom) ride
    with their tune mask off, as unsharded."""
    runs = []
    for mesh in (None, MESH3):
        batch = _five()
        n = batch.n_osc
        cols = 3 * n + batch.element_cols(3)
        runs.append(run_batch(batch, model, seconds=2.0, fused=True,
                              mesh=mesh, tune_cols=cols,
                              trace=TraceConfig(timeline=False)))
    assert_results_equal(*runs)
    decided = runs[1].trace["decided"].reshape(4, len(FIVE), -1)
    assert not decided[:, [0, 1, 2, 4]].any()


def test_model_on_copies_once_per_version(model):
    """Forests are copied to a mesh device once per model version (here
    ``cpu:0``, a device name that differs from the model's ``cpu``)."""
    assert model_on(model, "cpu") is model
    copy = model_on(model, "cpu:0")
    assert copy is not model and copy is model_on(model, "cpu:0")
    assert torch.equal(copy.read_forest.leaf, model.read_forest.leaf)
    model.update_forests(read_forest=model.read_forest)
    assert model_on(model, "cpu:0") is not copy


def test_evaluate_mesh_bit_equal(model):
    names = ["failing_ost", "noisy_neighbor", "dlio_bert"]
    plain = evaluate(names, model, seconds=1.0, device="cpu")
    meshed = evaluate(names, model, seconds=1.0, mesh=MESH3, device="cpu")
    assert json.dumps(plain) == json.dumps(meshed)
    one = evaluate(["degraded_ost"], model, seconds=1.0, device="cpu")
    one_m = evaluate(["degraded_ost"], model, seconds=1.0,
                     mesh=fleet_mesh(devices=["cpu"] * 4), device="cpu")
    assert json.dumps(one) == json.dumps(one_m)


def test_sweep_and_diagnose_mesh_bit_equal(model):
    cfg = dataclasses.replace(F.SMOKE, n_scenarios=6, seconds=1.0)
    plain = F.run_sweep(cfg, model, diagnose=True, device="cpu")
    meshed = F.run_sweep(cfg, model, mesh=MESH3, diagnose=True,
                         device="cpu")
    assert json.dumps(plain, sort_keys=True) == json.dumps(meshed,
                                                           sort_keys=True)
    specs = F.generate_specs(cfg)[:3]
    dcfg = D.DiagnoseConfig(seconds=1.0)
    pairs = [(s, None) for s in specs]
    a = D.diagnose_many(pairs, model, dcfg, device="cpu")
    b = D.diagnose_many(pairs, model, dcfg, mesh=MESH3, device="cpu")
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_run_fleet_sharded_bit_equal(model):
    loops = loop_cache_stats()["misses"]
    fused = run_fleet(port_sim("mixed"), model, seconds=3.0,
                      backend="torch-fused", device="cpu")
    sims, fleets = [], []
    for mesh in (MESH3, fleet_mesh(devices=["cpu"])):
        sim = port_sim("mixed")
        fleets.append(run_fleet(sim, model, seconds=3.0,
                                backend="torch-sharded", mesh=mesh,
                                device="cpu"))
        sims.append(sim)
    ref_sim = port_sim("mixed")
    run_fleet(ref_sim, model, seconds=3.0, backend="torch-fused",
              device="cpu")
    assert loop_cache_stats()["misses"] > loops     # the lab's loops
    assert sum(len(r) for r in fused.decisions) > 0
    for fleet, sim in zip(fleets, sims):
        assert fleet.loop is None
        assert len(fleet.decisions) == len(fused.decisions)
        for r, s in zip(fused.decisions, fleet.decisions):
            assert torch.equal(r.oscs, s.oscs)
            assert torch.equal(r.decisions.theta, s.decisions.theta)
        assert_states_equal(sim.state, ref_sim.state)
        # the agent continues on the host where the run stopped
        assert fleet._ticks == 6 and len(fleet._hist) == 2
    traced = run_fleet(port_sim("mixed"), model, seconds=2.0,
                       backend="torch-sharded", mesh=MESH3, device="cpu",
                       trace=TraceConfig(stride=50))
    assert traced.trace.n_intervals == 4


def test_mesh_refusals(model):
    batch = _five()
    with pytest.raises(ValueError, match="fused=True"):
        run_batch(batch, model, seconds=1.0, mesh=MESH3)
    with pytest.raises(ValueError, match="torch-sharded"):
        run_fleet(port_sim("mixed"), model, seconds=1.0, mesh=MESH3,
                  device="cpu")
    with pytest.raises(ValueError, match="torch-sharded"):
        run_fleet(port_sim("mixed"), model, seconds=1.0, mesh=MESH3,
                  backend="torch-fused", device="cpu")
    with pytest.raises(ValueError, match="fused=True"):
        evaluate(["failing_ost", "dlio_bert"], model, seconds=1.0,
                 fused=False, mesh=MESH3, device="cpu")
