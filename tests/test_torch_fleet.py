"""The port's tuned fleet (probe -> metrics -> scoring -> Algorithm 1 ->
knob write-back) against the reference's ``run_fleet``.

The reference runs its numpy tick loop with the model on its numpy
backend (float64 forests) and on its pallas backend (float32, the
kernel in interpret mode); the port runs ``run_fleet(backend="torch")``
on the CPU.  θ trajectories must be identical, and Algorithm 1 must
agree to 1e-12 relative on adversarial rows with τ strict.
"""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import metrics as ref_metrics  # noqa: E402
from repro.core.config_space import SPACE  # noqa: E402
from repro.core.fleet import run_fleet as ref_run_fleet  # noqa: E402
from repro.core.gbdt import GBDTClassifier, GBDTParams  # noqa: E402
from repro.core.metrics import feature_dim  # noqa: E402
from repro.core.model import DIALModel as RefModel  # noqa: E402
from repro.core.tuner import (TunerParams, conditional_score_greedy,  # noqa: E402
                              conditional_score_greedy_batch as ref_batch)
from repro.pfs import PFSSim as RefSim  # noqa: E402
from repro.pfs import workloads as RW  # noqa: E402
from repro.pfs.engine import READ, WRITE  # noqa: E402
from repro.pfs.stats import probe_all as ref_probe_all  # noqa: E402
from repro_torch.convert import model_from_numpy  # noqa: E402
from repro_torch.core import metrics  # noqa: E402
from repro_torch.core.fleet import FleetAgent, SimFleetPort, run_fleet  # noqa: E402
from repro_torch.core.tuner import conditional_score_greedy_batch  # noqa: E402
from repro_torch.pfs import workloads as TW  # noqa: E402
from repro_torch.pfs.engine import PFSSim  # noqa: E402
from repro_torch.pfs.stats import FleetStats  # noqa: E402

FOREST_FIELDS = ("feature", "threshold", "leaf", "base_score", "depth",
                 "n_features")


@pytest.fixture(scope="module")
def ref_model():
    """Small forests fitted on seeded data (mostly-positive labels, so the
    tuner clears τ and moves θ)."""
    rng = np.random.default_rng(0)

    def forest(dim):
        x = rng.normal(size=(400, dim)).astype(np.float32)
        y = (x[:, 0] + x[:, -1] > -1.0).astype(float)
        return GBDTClassifier(GBDTParams(n_trees=8, max_depth=3)).fit(
            x, y).forest

    return RefModel(read_forest=forest(feature_dim(READ)),
                    write_forest=forest(feature_dim(WRITE)))


def port_model(ref_model, device="cpu"):
    fields = lambda f: {k: getattr(f, k) for k in FOREST_FIELDS}
    return model_from_numpy(fields(ref_model.read_forest),
                            fields(ref_model.write_forest), device=device)


def build(W, sim):
    """8 clients x 4 OSTs cycling VPIC / BDCATS / DLIO / random writers,
    knobs started small so the tuner has room to move."""
    for c in range(8):
        if c % 4 == 0:
            sim.attach(W.vpic_write(c, dims=1 + c % 3))
        elif c % 4 == 1:
            sim.attach(W.bdcats_read(c, "strided"))
        elif c % 4 == 2:
            sim.attach(W.dlio_reader(c, "bert", n_threads=4, osts=(c % 4,)))
        else:
            sim.attach(W.random_stream(c, WRITE, 256 * 1024, ost=c % 4,
                                       n_threads=2))
    sim.set_knobs(np.arange(sim.n_osc), window_pages=64, rpcs_in_flight=2)
    return sim


def trajectory(fleet):
    return [(r.oscs.tolist(), r.ops.tolist(), r.decisions.theta.tolist(),
             r.decisions.changed.tolist()) for r in fleet.decisions]


@pytest.fixture(scope="module")
def port_run(ref_model):
    sim = build(TW, PFSSim(8, 4, device="cpu"))
    fleet = run_fleet(sim, port_model(ref_model), seconds=4.0, interval=0.5,
                      device="cpu")
    return sim, fleet


@pytest.mark.parametrize("backend", ["numpy", "pallas"])
def test_run_fleet_matches_reference(ref_model, port_run, backend):
    model = copy.copy(ref_model)
    model.backend = backend
    model.__post_init__()
    ref_sim = build(RW, RefSim(n_clients=8, n_osts=4, seed=0))
    ref_fleet = ref_run_fleet(ref_sim, model, seconds=4.0, interval=0.5,
                              backend="numpy")
    sim, fleet = port_run
    assert len(fleet.decisions) == len(ref_fleet.decisions) == 8
    assert trajectory(fleet) == trajectory(ref_fleet)
    assert any(r.decisions.changed.any() for r in fleet.decisions)
    np.testing.assert_array_equal(sim.window_pages.numpy(),
                                  ref_sim.window_pages)
    np.testing.assert_array_equal(sim.rpcs_in_flight.numpy(),
                                  ref_sim.rpcs_in_flight)
    for f in ("ctr_bytes_done", "ctr_rpcs_sent", "ctr_latency_sum",
              "ctr_req_bytes", "ctr_pending_integral", "ctr_dirty_integral"):
        a = np.asarray(getattr(ref_sim.state, f))
        b = getattr(sim.state, f).numpy()
        assert np.max(np.abs(a - b) / np.maximum(np.abs(a), 1.0)) <= 1e-6, f
    for mine, ref in zip(fleet.decisions, ref_fleet.decisions):
        np.testing.assert_allclose(mine.decisions.probs.numpy(),
                                   ref.decisions.probs, atol=1e-5)
    np.testing.assert_allclose(sim.issued, [w._issued for w in
                                            ref_sim._workloads],
                               rtol=1e-9, atol=1e-3)


def test_metrics_match_reference_bitwise():
    """Same probes in, same designed metrics and float32 features out."""
    ref = build(RW, RefSim(n_clients=8, n_osts=4, seed=0))
    before = ref_probe_all(ref)
    ref.run(0.5)
    after = ref_probe_all(ref)
    ref_snap = ref_metrics.snapshot_all(before, after)

    def port_stats(stats):
        return FleetStats(**{f.name: getattr(stats, f.name) if f.name == "t"
                             else torch.as_tensor(getattr(stats, f.name))
                             for f in dataclasses.fields(FleetStats)})

    snap = metrics.snapshot_all(port_stats(before), port_stats(after))
    assert snap.dt == ref_snap.dt
    np.testing.assert_array_equal(snap.read.numpy(), ref_snap.read)
    np.testing.assert_array_equal(snap.write.numpy(), ref_snap.write)
    np.testing.assert_array_equal(snap.read_volume.numpy(),
                                  ref_snap.read_volume)
    theta = torch.as_tensor(SPACE.as_features())
    rows = np.array([0, 3, 5, 6, 30])
    for op in (READ, WRITE):
        got = metrics.fleet_feature_matrix([snap, snap], op,
                                           torch.as_tensor(rows), theta)
        want = ref_metrics.fleet_feature_matrix([ref_snap, ref_snap], op,
                                                rows, SPACE.as_features())
        assert got.dtype == torch.float32
        assert tuple(got.shape) == want.shape == (
            len(rows) * len(SPACE), feature_dim(op))
        np.testing.assert_array_equal(got.numpy(), want)


def _adversarial_rows():
    m = len(SPACE)
    tau = TunerParams().tau
    rows = [np.full(m, tau), np.full(m, 0.95), np.full(m, 0.5),
            np.full(m, 0.81)]
    r = np.zeros(m)
    r[7] = 0.9                                # single survivor
    rows.append(r)
    r = np.zeros(m)
    r[[3, 17]] = 0.9                          # exact tie, first-max break
    rows.append(r)
    r = np.full(m, tau)
    r[::2] = np.nextafter(tau, 1.0)           # straddling τ by 1 ulp
    rows.append(r)
    r = np.zeros(m)
    r[-1] = np.nextafter(tau, 1.0)            # lone marginal survivor
    rows.append(r)
    rng = np.random.default_rng(0)
    rows += [rng.uniform(0.0, 1.0, size=m) for _ in range(6)]
    return np.stack(rows)


@pytest.mark.parametrize("op", [READ, WRITE])
def test_alg1_agrees_on_adversarial_rows(op):
    probs = _adversarial_rows()
    configs = SPACE.configs()
    current = np.asarray([configs[(3 * i) % len(configs)]
                          for i in range(len(probs))])
    ops = np.full(len(probs), op)
    ref = ref_batch(probs, ops, current)
    got = conditional_score_greedy_batch(torch.as_tensor(probs),
                                         torch.as_tensor(ops),
                                         torch.as_tensor(current))
    np.testing.assert_array_equal(got.theta.numpy(), ref.theta)
    np.testing.assert_array_equal(got.changed.numpy(), ref.changed)
    np.testing.assert_array_equal(got.n_candidates.numpy(), ref.n_candidates)
    np.testing.assert_allclose(got.score.numpy(), ref.score, rtol=1e-12)
    for i, row in enumerate(probs):
        scalar = conditional_score_greedy(row, op, tuple(current[i]))
        assert tuple(got.theta[i].tolist()) == scalar.theta
        assert bool(got.changed[i]) == scalar.changed
        assert int(got.n_candidates[i]) == scalar.n_candidates
        np.testing.assert_allclose(float(got.score[i]), scalar.score,
                                   rtol=1e-12)


def test_alg1_tau_is_strict_and_keeps_current():
    probs = torch.full((1, len(SPACE)), TunerParams().tau, dtype=torch.float64)
    for op in (READ, WRITE):
        d = conditional_score_greedy_batch(probs, torch.tensor([op]),
                                           torch.tensor([[64, 4]]))
        assert d.theta.tolist() == [[64, 4]]
        assert not bool(d.changed[0]) and int(d.n_candidates[0]) == 0


def test_agent_refuses_mixed_devices(ref_model):
    sim = build(TW, PFSSim(8, 4, device="cpu"))
    with pytest.raises(ValueError, match="unknown engine backend"):
        run_fleet(sim, port_model(ref_model), backend="numpy", device="cpu")
    fleet = FleetAgent(SimFleetPort(sim, torch.tensor([1, 5])),
                       port_model(ref_model), device="cpu")
    assert fleet.n == 2 and len(fleet.tick()) == 0
