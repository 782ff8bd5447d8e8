"""The port's CUDA kernels and device path, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports only torch, numpy and ``repro_torch`` (no JAX, no reference
package), so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the CPU:
``segment_sum`` bit for bit (and against ``np.bincount``), the forest
margins to 1e-5 (float32, another summation order), and the tuned
fleet's θ trajectory exactly, counters to 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.convert import model_from_numpy  # noqa: E402
from repro_torch.core.fleet import run_fleet  # noqa: E402
from repro_torch.core.metrics import feature_dim  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.gbdt_forest import ops  # noqa: E402
from repro_torch.kernels.gbdt_forest.kernel import forest_margin_cuda  # noqa: E402
from repro_torch.kernels.segment_reduce.ops import SegmentMap, segment_sum  # noqa: E402
from repro_torch.pfs import workloads as W  # noqa: E402
from repro_torch.pfs.engine import PFSSim  # noqa: E402
from repro_torch.pfs.state import READ, WRITE  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def random_forest(rng, n_features, n_trees, depth):
    """A dense forest with thresholds spread over the features' scales
    (some +inf pass-throughs) and leaves biased positive, so rows
    descend both ways and some probabilities clear τ."""
    n_internal = 2 ** depth - 1
    threshold = (rng.choice([-1.0, 1.0], (n_trees, n_internal))
                 * 10.0 ** rng.uniform(-1, 3, (n_trees, n_internal)))
    threshold[rng.random((n_trees, n_internal)) < 0.1] = np.inf
    return dict(
        feature=rng.integers(0, n_features, (n_trees, n_internal)),
        threshold=threshold.astype(np.float32),
        leaf=rng.normal(0.1, 0.5, (n_trees, 2 ** depth)).astype(np.float32),
        base_score=0.2, depth=depth, n_features=n_features)


@pytest.mark.parametrize("e,s", [(37, 4), (1024, 8), (8192, 32), (640, 8192),
                                 (5000, 33), (0, 5)])
def test_segment_sum_bit_equal_to_bincount(cuda, e, s):
    rng = np.random.default_rng(e + s)
    values = rng.standard_normal(e) * 10.0 ** rng.uniform(-3, 9, size=e)
    ids = rng.integers(0, s, size=e)
    smap = SegmentMap.build(ids, s, cuda)
    n0 = LAUNCHES["segment_sum"]
    got = segment_sum(torch.as_tensor(values, device=cuda), smap)
    assert LAUNCHES["segment_sum"] == n0 + 1
    want = np.bincount(ids, weights=values, minlength=s)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.int64),
                                  want.view(np.int64))


def test_segment_sum_drops_out_of_range_ids(cuda):
    ids = np.array([2, 0, 7, 2, -1, 1, 3])
    values = np.arange(1.0, 8.0)
    got = segment_sum(torch.as_tensor(values, device=cuda),
                      SegmentMap.build(ids, 4, cuda)).cpu().numpy()
    np.testing.assert_array_equal(got, [2.0, 6.0, 5.0, 7.0])


def test_segment_sum_checks_inputs(cuda):
    smap = SegmentMap.build([0, 1, 1], 2, cuda)
    with pytest.raises(ValueError, match="float64"):
        segment_sum(torch.ones(3, dtype=torch.float32, device=cuda), smap)
    with pytest.raises(ValueError, match="entries"):
        segment_sum(torch.ones(4, dtype=torch.float64, device=cuda), smap)
    with pytest.raises(ValueError, match="map on cpu"):
        segment_sum(torch.ones(3, dtype=torch.float64, device=cuda),
                    SegmentMap.build([0, 1, 1], 2, "cpu"))


@pytest.mark.parametrize("n", [1, 100, 4096])
def test_forest_kernels_match_plain(cuda, n):
    rng = np.random.default_rng(n)
    read = random_forest(rng, 32, 24, 5)
    write = random_forest(rng, 36, 17, 3)          # pairing pads depth/trees
    m_cpu = model_from_numpy(read, write, device="cpu")
    m_dev = model_from_numpy(read, write, device=cuda)
    feature, threshold, leaf, base, depth, n_features = ops.pair_forests(
        m_cpu.read_forest, m_cpu.write_forest)
    x = (rng.standard_normal((n, n_features))
         * 10.0 ** rng.uniform(-1, 3, n_features)).astype(np.float32)
    op = rng.integers(0, 2, size=n).astype(np.int32)
    arrays = (x, op, feature, threshold, leaf, base)
    plain = ops.paired_forest_margin(*map(torch.as_tensor, arrays), depth)
    n0 = LAUNCHES["paired_forest_margin"]
    got = ops.paired_forest_margin(
        *(torch.as_tensor(a, device=cuda) for a in arrays), depth)
    assert LAUNCHES["paired_forest_margin"] == n0 + 1
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), atol=1e-5)

    xr = torch.as_tensor(x[:, :32])
    n0 = LAUNCHES["forest_margin"]
    single = m_dev.read_forest.predict_margin(xr.to(cuda))
    assert LAUNCHES["forest_margin"] == n0 + 1
    np.testing.assert_allclose(single.cpu().numpy(),
                               m_cpu.read_forest.predict_margin(xr).numpy(),
                               atol=1e-5)
    p_r, p_w = m_dev.score_fleet(xr.to(cuda), torch.as_tensor(
        x[:, :36], device=cuda))
    q_r, q_w = m_cpu.score_fleet(xr, torch.as_tensor(x[:, :36]))
    np.testing.assert_allclose(p_r.cpu().numpy(), q_r.numpy(), atol=1e-6)
    np.testing.assert_allclose(p_w.cpu().numpy(), q_w.numpy(), atol=1e-6)


def test_forest_kernel_checks_inputs(cuda):
    f = model_from_numpy(random_forest(np.random.default_rng(0), 8, 4, 3),
                         random_forest(np.random.default_rng(1), 8, 4, 3),
                         device=cuda).read_forest
    args = (f.feature[None], f.threshold[None], f.leaf[None],
            torch.zeros(1, device=cuda), f.depth)
    with pytest.raises(ValueError, match="x must be a contiguous"):
        forest_margin_cuda(torch.zeros((8, 16), device=cuda).t(), None, *args)
    with pytest.raises(ValueError, match="op must be a contiguous"):
        forest_margin_cuda(torch.zeros((16, 8), device=cuda),
                           torch.zeros(16, dtype=torch.int64, device=cuda),
                           *args)


def _fleet_sim(device):
    sim = PFSSim(8, 4, device=device)
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


def test_fleet_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(7)
    forests = [random_forest(rng, feature_dim(op), 20, 4)
               for op in (READ, WRITE)]
    runs = {}
    for dev in ("cpu", cuda):
        sim = _fleet_sim(dev)
        LAUNCHES.clear()
        fleet = run_fleet(sim, model_from_numpy(*forests, device=dev),
                          seconds=4.0, interval=0.5, device=dev)
        runs[str(dev)] = (sim, fleet, dict(LAUNCHES))
    (sim_c, fleet_c, launches_c), (sim_d, fleet_d, launches_d) = \
        runs["cpu"], runs[str(cuda)]
    traj = lambda fl: [(r.oscs.tolist(), r.ops.tolist(),
                        r.decisions.theta.tolist(),
                        r.decisions.changed.tolist()) for r in fl.decisions]
    assert traj(fleet_d) == traj(fleet_c)
    assert any(r.decisions.changed.any() for r in fleet_d.decisions)
    assert launches_c == {}
    assert launches_d["segment_sum"] > 0
    assert launches_d["paired_forest_margin"] > 0
    for f in ("ctr_bytes_done", "ctr_rpcs_sent", "ctr_latency_sum",
              "ctr_req_bytes", "ctr_pending_integral", "dirty_bytes"):
        a = getattr(sim_c.state, f).numpy()
        b = getattr(sim_d.state, f).cpu().numpy()
        assert np.max(np.abs(a - b) / np.maximum(np.abs(a), 1.0)) <= 1e-6, f
