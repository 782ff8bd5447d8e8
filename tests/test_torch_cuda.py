"""The port's CUDA kernels and device path, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports only torch, numpy and ``repro_torch`` (no JAX, no reference
package), so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the CPU:
``segment_sum`` bit for bit (and against ``np.bincount``, several columns
in one launch too), the forest
margins to 1e-5 (float32, another summation order; at the edges of the
row tile and the shared-memory layout, mixed ops, depths 1 to 8, one
tree, and the widest rows it takes), ``tree_histogram``
bit for bit in float64 and within 1e-6 of the largest |cell| in float32
(two launches bit-equal in both), the tuned fleet's θ trajectory
exactly, counters to 1e-6, and an exact GBDT fit on the card equal to
the CPU fit (features equal, thresholds and leaves within 1e-5).
The serving slice's kernels are held against their plain versions at
smoke and full-width layer shapes (attention: float32 2e-5, bf16 3e-2,
the decode form on a strided cache view included; the scans 1e-4), two
launches bit-equal, and the smoke configs' greedy tokens on the card
equal the CPU's (float32 weights; logits within 1e-4).  The attention
forms are each held at their edges (bf16 also row by row, within 5% of
each row's RMS): the split-KV decode at split boundaries and GQA groups
of 1, 2 and 16, the bf16 tensor-core prefill at every head dim with
ragged, end-aligned and key-less rows; the
histogram's chunk ring with segments across chunks, more than 32 cells
and empty bins; the RG-LRU scan off its 32-step stage and 64-channel
tile, with gates of 0 and 1 and rows staged without bulk copies; the
selective scan at one step, off its 32-step chunk
and 128-channel block, at every N.  The fused tuning loop replayed as
a CUDA graph is held bit for bit against the same interval run eagerly
on the card (8 x 4, and 32 x 8 with k = 2 and a disturbed schedule),
against the CPU's plain versions (θ exact, counters to 1e-6), and its
replayed run and eager interval make no host sync.  The Scenario Lab's
ragged bucket of three catalog scenarios (one block-diagonal fleet) is
held the same way: replayed == eager bit for bit (a rebuilt batch
replays without a new capture; one tuned element of three too), card ==
CPU on the fused and the host paths, no host sync in a replayed run,
and both kernels at the fleet's maps and rows equal to their plain
versions.  Tracing (``repro_torch.obs``): a traced replayed interval
bit-equal to the traced eager one and within 1e-6 of the CPU's (θ
exact), traced == untraced θ and state bit for bit on the fused and the
host loops, no host sync in a traced replay or in the host tracer's
samples, the timeline tap's ``(5, E)`` segment sum bit-equal to
``np.bincount``, and the diagnosis's 4-arm intervened, traced bucket on
the card equal to the CPU's.  The rest of DIAL's side: ``run_continual``
on the card equal to the CPU (the frozen arm whole, the online arm
through its first refit), a 1-device fleet mesh bit-equal to the
unsharded run (and, on a host with several cards, a mesh over all of
them), and a measured fleet tick synchronizing at its stage boundaries
while an unmeasured one calls no synchronize.  The paper's experiments:
one Table II workload's static and DIAL arms replayed on the card equal
to the CPU with the card's congestion ``pow``, bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.convert import model_from_numpy  # noqa: E402
from repro_torch.core.fleet import run_fleet  # noqa: E402
from repro_torch.core.gbdt import GBDTParams  # noqa: E402
from repro_torch.core.metrics import feature_dim  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.gbdt_forest import ops  # noqa: E402
from repro_torch.kernels.gbdt_forest.kernel import forest_margin_cuda  # noqa: E402
from repro_torch.kernels.segment_reduce.ops import SegmentMap, segment_sum  # noqa: E402
from repro_torch.kernels.tree_histogram.kernel import tree_histogram_cuda  # noqa: E402
from repro_torch.kernels.tree_histogram.ops import BinIndex, tree_histogram  # noqa: E402
from repro_torch.configs import ARCHS, get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.flash_attention.ops import attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.mamba_scan.kernel import selective_scan_cuda  # noqa: E402
from repro_torch.kernels.mamba_scan.ops import selective_scan  # noqa: E402
from repro_torch.kernels.rglru_scan.ops import rglru  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_ref  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.learn.boost import fit_forest  # noqa: E402
from repro_torch.models import lm  # noqa: E402
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


@pytest.mark.parametrize("e,s,k", [(37, 4, 1), (8192, 32, 2), (640, 8192, 8),
                                   (5000, 4, 3), (5000, 33, 11), (300, 6, 11),
                                   (0, 5, 3)])
def test_segment_sum_multi_column_one_launch(cuda, e, s, k):
    """(K, E) values: one launch, each column bit-equal to np.bincount
    (segments longer than a chunk, more columns than a warp folds, ids
    out of range, no entries), two launches bit-equal."""
    rng = np.random.default_rng(e + s + k)
    ids = rng.integers(-2, s + 3, size=e)
    values = rng.standard_normal((k, e)) * 10.0 ** rng.uniform(-3, 9, (k, e))
    smap = SegmentMap.build(ids, s, cuda)
    v = torch.as_tensor(values, device=cuda)
    n0 = LAUNCHES["segment_sum"]
    got = segment_sum(v, smap)
    assert LAUNCHES["segment_sum"] == n0 + 1
    assert got.shape == (k, s)
    assert torch.equal(got, segment_sum(v, smap))
    keep = (ids >= 0) & (ids < s)
    for col in range(k):
        want = np.bincount(ids[keep], weights=values[col][keep], minlength=s)
        np.testing.assert_array_equal(got[col].cpu().numpy().view(np.int64),
                                      want.view(np.int64))


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


@pytest.mark.parametrize("n,order,depths,n_trees", [
    (1, "mixed", (5, 5), 24), (31, "mixed", (5, 3), 17),
    (700, "sorted", (5, 5), 160), (1500, "mixed", (1, 1), 1),
    (2000, "sorted", (1, 8), 3), (513, "sorted", (8, 8), 9)])
def test_forest_kernel_tile_and_forest_edges(cuda, n, order, depths, n_trees):
    """Rows below one tile and off it, blocks whose rows mix op 0 and 1
    (random ops, or read rows then write rows with the boundary inside a
    block), depth 1, a pair padded to depth 8, one tree: the paired and
    single forms within 1e-5 of the CPU plain version, two launches
    bit-equal."""
    rng = np.random.default_rng(n + n_trees)
    m = model_from_numpy(random_forest(rng, 32, n_trees, depths[0]),
                         random_forest(rng, 36, n_trees, depths[1]),
                         device="cpu")
    feature, threshold, leaf, base, depth, n_features = ops.pair_forests(
        m.read_forest, m.write_forest)
    x = (rng.standard_normal((n, n_features))
         * 10.0 ** rng.uniform(-1, 3, n_features)).astype(np.float32)
    op = (rng.integers(0, 2, size=n) if order == "mixed"
          else np.arange(n) >= n * 3 // 7).astype(np.int32)
    cpu = [torch.as_tensor(a) for a in (x, op, feature, threshold, leaf,
                                        base)]
    card = [t.to(cuda) for t in cpu]
    got = forest_margin_cuda(*card, depth)
    assert torch.equal(got, forest_margin_cuda(*card, depth))
    want = ops.paired_forest_margin(*cpu, depth)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5)
    one = lambda ts: [t[:1].contiguous() for t in ts]  # noqa: E731
    got = forest_margin_cuda(card[0], None, *one(card[2:]), depth)
    assert torch.equal(got, forest_margin_cuda(card[0], None, *one(card[2:]),
                                               depth))
    want = ops.paired_forest_margin(cpu[0], None, *one(cpu[2:]), depth)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5)


def test_forest_kernel_widest_rows(cuda):
    """The widest rows the shared-memory layout takes beside a 160-tree,
    depth-5 pair (32-row tiles) match the plain version; one feature
    more raises."""
    from repro_torch.kernels.gbdt_forest.kernel import (SMEM_LIMIT,
                                                        forest_layout)
    forests = 2 * 160 * ((2 ** 5 - 1) * 8 + 2 ** 5 * 4)
    widest = (SMEM_LIMIT - forests) // (32 * 4)
    assert forest_layout(2, 160, 5, widest) == (32, forests + widest * 128)
    rng = np.random.default_rng(11)
    m = model_from_numpy(random_forest(rng, widest, 160, 5),
                         random_forest(rng, widest, 160, 5), device="cpu")
    feature, threshold, leaf, base, depth, _ = ops.pair_forests(
        m.read_forest, m.write_forest)
    x = rng.standard_normal((300, widest + 1)).astype(np.float32) * 100.0
    op = rng.integers(0, 2, size=300).astype(np.int32)
    cpu = [torch.as_tensor(a) for a in (x[:, :widest].copy(), op, feature,
                                        threshold, leaf, base)]
    got = forest_margin_cuda(*(t.to(cuda) for t in cpu), depth)
    want = ops.paired_forest_margin(*cpu, depth)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="shared memory"):
        forest_margin_cuda(torch.as_tensor(x, device=cuda),
                           *(t.to(cuda) for t in cpu[1:]), depth)


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


def _histogram_inputs(rng, b, n, f, n_bins, n_nodes, dtype):
    values = rng.normal(size=(b, 2, n)) * 10.0 ** rng.uniform(-3, 3, (b, 1, n))
    # skewed codes: many samples share the low bins, as knob columns do
    bins = np.minimum(rng.geometric(0.15, size=(b, n, f)) - 1, n_bins - 1)
    node = rng.integers(0, n_nodes + 1, size=(b, n))   # n_nodes = drop id
    return (torch.as_tensor(values, dtype=dtype),
            torch.as_tensor(bins, dtype=torch.int32),
            torch.as_tensor(node, dtype=torch.int32))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n_nodes", [1, 2, 8, 20])
def test_tree_histogram_kernel_matches_plain(cuda, dtype, n_nodes):
    rng = np.random.default_rng(n_nodes)
    values, bins, node = _histogram_inputs(rng, 2, 6000, 36, 48, n_nodes,
                                           dtype)
    plain = tree_histogram(values, BinIndex.build(bins, 48), node, n_nodes)
    index = BinIndex.build(bins.to(cuda), 48)
    n0 = LAUNCHES["tree_histogram"]
    first = tree_histogram(values.to(cuda), index, node.to(cuda), n_nodes)
    again = tree_histogram(values.to(cuda), index, node.to(cuda), n_nodes)
    assert LAUNCHES["tree_histogram"] == n0 + 2
    assert torch.equal(first, again)                  # deterministic bits
    got = first.cpu()
    if dtype == torch.float64:
        np.testing.assert_array_equal(got.numpy().view(np.int64),
                                      plain.numpy().view(np.int64))
    else:
        scale = float(plain.abs().max())
        assert float((got - plain).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tree_histogram_kernel_skips_unwalked_features(cuda, dtype):
    """Features outside ``walk`` have empty segments on the card and
    zero cells, as in the plain version."""
    values, bins, node = _histogram_inputs(np.random.default_rng(7), 2,
                                           6000, 36, 48, 8, dtype)
    walk = torch.rand((2, 36), generator=torch.Generator().manual_seed(7)) \
        < 0.5
    plain = tree_histogram(values, BinIndex.build(bins, 48, walk), node, 8)
    got = tree_histogram(values.to(cuda),
                         BinIndex.build(bins.to(cuda), 48, walk.to(cuda)),
                         node.to(cuda), 8).cpu()
    for b in range(2):
        assert not got[b][:, :, ~walk[b]].any()
    if dtype == torch.float64:
        np.testing.assert_array_equal(got.numpy().view(np.int64),
                                      plain.numpy().view(np.int64))
    else:
        scale = float(plain.abs().max())
        assert float((got - plain).abs().max()) <= 1e-6 * scale


def test_tree_histogram_kernel_checks_inputs(cuda):
    values, bins, node = _histogram_inputs(np.random.default_rng(0), 1, 64,
                                           3, 8, 2, torch.float64)
    index = BinIndex.build(bins.to(cuda), 8)
    v, nd = values.to(cuda), node.to(cuda)
    with pytest.raises(ValueError, match="float64 or float32"):
        tree_histogram_cuda(v.half(), index.perm, index.bnd, nd, 2)
    with pytest.raises(ValueError, match="node must be a contiguous"):
        tree_histogram_cuda(v, index.perm, index.bnd, nd.long(), 2)
    with pytest.raises(ValueError, match="channels"):
        tree_histogram_cuda(v.repeat(1, 3, 1), index.perm, index.bnd, nd, 2)
    with pytest.raises(ValueError, match="values must be"):
        tree_histogram_cuda(v[0], index.perm, index.bnd, nd, 2)


def _chunked_inputs(rng, n, f, n_bins, n_nodes, channels, dtype):
    """Codes that leave every odd bin empty and put most samples of the
    first feature in one bin, so segments start off the 16-byte grid and
    cross the kernel's 256-sample chunks; node ids past n_nodes dropped."""
    values = rng.normal(size=(1, channels, n)) * 10.0 ** rng.uniform(
        -3, 3, (1, 1, n))
    bins = 2 * rng.integers(0, n_bins // 2, size=(1, n, f))
    bins[0, :, 0] = np.where(rng.random(n) < 0.9, 4, bins[0, :, 0])
    node = rng.integers(-1, n_nodes + 2, size=(1, n))
    return (torch.as_tensor(values, dtype=dtype),
            torch.as_tensor(bins, dtype=torch.int32),
            torch.as_tensor(node, dtype=torch.int32))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,n_nodes,channels", [
    (1000, 1, 1), (5003, 20, 2), (777, 9, 4), (300, 33, 1), (129, 3, 3)])
def test_tree_histogram_kernel_chunks_groups_and_empty_segments(
        cuda, dtype, n, n_nodes, channels):
    """Segments crossing chunk boundaries, n_nodes x C over 32 (more
    than one block per segment) and empty segments: float64 bit-equal to
    the plain version, float32 within 1e-6 of the largest |cell|, two
    launches bit-equal."""
    values, bins, node = _chunked_inputs(np.random.default_rng(n), n, 5, 16,
                                         n_nodes, channels, dtype)
    plain = tree_histogram(values, BinIndex.build(bins, 16), node, n_nodes)
    index = BinIndex.build(bins.to(cuda), 16)
    first = tree_histogram(values.to(cuda), index, node.to(cuda), n_nodes)
    again = tree_histogram(values.to(cuda), index, node.to(cuda), n_nodes)
    assert torch.equal(first, again)
    got = first.cpu()
    assert not got[..., 1::2].any()                   # the empty bins
    if dtype == torch.float64:
        np.testing.assert_array_equal(got.numpy().view(np.int64),
                                      plain.numpy().view(np.int64))
    else:
        scale = float(plain.abs().max())
        assert float((got - plain).abs().max()) <= 1e-6 * scale


def test_exact_fit_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2500, 10))
    y = ((X[:, 0] > 0.3) & (X[:, 1] < 0.5) | (X[:, 2] * X[:, 3] > 1.0)
         ).astype(float)
    p = GBDTParams(n_trees=25, max_depth=5)
    cpu = fit_forest(X, y, p, device="cpu")
    LAUNCHES.clear()
    dev = fit_forest(X, y, p, device=cuda)
    assert LAUNCHES["tree_histogram"] == 25 * 5
    np.testing.assert_array_equal(dev.feature.cpu().numpy(),
                                  cpu.feature.numpy())
    a, b = dev.threshold.cpu().numpy(), cpu.threshold.numpy()
    with np.errstate(invalid="ignore"):      # inf - inf
        assert ((np.abs(a - b) <= 1e-5) | (np.isinf(a) & np.isinf(b))).all()
    np.testing.assert_allclose(dev.leaf.cpu().numpy(), cpu.leaf.numpy(),
                               atol=1e-5)
    assert dev.base_score == cpu.base_score


def test_gain_rounding_on_card_matches_numpy(cuda):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(10 ** 6) * 10.0 ** rng.uniform(-3, 4, 10 ** 6)
    got = torch.round(torch.as_tensor(x, device=cuda), decimals=9)
    np.testing.assert_array_equal(got.cpu().numpy(), np.round(x, 9))


# ---------------------------------------------------------------------- #
# the serving slice
# ---------------------------------------------------------------------- #
ATTENTION = {
    # tests/test_kernels.py:44-53
    "mha": dict(b=1, hq=4, hkv=4, sq=64, skv=64, d=32),
    "gqa": dict(b=2, hq=8, hkv=2, sq=64, skv=64, d=32),
    "mqa_pad": dict(b=1, hq=4, hkv=1, sq=48, skv=48, d=64),
    "window": dict(b=1, hq=4, hkv=2, sq=64, skv=64, d=32, window=16),
    "softcap": dict(b=1, hq=4, hkv=4, sq=64, skv=64, d=32, softcap=50.0),
    "decode": dict(b=1, hq=4, hkv=2, sq=1, skv=100, d=32),
    "window_offset": dict(b=1, hq=2, hkv=2, sq=40, skv=104, d=64, window=32),
    "noncausal": dict(b=1, hq=2, hkv=2, sq=64, skv=64, d=32, causal=False),
    # smoke configs (D = 16) and one full-width layer of each family
    "gemma2_smoke": dict(b=2, hq=4, hkv=2, sq=37, skv=37, d=16, window=16,
                         softcap=50.0),
    "recurrentgemma_full": dict(b=1, hq=16, hkv=1, sq=3072, skv=3072,
                                d=256, window=2048),
    "gemma2_full_local": dict(b=1, hq=8, hkv=4, sq=3072, skv=3072, d=256,
                              window=4096, softcap=50.0),
    "gemma2_full_global": dict(b=1, hq=8, hkv=4, sq=3072, skv=3072, d=256,
                               softcap=50.0),
    # D = 8 (starcoder2 and llava smoke; bf16 through the D = 16 form on
    # zero-padded columns), D = 160 (stablelm-12b at full width), GQA
    # groups of 12 (starcoder2-15b) and 7 (llava-next-34b over its 2,880
    # image positions and 3,072 tokens) at full width, MHA at D = 128
    # (qwen1.5-32b) and D = 64 (musicgen-large)
    "starcoder2_smoke": dict(b=2, hq=8, hkv=2, sq=37, skv=37, d=8),
    "stablelm_full": dict(b=1, hq=32, hkv=8, sq=3072, skv=3072, d=160),
    "starcoder2_full": dict(b=1, hq=48, hkv=4, sq=3072, skv=3072, d=128),
    "llava_full": dict(b=1, hq=56, hkv=8, sq=5952, skv=5952, d=128),
    "qwen1_5_mha": dict(b=1, hq=40, hkv=40, sq=300, skv=300, d=128),
    "musicgen_mha": dict(b=1, hq=32, hkv=32, sq=300, skv=300, d=64),
}


# bf16 attention, besides atol 3e-2: each output row's max |kernel - plain|
# within this share of the row's RMS (as chip_smoke.py), which a dropped
# or doubled key split or tile exceeds
BF16_ROW_REL = 5e-2


def _row_rel(got, want):
    """max over output rows of max |got - want| / RMS of the want row (a
    row where want is 0 must be 0)."""
    err = (got.float() - want.float()).abs().amax(-1)
    rms = want.float().square().mean(-1).sqrt()
    return float(torch.where(err > 0, err / rms, 0.0).max())


def _attention_inputs(case, dtype, device, seed=0):
    c = dict(case)
    shape_q = (c.pop("b"), c.pop("hq"), c.pop("sq"), c["d"])
    shape_k = (shape_q[0], c.pop("hkv"), c.pop("skv"), c.pop("d"))
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(s, generator=g).to(dtype).to(device)
               for s in (shape_q, shape_k, shape_k))
    return q, k, v, c


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("name", sorted(ATTENTION))
def test_flash_attention_kernel_matches_plain(cuda, name, dtype, tol):
    q, k, v, opts = _attention_inputs(ATTENTION[name], dtype, cuda)
    n0 = LAUNCHES["flash_attention"]
    got = attention(q, k, v, **opts)
    again = attention(q, k, v, **opts)
    assert LAUNCHES["flash_attention"] == n0 + 2
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, again)
    want = attention_ref(q, k, v, **opts)
    assert float((got.float() - want).abs().max()) < tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("hq,hkv,d,window,softcap", [
    (4, 2, 16, 16, 50.0), (16, 1, 256, 2048, 0.0), (8, 4, 256, 0, 50.0),
    (32, 8, 160, 0, 0.0), (8, 2, 8, 0, 0.0)])
def test_flash_attention_decode_on_a_cache_view(cuda, dtype, tol, hq, hkv, d,
                                                window, softcap):
    """Sq = 1 on the live slice of a (B, Hkv, Smax, D) cache, as
    ``attention_decode`` passes it, against the plain version on a
    contiguous copy."""
    g = torch.Generator().manual_seed(d)
    cache_k = torch.randn((2, hkv, 3104, d), generator=g).to(dtype).to(cuda)
    cache_v = torch.randn((2, hkv, 3104, d), generator=g).to(dtype).to(cuda)
    q = torch.randn((2, 1, hq, d), generator=g).to(dtype).to(cuda)
    for cur in (0, 5, 3071, 3100):
        start = max(0, cur - window + 1) if window else 0
        k, v = cache_k[:, :, start:cur + 1], cache_v[:, :, start:cur + 1]
        assert not k.is_contiguous() or cur + 1 - start == 3104
        got = attention(q.transpose(1, 2), k, v, window=window,
                        softcap=softcap)
        want = attention_ref(q.transpose(1, 2), k.contiguous(),
                             v.contiguous(), window=window or None,
                             softcap=softcap)
        assert float((got.float() - want).abs().max()) < tol, cur


def test_flash_attention_kernel_zero_rows_and_checks(cuda):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 2, 40, 32), generator=g).to(cuda)
    k = torch.randn((1, 1, 4, 32), generator=g).to(cuda)
    out = attention(q, k, k)                    # queries 0-35 see no key
    assert not out[:, :, :36].any()
    assert float((out - attention_ref(q, k, k)).abs().max()) < 2e-5
    _, lse = flash_attention_cuda(q, k, k, return_lse=True)
    assert bool((lse[:, :, :36] == float("-inf")).all())
    want = attention_ref(q, k, k, return_lse=True)[1]
    assert float((lse[:, :, 36:] - want[:, :, 36:]).abs().max()) < 2e-5
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_cuda(q[..., :24], k[..., :24], k[..., :24])
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_cuda(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q.transpose(2, 3)[..., :32, :].contiguous()
                             .transpose(2, 3), k, k)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("hq,hkv,d,softcap", [(4, 4, 64, 0.0),
                                              (8, 4, 256, 50.0),
                                              (8, 1, 128, 50.0),
                                              (16, 1, 256, 0.0),
                                              (32, 8, 160, 0.0),
                                              (16, 16, 128, 0.0),
                                              (48, 4, 128, 0.0),
                                              (56, 8, 128, 0.0)])
@pytest.mark.parametrize("skv,window", [
    (1, 0), (15, 0), (16, 0), (17, 0), (63, 0), (64, 0), (65, 0),
    (2048, 2048), (2048, 0), (3104, 0), (3104, 2048), (3104, 1), (5984, 0)])
def test_flash_attention_decode_split_edges(cuda, dtype, tol, hq, hkv, d,
                                            softcap, skv, window):
    """Sq = 1 at the bf16 decode form's split edges (1 key, a split's
    length +-1, the serving lengths), with a window inside the passed keys,
    and GQA groups of 1, 2, 7, 8, 12 and 16: against the plain version (bf16 also
    row by row), two launches bit-equal; each bf16 call is one
    ``flash_attention`` and one ``flash_attention_combine`` launch, each
    float32 call one ``flash_attention`` launch (the CUDA-core form)."""
    g = torch.Generator().manual_seed(skv + d)
    q = torch.randn((2, hq, 1, d), generator=g).to(dtype).to(cuda)
    k = torch.randn((2, hkv, skv, d), generator=g).to(dtype).to(cuda)
    v = torch.randn((2, hkv, skv, d), generator=g).to(dtype).to(cuda)
    n0 = LAUNCHES["flash_attention"], LAUNCHES["flash_attention_combine"]
    got = attention(q, k, v, window=window, softcap=softcap)
    again = attention(q, k, v, window=window, softcap=softcap)
    combines = 2 if dtype == torch.bfloat16 else 0
    assert (LAUNCHES["flash_attention"], LAUNCHES["flash_attention_combine"]
            ) == (n0[0] + 2, n0[1] + combines)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, again)
    want = attention_ref(q, k, v, window=window or None, softcap=softcap)
    assert float((got.float() - want).abs().max()) < tol
    if dtype == torch.bfloat16:
        assert _row_rel(got, want) < BF16_ROW_REL


@pytest.mark.parametrize("d", [16, 32, 64, 128, 160, 256])
@pytest.mark.parametrize("sq,skv,window,softcap,causal", [
    (100, 100, 0, 0.0, True), (70, 150, 32, 50.0, True),
    (40, 4, 0, 0.0, True), (129, 129, 0, 0.0, False)])
def test_flash_attention_bf16_prefill_form(cuda, d, sq, skv, window,
                                           softcap, causal):
    """The bf16 tensor-core form at every head dim: Sq off the 64-row
    tile, Sq < Skv end-aligned with a window and softcap, rows that see no
    key (exactly 0), non-causal; two launches bit-equal; within atol 3e-2
    and each row within BF16_ROW_REL of its RMS."""
    g = torch.Generator().manual_seed(sq + d)
    q = torch.randn((2, 4, sq, d), generator=g).to(torch.bfloat16).to(cuda)
    k = torch.randn((2, 2, skv, d), generator=g).to(torch.bfloat16).to(cuda)
    v = torch.randn((2, 2, skv, d), generator=g).to(torch.bfloat16).to(cuda)
    opts = dict(causal=causal, window=window or None, softcap=softcap)
    got = flash_attention_cuda(q, k, v, **opts)
    assert torch.equal(got, flash_attention_cuda(q, k, v, **opts))
    want = attention_ref(q, k, v, **opts)
    assert float((got.float() - want).abs().max()) < 3e-2
    assert _row_rel(got, want) < BF16_ROW_REL
    blind = max(0, sq - skv) if causal else 0      # rows before every key
    assert not got[:, :, :blind].any()


# the rows' log-sum-exp: float32 against the plain version's (float32
# sums of the same logits in another order), bf16 as chip_smoke.py holds
# the decode form's
F32_LSE_ATOL, BF16_LSE_ATOL = 2e-5, 2e-3


@pytest.mark.parametrize("sq", [1, 37])
def test_flash_attention_log_sum_exp_on_a_shard_view(cuda, sq):
    """The rows' log-sum-exp where gemma2-2b's 4 x 1 sequence-sharded
    decode asks for it: rank 3's slice of a 32,768-position cache (keys
    4,065-8,160 of its 8,192 positions, a view) under a 4,096-key window,
    softcap 50, 8 q heads on 4 kv heads at D = 256, for one query and for
    37.  float32 (the CUDA-core form, any Sq) and bf16 at Sq = 1 (the
    decode form) against the plain version, the output bit-equal with
    and without it; the bf16 prefill form refuses the request."""
    g = torch.Generator().manual_seed(sq)
    cache = torch.randn((2, 1, 4, 8192, 256), generator=g).to(cuda)
    q = torch.randn((1, sq, 8, 256), generator=g).to(cuda).transpose(1, 2)
    k, v = cache[0, :, :, 4065:8161], cache[1, :, :, 4065:8161]
    opts = dict(window=4096, softcap=50.0)
    for dtype, atol in ((torch.float32, F32_LSE_ATOL),
                        (torch.bfloat16, BF16_LSE_ATOL)):
        qd, kd, vd = (t.to(dtype) for t in (q, k, v))
        if dtype == torch.bfloat16 and sq > 1:
            with pytest.raises(ValueError, match="mma"):
                flash_attention_cuda(qd, kd, vd, return_lse=True, **opts)
            continue
        out, lse = flash_attention_cuda(qd, kd, vd, return_lse=True, **opts)
        assert torch.equal(out, flash_attention_cuda(qd, kd, vd, **opts))
        assert lse.dtype == torch.float32 and lse.shape == (1, 8, sq)
        want_out, want = attention_ref(qd, kd, vd, return_lse=True, **opts)
        assert float((lse - want).abs().max()) < atol
        assert float((out.float() - want_out).abs().max()) < (
            2e-5 if dtype == torch.float32 else 3e-2)


@pytest.mark.parametrize("b,s,w", [(2, 32, 64), (3, 17, 100),
                                   (4, 3072, 4096)])
def test_rglru_kernel_matches_plain(cuda, b, s, w):
    g = torch.Generator().manual_seed(s)
    x = torch.randn((b, s, w), generator=g)
    a = torch.sigmoid(torch.randn((b, s, w), generator=g))
    n0 = LAUNCHES["rglru_scan"]
    got = rglru(x.to(cuda), a.to(cuda))
    again = rglru(x.to(cuda), a.to(cuda))
    assert LAUNCHES["rglru_scan"] == n0 + 2
    assert torch.equal(got, again)
    want = rglru_ref(x.to(cuda), a.to(cuda))
    assert float((got - want).abs().max()) < 1e-4


@pytest.mark.parametrize("b,s,w,offset", [
    (1, 1, 64, 0), (2, 17, 100, 0), (1, 33, 4097, 0), (3, 70, 130, 0),
    (1, 96, 64, 0), (2, 40, 128, 1)])
def test_rglru_kernel_stage_and_tile_edges(cuda, b, s, w, offset):
    """Prompts below and off the 32-step stage, widths off the 64-channel
    tile, batch 1, whole steps and channels with gates of exactly 0 (a
    reset) and 1 (a carry); rows that are not 16-byte granules (W % 4 !=
    0, or tensors 4 bytes past a boundary) stage with plain loads.
    Within 1e-4 + 1e-4 |h| of the CPU plain version, two launches
    bit-equal."""
    rng = np.random.default_rng(b * 1000 + s + w)
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    a = rng.uniform(0.0, 1.0, (b, s, w)).astype(np.float32)
    a[:, ::5] = 0.0
    a[:, 2::7] = 1.0
    a[..., 1::9] = 1.0
    want = rglru_ref(torch.as_tensor(x), torch.as_tensor(a))

    def on_card(v):        # contiguous, ``offset`` floats into its buffer
        buf = torch.empty(v.size + offset, dtype=torch.float32, device=cuda)
        buf[offset:] = torch.as_tensor(v.ravel(), device=cuda)
        return buf[offset:].view(v.shape)

    xd, ad = on_card(x), on_card(a)
    assert xd.is_contiguous() and xd.data_ptr() % 16 == 4 * offset
    n0 = LAUNCHES["rglru_scan"]
    got = rglru(xd, ad)
    assert torch.equal(got, rglru(xd, ad))
    assert LAUNCHES["rglru_scan"] == n0 + 2
    err = (got.cpu() - want).abs() - 1e-4 * want.abs()
    assert float(err.max()) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,dm,n", [(2, 32, 128, 8), (1, 33, 256, 16),
                                      (4, 512, 8192, 16)])
def test_mamba_kernel_matches_plain(cuda, dtype, b, s, dm, n):
    g = torch.Generator().manual_seed(s)
    u = torch.randn((b, s, dm), generator=g)
    delta = torch.nn.functional.softplus(torch.randn((b, s, dm), generator=g)
                                         - 2.0)
    A = -torch.arange(1, n + 1, dtype=torch.float32).repeat(dm, 1)
    B, C = (torch.randn((b, s, n), generator=g) for _ in range(2))
    D = torch.ones(dm)
    args = [t.to(cuda) for t in (u, delta, A, B, C, D)]
    for i in (0, 1, 3, 4):
        args[i] = args[i].to(dtype)
    n0 = LAUNCHES["selective_scan"]
    y, h = selective_scan(*args)
    y2, h2 = selective_scan(*args)
    assert LAUNCHES["selective_scan"] == n0 + 2
    assert torch.equal(y, y2) and torch.equal(h, h2)
    plain_y, plain_h = selective_scan(*(t.cpu() for t in args))
    assert float((y.cpu() - plain_y).abs().max()) < 1e-4
    assert float((h.cpu() - plain_h).abs().max()) < 1e-4
    with pytest.raises(ValueError, match="N="):
        selective_scan_cuda(*args[:2], args[2][:, :3].contiguous(),
                            args[3][..., :3].contiguous(),
                            args[4][..., :3].contiguous(), args[5])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [4, 8, 16])
@pytest.mark.parametrize("b,s,dm", [(1, 1, 64), (2, 45, 100), (1, 70, 99),
                                    (3, 32, 200), (1, 45, 257)])
def test_mamba_kernel_chunk_and_block_edges(cuda, dtype, n, b, s, dm):
    """One step, prompts off the 32-step chunk, channels off the
    128-channel block (an odd Dm stages bf16 without cp.async, in a
    second and third block too), every N: within 1e-4 of the plain
    version, two launches bit-equal."""
    g = torch.Generator().manual_seed(b * 1000 + s + dm + n)
    u = torch.randn((b, s, dm), generator=g)
    delta = torch.nn.functional.softplus(torch.randn((b, s, dm), generator=g)
                                         - 2.0)
    A = -torch.rand((dm, n), generator=g) * n - 0.1
    B, C = (torch.randn((b, s, n), generator=g) for _ in range(2))
    D = torch.randn(dm, generator=g)
    args = [t.to(cuda) for t in (u, delta, A, B, C, D)]
    for i in (0, 1, 3, 4):
        args[i] = args[i].to(dtype)
    n0 = LAUNCHES["selective_scan"]
    y, h = selective_scan(*args)
    y2, h2 = selective_scan(*args)
    assert LAUNCHES["selective_scan"] == n0 + 2
    assert torch.equal(y, y2) and torch.equal(h, h2)
    plain_y, plain_h = selective_scan(*(t.cpu() for t in args))
    assert float((y.cpu() - plain_y).abs().max()) < 1e-4
    assert float((h.cpu() - plain_h).abs().max()) < 1e-4


def _smoke_inputs(cfg, b, s, gen):
    """Prompts (B, S[, K]) and, for a VLM, float32 image embeddings."""
    shape = (b, s) + ((cfg.num_codebooks,) if cfg.num_codebooks else ())
    prompts = torch.randint(0, cfg.vocab_size, shape, generator=gen)
    img = (torch.randn((b, cfg.img_tokens, cfg.d_model), generator=gen)
           if cfg.family == "vlm" else None)
    return prompts, img


def _on(t, dev):
    return None if t is None else t.to(dev)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_serving_on_card_matches_cpu(cuda, arch):
    """The same float32 weights and prompts (and image embeddings):
    greedy tokens identical, prefill and last logits within 1e-4, every
    kernel of the family launched on the card and none on the CPU."""
    import dataclasses
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    params = lm.init_params(cfg, gen, "cpu")
    prompts, img = _smoke_inputs(cfg, 2, 40, gen)
    max_len = 52 + cfg.img_tokens
    LAUNCHES.clear()
    cpu = generate(params, prompts, cfg, 12, max_len, img_embeds=img)
    assert dict(LAUNCHES) == {}
    card = generate(lm.to_device(params, cuda), prompts.to(cuda), cfg, 12,
                    max_len, img_embeds=_on(img, cuda))
    kinds = set(cfg.layer_types())
    want = {"flash_attention": bool(kinds & {"attn", "attn_local", "moe"}),
            "rglru_scan": "recurrent" in kinds,
            "selective_scan": "mamba" in kinds}
    assert {k: LAUNCHES[k] > 0 for k in want} == want
    np.testing.assert_array_equal(card["tokens"], cpu["tokens"])
    for key in ("prefill_logits", "logits"):
        assert float((card[key].cpu() - cpu[key]).abs().max()) < 1e-4


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-moe-a2.7b"])
def test_moe_generate_repeats_on_card(cuda, arch):
    """An MoE smoke config (bf16) served twice on the card: the same
    tokens and logits bit for bit (the dispatch assigns, the combine sums
    in order: no atomics on the serving path)."""
    cfg = get_smoke_config(arch)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = lm.init_params(cfg, gen, cuda)
    prompts = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen,
                            device=cuda)
    runs = [generate(params, prompts, cfg, 16, 80) for _ in range(2)]
    np.testing.assert_array_equal(runs[0]["tokens"], runs[1]["tokens"])
    for key in ("prefill_logits", "logits"):
        assert torch.equal(runs[0][key], runs[1][key])


# --------------------------------------------------------------------- #
# the engine's correctly rounded congestion pow
# --------------------------------------------------------------------- #
def test_pow_cr_kernel_matches_plain(cuda):
    """``pow_cr`` on 100,000 values of the engine's range (and the
    engine's shape, one per OST) bit-equal to its plain version on the
    CPU, two launches bit-equal; a tuned fleet tick launches it."""
    from repro_torch.kernels.pow_cr.kernel import pow_cr_cuda
    from repro_torch.kernels.pow_cr.ref import pow_cr_ref

    rng = np.random.default_rng(3)
    for n in (4, 32, 100_000):
        x = np.exp(rng.uniform(np.log(1e-5), np.log(7e7), n))
        x[0] = 1.0
        for e in (0.35, 0.5):
            got = pow_cr_cuda(torch.as_tensor(x, device=cuda), e)
            again = pow_cr_cuda(torch.as_tensor(x, device=cuda), e)
            assert torch.equal(got, again)
            np.testing.assert_array_equal(
                got.cpu().numpy(), pow_cr_ref(torch.from_numpy(x), e).numpy())
    LAUNCHES.clear()
    sim = _loop_sim(cuda, 8, 4)
    sim.run(0.05)
    assert LAUNCHES["pow_cr"] == 10


# --------------------------------------------------------------------- #
# LM training: the kernels refuse gradients; card == CPU
# --------------------------------------------------------------------- #
def test_lm_kernels_refuse_grad_on_card(cuda):
    """A CUDA input that requires a gradient raises (the kernels write
    through raw pointers and have no backward); under ``no_grad`` the
    same call launches."""
    from repro_torch.kernels.rglru_scan.kernel import rglru_cuda

    g = torch.Generator(device=cuda).manual_seed(0)
    t = lambda *s: torch.rand(s, generator=g, device=cuda)  # noqa: E731
    q, k = t(1, 2, 8, 16), t(1, 1, 8, 16)
    x, a = t(1, 8, 32), t(1, 8, 32)
    u, dt, A = t(1, 8, 32), t(1, 8, 32), -t(32, 8)
    bb, cc, dd = t(1, 8, 8), t(1, 8, 8), t(32)
    calls = {   # the launch counter's name: the call, its grad input
        "flash_attention": (lambda: flash_attention_cuda(q, k, k), q),
        "rglru_scan": (lambda: rglru_cuda(x, a), x),
        "selective_scan": (lambda: selective_scan_cuda(
            u, dt, A, bb, cc, dd), u)}
    for name, (call, leaf) in calls.items():
        leaf.requires_grad_(True)
        LAUNCHES.clear()
        with pytest.raises(RuntimeError, match="gradient"):
            call()
        assert LAUNCHES[name] == 0
        with torch.no_grad():
            call()
        torch.cuda.synchronize()
        assert LAUNCHES[name] == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_loss_and_grads_on_card_match_cpu(cuda, arch):
    """The same float32 weights and tokens (codebook labels, image
    embeddings): the loss within 1e-5 relative and every gradient leaf
    within 1e-4 of its largest |value| on the card and the CPU; the
    training forms launch no LM kernel.  An MoE layer's backward sums
    its token gathers with atomics on the card, so its gradients differ
    from the CPU's at rounding level, not bit for bit."""
    import dataclasses

    from repro_torch.train.optimizer import tree_leaves
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="float32")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tok, img = _smoke_inputs(cfg, 2, 48, torch.Generator().manual_seed(1))
    out = {}
    LAUNCHES.clear()
    for dev in ("cpu", cuda):
        p = lm.to_device(params, dev)
        leaves = tree_leaves(p)
        for x in leaves:
            x.requires_grad_(True)
        t = tok.to(dev)
        batch = {"tokens": t, "labels": t}
        if img is not None:
            batch["img_embeds"] = img.to(dev)
        loss = lm.loss_fn(p, batch, cfg, seq_chunk=16)
        out[str(dev)] = (loss.detach().cpu(), [g.cpu() for g in
                         torch.autograd.grad(loss, leaves)])
    assert not any(LAUNCHES[k] for k in ("flash_attention", "rglru_scan",
                                         "selective_scan"))
    (lc, gc), (lg, gg) = out["cpu"], out[str(cuda)]
    assert float(lg) == pytest.approx(float(lc), rel=1e-5)
    for a, b in zip(gg, gc):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


# --------------------------------------------------------------------- #
# the fused tuning loop: each interval one CUDA-graph replay
# --------------------------------------------------------------------- #
def _loop_sim(device, n_clients, n_osts):
    """The smoke's fleet roles at any size: VPIC writers and BDCATS
    readers striped over 4 OSTs, DLIO readers and a random writer on 1;
    knobs started small so the tuner moves them."""
    sim = PFSSim(n_clients, n_osts, device=device)
    for c in range(n_clients):
        stripe = tuple((c + j) % n_osts for j in range(min(4, n_osts)))
        role, k = c % 4, c // 4
        if role == 0:
            sim.attach(W.vpic_write(c, dims=1 + k % 3, osts=stripe))
        elif role == 1:
            sim.attach(W.bdcats_read(c, ("partial", "strided", "full")[k % 3],
                                     osts=stripe))
        elif role == 2:
            sim.attach(W.dlio_reader(c, ("bert", "megatron")[k % 2],
                                     n_threads=4, osts=(c % n_osts,)))
        else:
            sim.attach(W.random_stream(c, WRITE, 256 * 1024, ost=c % n_osts,
                                       n_threads=2))
    sim.set_knobs(np.arange(sim.n_osc), window_pages=64, rpcs_in_flight=2)
    return sim


def _disturbed(sim, n_ticks, rng):
    """A non-neutral schedule: OST bandwidth and IOPS scaled, background
    bytes, client NICs scaled, every tick."""
    from repro_torch.pfs.state import Disturbance

    t = lambda a: torch.as_tensor(a, device=sim.device)  # noqa: E731
    no, nc = sim.n_osts, sim.n_clients
    return Disturbance(bw_scale=t(rng.uniform(0.3, 1.2, (n_ticks, no))),
                       iops_scale=t(rng.uniform(0.5, 1.5, (n_ticks, no))),
                       bg_bytes=t(rng.uniform(0, 2e6, (n_ticks, no))),
                       nic_scale=t(rng.uniform(0.5, 1.0, (n_ticks, nc))))


@pytest.mark.parametrize("n_clients,n_osts,k,disturbed", [
    (8, 4, 1, False), (32, 8, 2, True)])
def test_fused_graph_replay_equals_eager(cuda, n_clients, n_osts, k,
                                         disturbed):
    """The replayed interval against the same interval run eagerly on
    the card: decision records, every state field and the snapshot ring
    bit-equal, twice (the second run replays without a new capture)."""
    import dataclasses

    from repro_torch.pfs.loop_torch import FusedLoop
    from repro_torch.pfs.workloads import table_from_sim

    rng = np.random.default_rng(11)
    model = model_from_numpy(
        *(random_forest(rng, feature_dim(op, k), 20, 4)
          for op in (READ, WRITE)), k=k, device=cuda)
    sim = _loop_sim(cuda, n_clients, n_osts)
    table, wstate = table_from_sim(sim)
    loop = FusedLoop(sim.params, sim.topo, 100, model, k=k)
    n = 8
    sched = _disturbed(sim, n * 100, rng) if disturbed else None
    eager = loop.run(table, sim.state, wstate, n, schedule=sched,
                     graph=False)
    assert loop.last_run["graph"] is False
    for captured in (True, False):
        got = loop.run(table, sim.state, wstate, n, schedule=sched)
        assert loop.last_run["graph"] is True
        assert loop.last_run["captured_now"] is captured
        assert loop.last_run["launches_per_replay"]["paired_forest_margin"] == 1
        for key in eager.trace:
            assert torch.equal(got.trace[key], eager.trace[key]), key
        for f in dataclasses.fields(eager.state):
            a, b = getattr(eager.state, f.name), getattr(got.state, f.name)
            assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), \
                f.name
        for a, b in zip(eager.hist + (eager.wstate.issued,),
                        got.hist + (got.wstate.issued,)):
            assert torch.equal(a, b)
    assert any(r.decisions.changed.any() for r in got.decisions)
    # the caller's state was not advanced by the runs
    assert sim.state.tick_index == 0


def test_fused_graph_on_card_matches_cpu(cuda):
    """run_fleet(backend="torch-fused") at 8 x 4, the card's replayed
    graph against the CPU's plain versions: θ trajectories identical,
    counters within 1e-6; the card launched both kernels, the CPU none."""
    rng = np.random.default_rng(7)
    forests = [random_forest(rng, feature_dim(op), 20, 4)
               for op in (READ, WRITE)]
    runs = {}
    for dev in ("cpu", cuda):
        sim = _fleet_sim(dev)
        LAUNCHES.clear()
        fleet = run_fleet(sim, model_from_numpy(*forests, device=dev),
                          seconds=4.0, interval=0.5, device=dev,
                          backend="torch-fused")
        runs[str(dev)] = (sim, fleet, dict(LAUNCHES))
    (sim_c, fleet_c, launches_c), (sim_d, fleet_d, launches_d) = \
        runs["cpu"], runs[str(cuda)]
    traj = lambda fl: [(r.oscs.tolist(), r.ops.tolist(),  # noqa: E731
                        r.decisions.theta.tolist(),
                        r.decisions.changed.tolist()) for r in fl.decisions]
    assert traj(fleet_d) == traj(fleet_c)
    assert any(r.decisions.changed.any() for r in fleet_d.decisions)
    assert launches_c == {}
    assert fleet_d.loop.last_run["graph"] is True
    per_replay = fleet_d.loop.last_run["launches_per_replay"]
    assert per_replay["paired_forest_margin"] == 1
    assert per_replay["segment_sum"] >= 600
    # counted: the warm-up interval and the capture, not the replays
    assert launches_d == {k: 2 * v for k, v in per_replay.items()}
    for f in ("ctr_bytes_done", "ctr_rpcs_sent", "ctr_latency_sum",
              "ctr_req_bytes", "ctr_pending_integral", "dirty_bytes"):
        a = getattr(sim_c.state, f).numpy()
        b = getattr(sim_d.state, f).cpu().numpy()
        assert np.max(np.abs(a - b) / np.maximum(np.abs(a), 1.0)) <= 1e-6, f


def test_fused_replay_and_interval_make_no_host_sync(cuda):
    """Under ``set_sync_debug_mode("error")`` the replayed run (copy-in,
    replays, record copies) and the eager interval itself make no call
    that waits for the device or reads it from the host."""
    from repro_torch.pfs.loop_torch import FusedLoop
    from repro_torch.pfs.workloads import table_from_sim

    rng = np.random.default_rng(3)
    model = model_from_numpy(*(random_forest(rng, feature_dim(op), 20, 4)
                               for op in (READ, WRITE)), device=cuda)
    sim = _loop_sim(cuda, 8, 4)
    table, wstate = table_from_sim(sim)
    loop = FusedLoop(sim.params, sim.topo, 100, model)
    loop.run(table, sim.state, wstate, 2)                 # the capture
    for graph in (True, False):
        inputs = loop.prepare(sim.state, wstate, 4)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            loop.advance(table, inputs, 4, graph=graph)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


# --------------------------------------------------------------------- #
# the Scenario Lab: a ragged bucket as one fleet on the card
# --------------------------------------------------------------------- #
LAB_MIXED = ("dlio_bert", "vpic_checkpoint", "noisy_neighbor")


def _lab_bucket(device):
    """Three catalog scenarios of three shapes, padded into one bucket."""
    from repro_torch.lab.batch import stack_scenarios
    from repro_torch.lab.scenarios import build, get_scenario

    return stack_scenarios([build(get_scenario(n)) for n in LAB_MIXED],
                           device=device)


def _lab_model(device):
    rng = np.random.default_rng(5)
    return model_from_numpy(*(random_forest(rng, feature_dim(op), 20, 4)
                              for op in (READ, WRITE)), device=device)


def _lab_records(decisions):
    return [(r.oscs.tolist(), r.ops.tolist(), r.decisions.theta.tolist(),
             r.decisions.changed.tolist()) for r in decisions]


def test_lab_bucket_graph_replay_equals_eager(cuda):
    """run_batch(fused=True) on the bucket, every element tuned: the
    replayed intervals bit-equal to the eager ones (records, every state
    field), twice (the second batch, rebuilt, replays without a new
    capture); one tuned element of three too."""
    import dataclasses

    from repro_torch.lab.batch import _FUSED_LOOPS, run_batch

    model = _lab_model(cuda)
    eager_batch = _lab_bucket(cuda)
    eager = run_batch(eager_batch, model, seconds=3.0, fused=True,
                      graph=False)
    assert any(r.decisions.changed.any() for r in eager.decisions)
    for captured in (True, False):
        batch = _lab_bucket(cuda)
        got = run_batch(batch, model, seconds=3.0, fused=True)
        loop = next(v[0] for v in _FUSED_LOOPS.values() if v[1] is model)
        assert loop.last_run["captured_now"] is captured
        for key in eager.trace:
            assert torch.equal(got.trace[key], eager.trace[key]), key
        for f in dataclasses.fields(batch.state):
            a = getattr(eager_batch.state, f.name)
            b = getattr(batch.state, f.name)
            assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), \
                f.name
    # one tuned element of three: the others ride with their mask off
    runs = []
    for graph in (False, None):
        batch = _lab_bucket(cuda)
        cols = batch.n_osc + batch.element_cols(1)
        res = run_batch(batch, model, seconds=3.0, fused=True,
                        tune_cols=cols, graph=graph)
        runs.append((batch, _lab_records(res.decisions)))
    assert runs[0][1] == runs[1][1]
    assert torch.equal(runs[0][0].state.ctr_bytes_done,
                       runs[1][0].state.ctr_bytes_done)


def test_lab_bucket_on_card_matches_cpu(cuda):
    """The bucket's fused run (graphs on the card) and its host-path run
    on the card against the CPU's plain versions: decision records
    identical, counters within 1e-6, MB/s within 1e-6."""
    from repro_torch.lab.batch import run_batch

    for fused in (True, False):
        out = {}
        for dev in ("cpu", cuda):
            batch = _lab_bucket(dev)
            res = run_batch(batch, _lab_model(dev), seconds=3.0,
                            fused=fused)
            out[str(dev)] = (batch, _lab_records(res.decisions))
        (bc, rc), (bd, rd) = out["cpu"], out[str(cuda)]
        assert rc == rd, f"fused={fused}"
        assert any(any(ch) for _, _, _, ch in rd)
        for f in ("ctr_bytes_done", "ctr_rpcs_sent", "ctr_latency_sum",
                  "ctr_pending_integral", "dirty_bytes", "window_pages"):
            a = getattr(bc.state, f).double().numpy()
            b = getattr(bd.state, f).double().cpu().numpy()
            assert np.max(np.abs(a - b) / np.maximum(np.abs(a), 1.0)) \
                <= 1e-6, f
        np.testing.assert_allclose(bd.throughput(3.0)["total_mbs"],
                                   bc.throughput(3.0)["total_mbs"],
                                   rtol=1e-6)


def test_lab_bucket_replay_makes_no_host_sync(cuda):
    """The bucket's replayed run (copy-in, the schedule's slices,
    replays, record copies) makes no host sync."""
    from repro_torch.pfs.loop_torch import FusedLoop

    batch = _lab_bucket(cuda)
    loop = FusedLoop(batch.params, batch.fleet, 100, _lab_model(cuda))
    sched = batch.schedule(0, 400)
    loop.run(batch.table, batch.state, batch.wstate, 4,
             schedule=sched)                                 # the capture
    inputs = loop.prepare(batch.state, batch.wstate, 4, schedule=sched)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loop.advance(batch.table, inputs, 4)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert loop.last_run["graph"] and not loop.last_run["captured_now"]


def test_lab_kernels_at_fleet_maps_match_plain(cuda):
    """``segment_sum`` on the bucket fleet's four maps (one column, and
    the engine's and demand step's batched forms) bit-equal to the CPU's
    plain version; the paired forest on the bucket's B * n * 24 rows
    within 1e-5 of its plain version."""
    from repro_torch.kernels.segment_reduce.ref import segment_sum_ref

    batch = _lab_bucket(cuda)
    rng = np.random.default_rng(17)
    maps = {"ost": batch.fleet.ost_map, "client": batch.fleet.client_map,
            "row": batch.table.row_map, "osc": batch.table.osc_map}
    for name, smap in maps.items():
        for k in (1, 2, 8):
            e = smap.n_entries
            v = rng.standard_normal((k, e)) * 10.0 ** rng.uniform(-3, 9,
                                                                  (k, e))
            got = segment_sum(torch.as_tensor(v, device=cuda), smap)
            want = segment_sum_ref(torch.as_tensor(v), smap.ids.cpu(),
                                   smap.num_segments)
            assert torch.equal(got.cpu(), want), (name, k)
    m_cpu = _lab_model("cpu")
    feature, threshold, leaf, base, depth, n_features = ops.pair_forests(
        m_cpu.read_forest, m_cpu.write_forest)
    n = batch.fleet.n_osc * 24
    x = (rng.standard_normal((n, n_features))
         * 10.0 ** rng.uniform(-1, 3, n_features)).astype(np.float32)
    op = np.repeat(rng.integers(0, 2, size=batch.fleet.n_osc),
                   24).astype(np.int32)
    arrays = (x, op, feature, threshold, leaf, base)
    plain = ops.paired_forest_margin(*map(torch.as_tensor, arrays), depth)
    got = ops.paired_forest_margin(
        *(torch.as_tensor(a, device=cuda) for a in arrays), depth)
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), atol=1e-5)


# --------------------------------------------------------------------- #
# observability: the traced fused loop and the loss-finding pipeline
# --------------------------------------------------------------------- #
def _assert_traces_match(a: dict, b: dict, rtol: float = 0.0):
    """Two raw fused traces (``FusedLoopResult.trace``): integer and bool
    records equal, floating ones bit-equal (``rtol=0``) or within
    ``rtol`` relative (floor 1; the forest's float32 margins sum in
    another order on the card, so probabilities get 1e-5)."""
    flat = lambda t: {**{k: v for k, v in t.items() if k != "timeline"},  # noqa: E731
                      **{"timeline." + k: v
                         for k, v in t.get("timeline", {}).items()}}
    a, b = flat(a), flat(b)
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k].cpu(), b[k].cpu()
        if not x.is_floating_point() or rtol == 0.0:
            assert torch.equal(x, y), k
            continue
        tol = 1e-5 if k in ("probs", "score") else rtol
        x, y = x.double().numpy(), y.double().numpy()
        err = np.max(np.abs(x - y) / np.maximum(np.abs(x), 1.0),
                     initial=0.0)
        assert err <= tol, (k, err)


def test_traced_graph_replay_equals_eager_and_cpu(cuda):
    """A traced loop (stride 20, a disturbed schedule) at 8 x 4: the
    replayed intervals' records (provenance and timeline) bit-equal to
    the eager ones on the card, twice; θ equal to the CPU's, the other
    records within 1e-6 (probabilities 1e-5)."""
    from repro_torch.obs.schema import TraceConfig
    from repro_torch.pfs.loop_torch import FusedLoop
    from repro_torch.pfs.workloads import table_from_sim

    rng = np.random.default_rng(23)
    forests = [random_forest(rng, feature_dim(op), 20, 4)
               for op in (READ, WRITE)]
    cfg = TraceConfig(stride=20)
    out = {}
    for dev in ("cpu", cuda):
        sim = _loop_sim(dev, 8, 4)
        table, wstate = table_from_sim(sim)
        loop = FusedLoop(sim.params, sim.topo, 100,
                         model_from_numpy(*forests, device=dev), trace=cfg)
        sched = _disturbed(sim, 6 * 100, np.random.default_rng(2))
        out[str(dev)] = [loop.run(table, sim.state, wstate, 6,
                                  schedule=sched, graph=False)]
        if dev == cuda:
            for captured in (True, False):
                out[str(dev)].append(loop.run(table, sim.state, wstate, 6,
                                              schedule=sched))
                assert loop.last_run["captured_now"] is captured
            trace = loop.run_trace(out[str(dev)][-1])
            trace.validate()
            assert trace.timeline["read_bytes"].shape == (30, 4)
    eager, *graphs = out[str(cuda)]
    for got in graphs:
        _assert_traces_match(eager.trace, got.trace)
    cpu = out["cpu"][0]
    assert torch.equal(cpu.trace["theta"], eager.trace["theta"].cpu())
    assert torch.equal(cpu.trace["decided"], eager.trace["decided"].cpu())
    _assert_traces_match(cpu.trace, eager.trace, rtol=1e-6)
    assert bool(eager.trace["changed"].any())


def test_traced_equals_untraced_on_card(cuda):
    """run_fleet on the card, traced and not, fused (graphs) and host:
    decision records and every state field bit-equal; the host trace
    equals the fused trace."""
    import dataclasses

    from repro_torch.obs.schema import DECISION_FIELDS, TraceConfig

    rng = np.random.default_rng(29)
    model = model_from_numpy(*(random_forest(rng, feature_dim(op), 20, 4)
                               for op in (READ, WRITE)), device=cuda)
    runs = {}
    for backend in ("torch-fused", "torch"):
        for trace in (None, TraceConfig(stride=10)):
            sim = _loop_sim(cuda, 8, 4)
            runs[backend, trace is not None] = (sim, run_fleet(
                sim, model, seconds=3.0, interval=0.5, device=cuda,
                backend=backend, trace=trace))
    for backend in ("torch-fused", "torch"):
        (sim_t, f_t), (sim_u, f_u) = runs[backend, True], runs[backend, False]
        assert len(f_t.decisions) == len(f_u.decisions) == 6
        for a, b in zip(f_t.decisions, f_u.decisions):
            assert torch.equal(a.oscs, b.oscs)
            for f in dataclasses.fields(a.decisions):
                assert torch.equal(getattr(a.decisions, f.name),
                                   getattr(b.decisions, f.name)), f.name
        for f in dataclasses.fields(sim_t.state):
            a, b = getattr(sim_t.state, f.name), getattr(sim_u.state, f.name)
            assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), \
                f.name
    fused, host = (runs[b, True][1].trace for b in ("torch-fused", "torch"))
    fused.validate()
    host.validate()
    for f in ("decided", "ops", "theta", "changed", "n_candidates", "active",
              "steady", "warm"):
        np.testing.assert_array_equal(host.decisions[f], fused.decisions[f],
                                      err_msg=f)
    for f in set(DECISION_FIELDS) - {"decided", "ops", "theta", "changed",
                                     "n_candidates", "active", "steady",
                                     "warm"}:
        np.testing.assert_allclose(host.decisions[f], fused.decisions[f],
                                   rtol=1e-12, atol=0, err_msg=f)
    for f in fused.timeline:
        np.testing.assert_array_equal(host.timeline[f], fused.timeline[f],
                                      err_msg=f)


def test_traced_replay_and_host_sampling_make_no_host_sync(cuda):
    """A traced replayed run, a traced eager interval and the host
    tracer's samples in the engine's tick loop make no host sync."""
    from repro_torch.obs.host import HostTracer
    from repro_torch.obs.schema import TraceConfig
    from repro_torch.pfs.engine_torch import FusedEngine
    from repro_torch.pfs.loop_torch import FusedLoop
    from repro_torch.pfs.workloads import table_from_sim

    rng = np.random.default_rng(31)
    model = model_from_numpy(*(random_forest(rng, feature_dim(op), 20, 4)
                               for op in (READ, WRITE)), device=cuda)
    sim = _loop_sim(cuda, 8, 4)
    table, wstate = table_from_sim(sim)
    cfg = TraceConfig(stride=10)
    loop = FusedLoop(sim.params, sim.topo, 100, model, trace=cfg)
    loop.run(table, sim.state, wstate, 2)                 # the capture
    tracer = HostTracer(cfg, sim.params, sim.topo)
    engine = FusedEngine(sim.params, sim.topo, table, 100)
    for graph in (True, False):
        inputs = loop.prepare(sim.state, wstate, 3)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            loop.advance(table, inputs, 3, graph=graph)
            if not graph:
                engine.run_interval(sim.state, wstate, tracer=tracer)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    assert len(tracer._tl) == 10


def test_timeline_tap_segment_sum_bit_equal_to_bincount(cuda):
    """The tap's ``(5, E)`` launch on the OST map, at the smoke fleet's
    map (8,192 interfaces, 32 OSTs) and a small one, bit-equal to
    ``np.bincount`` of each row; the tap of a card state equals the
    CPU's on the same state."""
    from repro_torch.obs.schema import timeline_tap
    from repro_torch.pfs.engine_torch import FusedEngine
    from repro_torch.pfs.workloads import table_from_sim

    rng = np.random.default_rng(37)
    for n_clients, n_osts in ((256, 32), (8, 4)):
        sim = PFSSim(n_clients, n_osts, device=cuda)
        v = rng.standard_normal((5, sim.n_osc)) * 10.0 ** rng.uniform(
            0, 9, (5, sim.n_osc))
        LAUNCHES.clear()
        got = segment_sum(torch.as_tensor(v, device=cuda), sim.topo.ost_map)
        assert LAUNCHES["segment_sum"] == 1
        ids = sim.topo.osc_ost.cpu().numpy()
        for r in range(5):
            want = np.bincount(ids, weights=v[r], minlength=n_osts)
            assert np.array_equal(got[r].cpu().numpy(), want), r
    sim = _loop_sim(cuda, 8, 4)
    table, wstate = table_from_sim(sim)
    state, _ = FusedEngine(sim.params, sim.topo, table, 60).run_interval(
        sim.state, wstate)
    sim_c = _loop_sim("cpu", 8, 4)
    state_c = type(state)(**{f: (v.cpu() if torch.is_tensor(v) else v)
                             for f, v in vars(state).items()})
    LAUNCHES.clear()
    tap = timeline_tap(sim.params, sim.topo, state)
    assert LAUNCHES["segment_sum"] == 1
    tap_c = timeline_tap(sim_c.params, sim_c.topo, state_c)
    for k, v in tap.items():
        assert torch.equal(torch.as_tensor(v).cpu(),
                           torch.as_tensor(tap_c[k])), k


def test_intervened_traced_bucket_on_card_matches_cpu(cuda):
    """The diagnosis's replay: a 4-arm (factual, pin θ*, gates open,
    freeze) intervened, traced bucket of two catalog scenarios, on the
    card (graphs) and the CPU: arms' MB/s within 1e-9, every factual
    decision record equal (probabilities 1e-5)."""
    import importlib

    from repro_torch.lab.scenarios import get_scenario

    # the module (``repro_torch.obs`` exports a function ``diagnose``)
    D = importlib.import_module("repro_torch.obs.diagnose")

    cases = [(get_scenario("noisy_neighbor"), (1024, 32)),
             (get_scenario("dlio_bert"), (64, 2))]
    cfg = D.DiagnoseConfig(seconds=3.0)
    out = {}
    for dev in ("cpu", cuda):
        LAUNCHES.clear()
        out[str(dev)] = (D.replay_arms_many(cases, _lab_model(dev), cfg,
                                            device=dev), dict(LAUNCHES))
    (cpu, l_cpu), (card, l_card) = out["cpu"], out[str(cuda)]
    assert l_cpu == {} and l_card["paired_forest_margin"] > 0
    for (arms_c, fact_c), (arms_d, fact_d) in zip(cpu, card):
        assert arms_c.keys() == arms_d.keys() == set(D.ARMS)
        for arm in arms_c:
            np.testing.assert_allclose(arms_d[arm], arms_c[arm], rtol=1e-9)
        for k, v in fact_c.items():
            if v.dtype.kind in "bi":
                np.testing.assert_array_equal(fact_d[k], v, err_msg=k)
            else:
                np.testing.assert_allclose(
                    fact_d[k], v, rtol=1e-5 if k in ("probs", "score")
                    else 1e-9, atol=1e-9, err_msg=k)
        assert arms_c["pin_best_static"] != arms_c["factual"]


# --------------------------------------------------------------------- #
# the rest of DIAL's side: continual refit, overhead timing, the mesh
# --------------------------------------------------------------------- #
def test_continual_on_card_matches_cpu(cuda):
    """``run_continual`` on failing_ost on the card and on the CPU: the
    frozen arm whole, the online arm through its first refit (the refit's
    float32 forests may then differ by the histogram's summation
    order)."""
    import json

    from repro_torch.lab.continual import run_continual
    from repro_torch.lab.scenarios import get_scenario
    from repro_torch.learn.online import OnlinePolicy

    policy = OnlinePolicy(refit_every=10, min_samples=32, cooldown=6,
                          explore_eps=0.10)
    rows = {}
    for dev in ("cpu", cuda):
        for online in (False, True):
            res = run_continual(get_scenario("failing_ost"), _lab_model(dev),
                                online=online, seconds=8.0, policy=policy,
                                gbdt_params=GBDTParams(n_trees=10,
                                                       max_depth=4),
                                device=dev)
            rows[(str(dev), online)] = json.loads(json.dumps(res.row()))
    assert rows[("cpu", False)] == rows[(str(cuda), False)]
    cpu, card = rows[("cpu", True)], rows[(str(cuda), True)]
    assert cpu["refits"] and cpu["refits"][0] == card["refits"][0]
    i = cpu["refits"][0]["interval"]
    for k in ("tput_mbs", "theta_trace"):
        assert cpu[k][:i] == card[k][:i], k


def test_table2_workload_on_card_matches_cpu(cuda, monkeypatch):
    """One Table II workload (``benchmarks/torch_table2_h5bench.py``) at
    3 s: the static arms over three configurations and the DIAL arm on
    the card (graph replays) against the CPU with the card's congestion
    ``pow`` (``pow_cr``'s plain version in place of numpy's ``power``):
    delivered bytes bit-equal, θ trajectories identical, the same
    optimal configuration."""
    import os
    import sys

    from repro_torch.kernels.pow_cr.ref import pow_cr_ref
    from repro_torch.pfs import state

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import benchmarks.torch_table2_h5bench as t2

    numpy_pow = state._pow
    monkeypatch.setattr(state, "_pow", lambda x, e: (
        pow_cr_ref(x, e) if x.device.type == "cpu" else numpy_pow(x, e)))
    rng = np.random.default_rng(11)
    forests = [random_forest(rng, feature_dim(op), 20, 4)
               for op in (READ, WRITE)]
    runs = {}
    for dev in ("cpu", cuda):
        LAUNCHES.clear()
        runs[str(dev)] = (t2.measure(
            model_from_numpy(*forests, device=dev),
            configs=[(256, 8), (16, 1), (1024, 32)], seconds=3.0,
            workloads=t2.WORKLOADS[3:4], device=dev)[0], dict(LAUNCHES))
    (cpu, launches_c), (card, launches_d) = runs["cpu"], runs[str(cuda)]
    assert launches_c == {}
    assert {"segment_sum", "pow_cr", "paired_forest_margin"} <= set(
        launches_d)
    for (cfg_c, a), (cfg_d, b) in zip(cpu["grid"], card["grid"]):
        assert cfg_c == cfg_d and a.done_bytes == b.done_bytes, cfg_c
    assert t2.row(card) == t2.row(cpu)
    assert t2.trajectory(card["dial"].fleet) == \
        t2.trajectory(cpu["dial"].fleet)
    assert card["dial"].done_bytes == cpu["dial"].done_bytes
    assert card["dial"].fleet.loop.last_run["graph"] is True


def test_one_device_mesh_equals_unsharded(cuda):
    """The lab bucket through ``run_batch(fused=True, mesh=fleet_mesh(1))``
    on graphs: every record and state field bit-equal to the unsharded
    run."""
    import dataclasses

    from repro_torch.distributed.sharding import fleet_mesh
    from repro_torch.lab.batch import run_batch

    model = _lab_model(cuda)
    runs = []
    for mesh in (None, fleet_mesh(1)):
        batch = _lab_bucket(cuda)
        runs.append((batch, run_batch(batch, model, seconds=3.0, fused=True,
                                      mesh=mesh)))
    (b0, r0), (b1, r1) = runs
    for key in r0.trace:
        assert torch.equal(r0.trace[key], r1.trace[key]), key
    for f in dataclasses.fields(b0.state):
        a, b = getattr(b0.state, f.name), getattr(b1.state, f.name)
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), f.name
    assert _lab_records(r0.decisions) == _lab_records(r1.decisions)


def test_measured_ticks_synchronize_and_unmeasured_do_not(cuda, monkeypatch):
    """A measured fleet tick synchronizes the device at each of its stage
    boundaries (two on a gated tick, four on a decided one); an
    unmeasured tick calls no synchronize, and its stage stamps make no
    sync under ``set_sync_debug_mode("error")``.  Decisions are the
    same."""
    from repro_torch.core import agent as A
    from repro_torch.core.fleet import FleetAgent, SimFleetPort
    from repro_torch.pfs.engine_torch import FusedEngine
    from repro_torch.pfs.workloads import table_from_sim

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        A.stage_clock(cuda, False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    model = _lab_model(cuda)
    syncs, records = {}, {}
    real = torch.cuda.synchronize
    for measure in (False, True):
        sim = _fleet_sim(cuda)
        fleet = FleetAgent(SimFleetPort(sim), model,
                           measure_overhead=measure, device=cuda)
        table, wstate = table_from_sim(sim)
        engine = FusedEngine(sim.params, sim.topo, table, 100)
        calls = []
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda device=None: (calls.append(device),
                                                 real(device)))
        per_tick = []
        for _ in range(6):
            sim.state, wstate = engine.run_interval(sim.state, wstate)
            n_before = len(calls)
            fleet.tick()
            per_tick.append(len(calls) - n_before)
        monkeypatch.setattr(torch.cuda, "synchronize", real)
        syncs[measure] = per_tick
        records[measure] = _lab_records(fleet.decisions)
    assert syncs[False] == [0] * 6
    assert set(syncs[True]) <= {2, 4} and 4 in syncs[True]
    assert records[False] == records[True]
    assert any(oscs for oscs, _, _, _ in records[True])


def test_several_card_mesh_equals_unsharded(cuda):
    """On a host with two or more cards: the lab bucket over
    ``fleet_mesh()`` (every card; padded to it), twice (the second run
    replays each card's cached graph), and one sim through
    ``run_fleet(backend="torch-sharded")``, bit-equal to the unsharded
    runs on the first card."""
    import dataclasses

    from repro_torch.distributed.sharding import fleet_mesh
    from repro_torch.lab.batch import run_batch

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    mesh = fleet_mesh()
    model = _lab_model(cuda)
    base_batch = _lab_bucket(cuda)
    base = run_batch(base_batch, model, seconds=3.0, fused=True)
    for _ in range(2):
        batch = _lab_bucket(cuda)
        got = run_batch(batch, model, seconds=3.0, fused=True, mesh=mesh)
        for key in base.trace:
            assert torch.equal(got.trace[key], base.trace[key]), key
        for f in dataclasses.fields(batch.state):
            a = getattr(base_batch.state, f.name)
            b = getattr(batch.state, f.name)
            assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), \
                f.name
    fused_sim, sharded_sim = _fleet_sim(cuda), _fleet_sim(cuda)
    fused = run_fleet(fused_sim, model, seconds=3.0, backend="torch-fused")
    sharded = run_fleet(sharded_sim, model, seconds=3.0,
                        backend="torch-sharded", mesh=mesh)
    assert _lab_records(sharded.decisions) == _lab_records(fused.decisions)
    assert torch.equal(sharded_sim.state.ctr_bytes_done,
                       fused_sim.state.ctr_bytes_done)


def test_lm_mesh_on_every_card_equals_one_card(cuda, tmp_path):
    """On a host with two or more cards, one process a card over NCCL
    (``chip_smoke.py``'s phase 14 machinery): the gemma2-2b smoke config
    sharded (data x model over every card; ZeRO-1 moments) against the
    same two steps on card 0 alone, within phase 14's bars (each
    first-batch gradient leaf against its norm, loss, grad norm, the
    parameters over the update), a save under the mesh re-placed on
    the transposed mesh bit-equal, and
    ``make_dp_train_grads`` compressed and plain over the data axis.
    With four cards, the 2 x 2 mesh at gemma2-2b's full width too."""
    import pathlib
    import sys

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import chip_smoke

    runs = [("gemma2-2b smoke", dict(smoke=True, batch=4, seq_len=64))]
    if n >= 4:
        runs.append(("gemma2-2b full", {}))
    for what, kw in runs:
        res = chip_smoke.run_mesh(str(tmp_path / what.replace(" ", "_")),
                                  0, **kw)
        assert res["world"] == n
        chip_smoke.check_mesh(res, torch.cuda.get_device_name(0), what)
        assert res["dp"]["compressed"]["wire_bytes"] * 4 == \
            res["dp"]["plain"]["wire_bytes"]


def test_sharded_serving_on_four_cards_matches_one_card(cuda, tmp_path):
    """On four cards, one process a card over NCCL: gemma2-2b,
    recurrentgemma-9b and falcon-mamba-7b at full width on 2 x 2 and
    1 x 4 (phase 8's 4 x 3,072 prompt tokens), and gemma2-2b at batch 1
    on 4 x 1 over a 32,768-position cache sharded on its sequence, each
    in bf16 and, from the same weights upcast, in float32, against the
    same serve on one card (``chip_smoke.run_serve_compare``): the
    prefill and 8 decode steps, every run fed one card's bf16 greedy
    tokens, so that every step is compared.  Every logit row within
    1e-3 of its RMS in float32; in bf16 within 5% of it -- or within
    twice one card's own bf16-vs-float32 distance at that step, where
    bf16 rounding alone moves one card further.  The greedy tokens
    identical at every step but where one card's top two lie within that
    step's bar of the RMS (a near tie); the first such step is
    printed."""
    import pathlib
    import sys

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import chip_smoke

    for r in chip_smoke.run_serve_compare(str(tmp_path / "serve"), 0):
        print(r)
        assert not r["steps_over_bar"] and not r["flips_without_tie"]
