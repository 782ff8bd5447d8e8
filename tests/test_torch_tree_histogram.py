"""The port's training histograms against the reference's oracles.

The plain version (and the CPU dispatch) must be bit-equal to
``tree_histogram_np`` in float64: both sum every cell in ascending
sample order.  In float32 it is held against the Pallas kernel in
interpret mode within 1e-6 of the largest |cell| (the reference's own
kernel bar; float32 sums in another order).  The bin index must equal
the reference's ``sort_structs``.  The CUDA kernel's checks are in
``test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.kernels.tree_histogram.kernel import \
    tree_histogram as pallas_histogram  # noqa: E402
from repro.kernels.tree_histogram.ref import tree_histogram_np  # noqa: E402
from repro.learn.boost import sort_structs  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.tree_histogram.kernel import (  # noqa: E402
    add_chain_cuda, tree_histogram_cuda)
from repro_torch.kernels.tree_histogram.ops import (BinIndex, sort_index,  # noqa: E402
                                                    tree_histogram)
from repro_torch.kernels.tree_histogram.ref import tree_histogram_ref  # noqa: E402

# (n, F, n_nodes, n_bins, C, node ids drawn from [0, n_nodes + extra))
CASES = {
    "learn_oracle": (2500, 7, 8, 12, 3, 0),     # tests/test_learn.py:60
    "drop_id": (600, 3, 4, 8, 2, 1),            # tests/test_learn.py:78
    "level": (5000, 36, 8, 48, 2, 1),           # a depth-4 level, F padded
}


def _case(name, seed=0):
    n, f, n_nodes, n_bins, c, extra = CASES[name]
    rng = np.random.default_rng(seed)
    values = rng.normal(size=(c, n)) * 10.0 ** rng.uniform(-3, 3, size=n)
    bins = rng.integers(0, n_bins, size=(n, f))
    node = rng.integers(0, n_nodes + extra, size=n)
    return values, bins, node, n_nodes, n_bins


def _index(bins, n_bins):
    return BinIndex.build(torch.as_tensor(bins, dtype=torch.int32)[None],
                          n_bins)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_and_dispatch_bit_equal_to_numpy_oracle(name):
    values, bins, node, n_nodes, n_bins = _case(name)
    want = tree_histogram_np(values, bins, node, n_nodes, n_bins)
    v = torch.as_tensor(values)[None]
    nd = torch.as_tensor(node, dtype=torch.int32)[None]
    plain = tree_histogram_ref(v, torch.as_tensor(bins)[None], nd, n_nodes,
                               n_bins)
    got = tree_histogram(v, _index(bins, n_bins), nd, n_nodes)
    for out in (plain, got):
        assert out.dtype == torch.float64
        assert tuple(out.shape) == (1,) + want.shape
        np.testing.assert_array_equal(out[0].numpy().view(np.int64),
                                      want.view(np.int64))


@pytest.mark.parametrize("name", sorted(CASES))
def test_float32_matches_pallas_interpret(name):
    values, bins, node, n_nodes, n_bins = _case(name, seed=1)
    v32 = values.astype(np.float32)
    want = np.asarray(pallas_histogram(v32, bins, node, n_nodes, n_bins,
                                       interpret=True))
    got = tree_histogram(torch.as_tensor(v32)[None], _index(bins, n_bins),
                         torch.as_tensor(node, dtype=torch.int32)[None],
                         n_nodes)
    assert got.dtype == torch.float32
    scale = np.abs(want).max()
    assert np.abs(got[0].numpy() - want).max() <= 1e-6 * scale


def test_batch_axis_is_independent_forests():
    """A batch of two datasets equals each run alone (the read/write pair
    shares one launch per level)."""
    a, b = _case("learn_oracle", seed=2), _case("learn_oracle", seed=3)
    n_nodes, n_bins = a[3], a[4]
    index = BinIndex.build(torch.as_tensor(np.stack([a[1], b[1]]),
                                           dtype=torch.int32), n_bins)
    got = tree_histogram(
        torch.as_tensor(np.stack([a[0], b[0]])), index,
        torch.as_tensor(np.stack([a[2], b[2]]), dtype=torch.int32), n_nodes)
    for i, (values, bins, node, _, _) in enumerate((a, b)):
        np.testing.assert_array_equal(
            got[i].numpy(), tree_histogram_np(values, bins, node, n_nodes,
                                              n_bins))


def test_unwalked_features_sum_to_zero():
    """Features outside the index's ``walk`` mask get 0 in every cell;
    the walked ones stay bit-equal to the numpy oracle."""
    values, bins, node, n_nodes, n_bins = _case("level")
    walk = np.arange(bins.shape[1]) % 3 != 1
    want = tree_histogram_np(values, bins, node, n_nodes, n_bins)
    want[:, :, ~walk] = 0.0
    index = BinIndex.build(torch.as_tensor(bins, dtype=torch.int32)[None],
                           n_bins, torch.as_tensor(walk)[None])
    got = tree_histogram(torch.as_tensor(values)[None], index,
                         torch.as_tensor(node, dtype=torch.int32)[None],
                         n_nodes)
    np.testing.assert_array_equal(got[0].numpy().view(np.int64),
                                  want.view(np.int64))
    with pytest.raises(ValueError, match="walk"):
        BinIndex.build(index.bins, n_bins, torch.as_tensor(walk))


@pytest.mark.parametrize("n_bins", [1, 12, 48])
def test_bin_index_equals_reference_sort_structs(n_bins):
    rng = np.random.default_rng(n_bins)
    # few distinct codes per feature, as quantile bins of knob columns give
    bins = rng.integers(0, max(n_bins // 3, 1), size=(777, 5)).astype(np.int32)
    perm, bnd = sort_structs(bins, n_bins)
    got_perm, got_bnd = sort_index(torch.as_tensor(bins)[None], n_bins)
    np.testing.assert_array_equal(got_perm[0].numpy(), perm)
    np.testing.assert_array_equal(got_bnd[0].numpy(), bnd)
    assert _index(bins, n_bins).perm is None     # the CPU reads bins only
    with pytest.raises(ValueError, match="outside"):
        _index(bins + n_bins, n_bins)


def test_cpu_path_launches_nothing_and_kernel_refuses_cpu():
    values, bins, node, n_nodes, n_bins = _case("drop_id")
    index = _index(bins, n_bins)
    v = torch.as_tensor(values)[None]
    nd = torch.as_tensor(node, dtype=torch.int32)[None]
    LAUNCHES.clear()
    tree_histogram(v, index, nd, n_nodes)
    assert LAUNCHES["tree_histogram"] == 0
    with pytest.raises(ValueError, match="values on cpu"):
        tree_histogram_cuda(v, *sort_index(index.bins, n_bins), nd, n_nodes)


def test_order_bound_probe_refuses_cpu():
    """The order bound's probe runs on the card only, and counts no
    launch (it ports no TPU kernel)."""
    LAUNCHES.clear()
    with pytest.raises(ValueError, match="add_chain_cuda"):
        add_chain_cuda(torch.zeros(8, dtype=torch.float64), 100)
    assert not LAUNCHES
