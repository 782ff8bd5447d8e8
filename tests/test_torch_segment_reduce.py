"""The port's segment sum against the reference's oracle and Pallas kernel.

The plain float64 version (``index_add_``, one column or several) must be
bit-equal to ``np.bincount`` on the CPU, column by column; the Pallas
kernel casts to float32, so it is held at rtol 1e-5 (atol 1e-4, the bar
of the reference's own test).
The CUDA kernel's own checks are in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.segment_reduce.kernel import segment_sum as pallas_ss  # noqa: E402
from repro.kernels.segment_reduce.ops import segment_sum_np  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.segment_reduce.kernel import segment_sum_cuda  # noqa: E402
from repro_torch.kernels.segment_reduce.ops import SegmentMap, segment_sum  # noqa: E402

# (entries, segments): uniform, the engine's skewed OST map, many
# near-empty segments (the stripe scatter)
CASES = [(37, 4), (1024, 8), (8192, 32), (640, 8192), (5000, 33)]


def _data(e, s, seed):
    rng = np.random.default_rng(seed)
    values = rng.standard_normal(e) * 10.0 ** rng.uniform(-3, 9, size=e)
    return values, rng.integers(0, s, size=e)


@pytest.mark.parametrize("e,s", CASES)
def test_plain_bit_equal_to_bincount(e, s):
    values, ids = _data(e, s, e)
    got = segment_sum(torch.as_tensor(values), SegmentMap.build(ids, s, "cpu"))
    want = segment_sum_np(values, ids, s)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy().view(np.int64),
                                  want.view(np.int64))


@pytest.mark.parametrize("e,s", [(37, 4), (1024, 8), (5000, 33)])
def test_plain_matches_pallas_interpret(e, s):
    rng = np.random.default_rng(e)
    values = rng.normal(size=e).astype(np.float32)
    ids = rng.integers(0, s, size=e)
    got = segment_sum(torch.as_tensor(values.astype(np.float64)),
                      SegmentMap.build(ids, s, "cpu")).numpy()
    pal = np.asarray(pallas_ss(jnp.asarray(values), jnp.asarray(ids), s,
                               block_e=256, interpret=True))
    np.testing.assert_allclose(got, pal, rtol=1e-5, atol=1e-4)


def test_out_of_range_ids_dropped():
    rng = np.random.default_rng(3)
    s = 6
    ids = rng.integers(-2, s + 3, size=300)
    values = rng.normal(size=300)
    got = segment_sum(torch.as_tensor(values),
                      SegmentMap.build(ids, s, "cpu")).numpy()
    keep = (ids >= 0) & (ids < s)
    want = segment_sum_np(values[keep], ids[keep], s)
    np.testing.assert_array_equal(got, want)
    pal = np.asarray(pallas_ss(jnp.asarray(values.astype(np.float32)),
                               jnp.asarray(np.where(ids < 0, s, ids)), s,
                               block_e=128, interpret=True))
    np.testing.assert_allclose(got, pal, rtol=1e-5, atol=1e-4)


def test_empty_segments_and_no_entries():
    got = segment_sum(torch.tensor([1.5, -2.0, 4.0], dtype=torch.float64),
                      SegmentMap.build([1, 1, 4], 7, "cpu")).numpy()
    np.testing.assert_array_equal(got, [0.0, -0.5, 0.0, 0.0, 4.0, 0.0, 0.0])
    empty = SegmentMap.build(np.zeros(0, dtype=np.int64), 5, "cpu")
    got = segment_sum(torch.zeros(0, dtype=torch.float64), empty)
    np.testing.assert_array_equal(got.numpy(), np.zeros(5))
    np.testing.assert_array_equal(empty.offsets.numpy(), np.zeros(6))


def test_segment_map_csr_is_stable_order():
    ids = np.array([2, 0, 2, 1, 9, 0, 2, -1])
    smap = SegmentMap.build(ids, 3, "cpu")
    # positions of segment 0, then 1, then 2, each ascending; 9 and -1 gone
    np.testing.assert_array_equal(smap.order.numpy(), [1, 5, 3, 0, 2, 6])
    np.testing.assert_array_equal(smap.offsets.numpy(), [0, 2, 3, 6])
    assert smap.order.dtype == smap.offsets.dtype == torch.int32
    assert smap.n_entries == len(ids)


def test_cpu_path_launches_nothing_and_kernel_refuses_cpu():
    smap = SegmentMap.build([0, 1, 1], 2, "cpu")
    before = dict(LAUNCHES)
    segment_sum(torch.ones(3, dtype=torch.float64), smap)
    assert dict(LAUNCHES) == before
    with pytest.raises(ValueError, match="values on cpu"):
        segment_sum_cuda(torch.ones(3, dtype=torch.float64), smap)


# (entries, segments, columns): one, three and eleven columns (more than
# the kernel's eight a warp), near-empty segments, out-of-range ids, E = 0
MULTI = [(37, 4, 1), (1024, 8, 3), (640, 8192, 3), (5000, 33, 11),
         (300, 6, 11), (0, 5, 3)]


@pytest.mark.parametrize("e,s,k", MULTI)
def test_multi_column_plain_bit_equal_to_bincount_and_pallas(e, s, k):
    rng = np.random.default_rng(e + s + k)
    ids = rng.integers(-2, s + 3, size=e)
    values = rng.standard_normal((k, e)) * 10.0 ** rng.uniform(-3, 9, (k, e))
    smap = SegmentMap.build(ids, s, "cpu")
    got = segment_sum(torch.as_tensor(values), smap).numpy()
    assert got.shape == (k, s)
    keep = (ids >= 0) & (ids < s)
    for col in range(k):
        want = np.bincount(ids[keep], weights=values[col][keep], minlength=s)
        np.testing.assert_array_equal(got[col].view(np.int64),
                                      want.view(np.int64))
        # the same column through the 1-D form
        one = segment_sum(torch.as_tensor(values[col]), smap).numpy()
        np.testing.assert_array_equal(one.view(np.int64),
                                      got[col].view(np.int64))
    if e == 0:
        np.testing.assert_array_equal(got, np.zeros((k, s)))
        return
    small = rng.normal(size=(k, e)).astype(np.float32)
    got32 = segment_sum(torch.as_tensor(small.astype(np.float64)),
                        smap).numpy()
    for col in range(k):
        pal = np.asarray(pallas_ss(jnp.asarray(small[col]),
                                   jnp.asarray(np.where(ids < 0, s, ids)), s,
                                   block_e=256, interpret=True))
        np.testing.assert_allclose(got32[col], pal, rtol=1e-5, atol=1e-4)


def test_segment_map_max_len():
    assert SegmentMap.build([2, 0, 2, 1, 9, 2, -1], 3, "cpu").max_len == 3
    assert SegmentMap.build(np.zeros(0, dtype=np.int64), 4, "cpu").max_len \
        == 0
    assert SegmentMap.build([5, 6], 3, "cpu").max_len == 0
