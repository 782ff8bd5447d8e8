"""The port's RG-LRU scan (plain version and CPU dispatch) against the
reference's Pallas kernel in interpret mode and its associative-scan
oracle, on ``tests/test_kernels.py``'s cases at its bar (1e-4: the
associative scan sums in another order).  The CUDA kernel's checks are
in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.rglru_scan.ops import rglru as ref_rglru  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.rglru_scan.ops import rglru  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_ref  # noqa: E402


def _inputs(bt, s, dm, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bt, s, dm)).astype(np.float32)
    a = (1 / (1 + np.exp(-rng.normal(size=(bt, s, dm))))).astype(np.float32)
    return x, a


# tests/test_kernels.py:117-119
@pytest.mark.parametrize("bt,s,dm,bd", [
    (2, 64, 128, 64), (1, 100, 256, 128), (4, 17, 64, 64),
])
def test_plain_matches_pallas_interpret_and_ref(bt, s, dm, bd):
    x, a = _inputs(bt, s, dm)
    pal = np.asarray(ref_rglru(jnp.asarray(x), jnp.asarray(a),
                               backend="pallas_interpret", block_d=bd))
    oracle = np.asarray(ref_rglru(jnp.asarray(x), jnp.asarray(a),
                                  backend="ref"))
    n0 = sum(LAUNCHES.values())
    got = rglru(torch.as_tensor(x), torch.as_tensor(a))
    assert sum(LAUNCHES.values()) == n0
    assert got.dtype == torch.float32 and got.shape == (bt, s, dm)
    np.testing.assert_allclose(got.numpy(), pal, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-4, atol=1e-4)


def test_plain_is_the_sequential_recurrence():
    """The float32 recurrence step by step (numpy), including gates at 0
    and 1 (the clamp of 1 - a^2), within 1e-6: a vectorized CPU kernel
    may fuse the multiply-add that numpy rounds twice."""
    x, a = _inputs(2, 50, 8, seed=1)
    a[0, 3] = 1.0
    a[1, 7] = 0.0
    h = np.zeros((2, 8), np.float32)
    want = []
    for t in range(50):
        b = np.sqrt(np.maximum(np.float32(1) - a[:, t] * a[:, t],
                               np.float32(0))) * x[:, t]
        h = a[:, t] * h + b
        want.append(h)
    got = rglru_ref(torch.as_tensor(x), torch.as_tensor(a)).numpy()
    np.testing.assert_allclose(got, np.stack(want, axis=1), rtol=1e-6,
                               atol=1e-6)
