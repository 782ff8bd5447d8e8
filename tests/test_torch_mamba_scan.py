"""The port's selective scan (plain version and CPU dispatch) against the
reference's Pallas kernel in interpret mode and its sequential oracle,
on ``tests/test_kernels.py``'s cases at its bar (1e-4), and its final
state against a jnp scan that keeps the state (what the reference's
``lm._mamba_prefill`` runs).  The CUDA kernel's checks are in
``test_torch_cuda.py``.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.mamba_scan.ops import selective_scan as ref_scan  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.mamba_scan.ops import selective_scan  # noqa: E402


def _inputs(bt, s, dm, n, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(bt, s, dm)).astype(np.float32)
    delta = (np.abs(rng.normal(size=(bt, s, dm))) * 0.1).astype(np.float32)
    A = (-np.abs(rng.normal(size=(dm, n))) - 0.1).astype(np.float32)
    B = rng.normal(size=(bt, s, n)).astype(np.float32)
    C = rng.normal(size=(bt, s, n)).astype(np.float32)
    D = rng.normal(size=(dm,)).astype(np.float32)
    return u, delta, A, B, C, D


def _final_state(u, delta, A, B):
    def step(h, xs):
        u_t, d_t, b_t = xs
        return (jnp.exp(d_t[..., None] * A[None]) * h
                + (d_t * u_t)[..., None] * b_t[:, None, :]), None
    h0 = jnp.zeros((u.shape[0], u.shape[2], A.shape[1]), jnp.float32)
    h, _ = jax.lax.scan(step, h0, (jnp.moveaxis(u, 1, 0),
                                   jnp.moveaxis(delta, 1, 0),
                                   jnp.moveaxis(B, 1, 0)))
    return np.asarray(h)


# tests/test_kernels.py:99-101
@pytest.mark.parametrize("bt,s,dm,n,bd", [
    (2, 64, 128, 16, 64), (1, 33, 256, 8, 256), (3, 128, 64, 16, 64),
])
def test_plain_matches_pallas_interpret_ref_and_final_state(bt, s, dm, n, bd):
    args = _inputs(bt, s, dm, n)
    jargs = [jnp.asarray(a) for a in args]
    pal = np.asarray(ref_scan(*jargs, backend="pallas_interpret", block_d=bd))
    oracle = np.asarray(ref_scan(*jargs, backend="ref"))
    n0 = sum(LAUNCHES.values())
    y, h = selective_scan(*(torch.as_tensor(a) for a in args))
    assert sum(LAUNCHES.values()) == n0
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (bt, s, dm) and h.shape == (bt, dm, n)
    np.testing.assert_allclose(y.numpy(), pal, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(y.numpy(), oracle, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h.numpy(), _final_state(*jargs[:4]),
                               rtol=1e-4, atol=1e-4)


def test_bf16_inputs_are_read_as_float32():
    """The model passes bf16 u, delta, B, C: the same values as float32
    give the same result exactly."""
    args = list(_inputs(2, 20, 32, 8, seed=1))
    t = [torch.as_tensor(a) for a in args]
    for i in (0, 1, 3, 4):
        t[i] = t[i].to(torch.bfloat16)
    y, h = selective_scan(*t)
    y32, h32 = selective_scan(*(a.float() for a in t))
    assert torch.equal(y, y32) and torch.equal(h, h32)
