"""The correctly rounded float64 power (``kernels/pow_cr``), the card's
congestion factor in the PFS engine, on the CPU.

Its plain version runs the kernel's double-double steps; here it is held
against a 60-digit ``decimal`` evaluation: on 100,000 inputs over the
engine's range every result is the double nearest ``x ** e``, where
libm's ``pow`` (``math.pow``) is off by more than half an ulp on a
fraction of a percent of them and numpy's ``power`` (vectorized, SVML on
an AVX-512 host) on some percent.  The kernel itself is held against
this plain version bit for bit on the card (``test_torch_cuda.py``).
"""

import math
from decimal import Decimal, getcontext

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.pow_cr.kernel import pow_cr_cuda  # noqa: E402
from repro_torch.kernels.pow_cr.ref import pow_cr_ref  # noqa: E402


def _nearest(x: float, e: float):
    """A test of ``y``: is it the double nearest the exact ``x ** e``
    (60 digits)?"""
    getcontext().prec = 60
    exact = (Decimal(x).ln() * Decimal(e)).exp()
    return lambda y: abs(Decimal(y) - exact) <= Decimal(math.ulp(y)) / 2


@pytest.mark.parametrize("e", [0.35, 0.5, 1.7])
def test_plain_version_rounds_correctly(e):
    """Over 1e-5 .. 7e7 (the engine's buffer / queued): equal to libm's
    ``pow`` but where libm is not nearest, and then nearest itself."""
    rng = np.random.default_rng(11)
    x = np.exp(rng.uniform(np.log(1e-5), np.log(7e7), 100_000))
    got = pow_cr_ref(torch.from_numpy(x), e).numpy()
    libm = np.array([math.pow(v, e) for v in x])
    differ = np.nonzero(got != libm)[0]
    assert len(differ) < 300            # 0.08% of inputs observed
    for i in differ:
        near = _nearest(float(x[i]), e)
        assert near(float(got[i])) and not near(float(libm[i])), x[i]
    for i in rng.choice(len(x), 200, replace=False):   # and a sample
        assert _nearest(float(x[i]), e)(float(got[i]))


def test_plain_version_edges():
    x = torch.tensor([1.0, 0.5, 2.0 ** -20, 64.0], dtype=torch.float64)
    got = pow_cr_ref(x, 0.5)
    assert got.tolist() == [1.0, math.sqrt(0.5), 2.0 ** -10, 8.0]


def test_kernel_wrapper_checks_inputs():
    with pytest.raises(ValueError, match="float64 CUDA"):
        pow_cr_cuda(torch.ones(3, dtype=torch.float64), 0.35)
