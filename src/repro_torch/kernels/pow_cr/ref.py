"""Plain PyTorch version of ``csrc/pow_cr.cu``: the correctly rounded
float64 ``x ** e`` by the same double-double steps (exact products by
Dekker's splitting, where the kernel uses an FMA; both give the exact
error term, so the two agree bit for bit).  It checks the kernel; the
engine's CPU path calls numpy's ``power``, the reference's own.
"""

from __future__ import annotations

import torch

_SPLIT = 134217729.0                       # 2^27 + 1
_NEG_LN2 = (-0.6931471805599453, -2.3190468138462996e-17)
_SIXTH = (1.0 / 6.0, 9.25185853854297e-18)


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _quick_two_sum(a, b):
    s = a + b
    return s, b - (s - a)


def _split(a):
    c = _SPLIT * a
    h = c - (c - a)
    return h, a - h


def _two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _add(a, b):
    sh, sl = _two_sum(a[0], b[0])
    th, tl = _two_sum(a[1], b[1])
    uh, ul = _quick_two_sum(sh, sl + th)
    return _quick_two_sum(uh, ul + tl)


def _mul(a, b):
    ph, pl = _two_prod(a[0], b[0])
    return _quick_two_sum(ph, pl + (a[0] * b[1] + a[1] * b[0]))


def _mul_d(a, d):
    ph, pl = _two_prod(a[0], d)
    return _quick_two_sum(ph, pl + a[1] * d)


def _exp(z):
    k = torch.round(z[0] / -_NEG_LN2[0])        # half to even, as rint
    r = _add(z, _mul_d(_NEG_LN2, k))
    r = (r[0] * 2.0 ** -10, r[1] * 2.0 ** -10)
    r2 = _mul(r, r)
    r3, r4 = _mul(r2, r), _mul(r2, r2)
    h = r[0]
    tail = 1.0 / 24.0 + h * (1.0 / 120.0 + h * (1.0 / 720.0 + h * (
        1.0 / 5040.0 + h * (1.0 / 40320.0 + h / 362880.0))))
    em1 = _add(r, _mul_d(r2, 0.5))
    em1 = _add(em1, _mul(r3, _SIXTH))
    em1 = _add(em1, _mul_d(r4, tail))
    for _ in range(10):                          # (1 + m)^2 = 1 + 2m + m^2
        em1 = _add(_mul_d(em1, 2.0), _mul(em1, em1))
    one = torch.ones_like(em1[0])
    hi, lo = _add((one, torch.zeros_like(one)), em1)
    scale = torch.pow(2.0, k)                    # exact: k is an integer
    return hi * scale, lo * scale


def pow_cr_ref(x: torch.Tensor, e: float) -> torch.Tensor:
    """Correctly rounded ``x ** e`` for float64 x > 0 (the engine's
    congestion factor), elementwise."""
    x = x.double()
    zero = torch.zeros_like(x)
    l0 = torch.log(x)
    ex = _exp((-l0, zero))
    t = _add(_mul_d(ex, x), (-torch.ones_like(x), zero))
    z = _mul_d(_add((l0, zero), t), e)
    out = _exp(z)[0]
    return torch.where(x == 1.0, 1.0, out)
