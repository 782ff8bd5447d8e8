"""Plain PyTorch Mamba-1 selective scan: a sequential loop over time.

Per (batch, channel d, state n):
    h_t = exp(delta_t * A) * h_{t-1} + (delta_t * u_t) * B_t
    y_t = (h_t . C_t) + D * u_t
as the reference's ``repro/kernels/mamba_scan/ref.py::selective_scan_ref``
computes it, plus the final state, which the reference's prefill gets
from a second scan (``repro/models/lm.py::_mamba_prefill``).
"""

from __future__ import annotations

import torch


def selective_scan_ref(u, delta, A, B, C, D):
    """u, delta (Bt, S, Dm); A (Dm, N); B, C (Bt, S, N); D (Dm,).

    Inputs are read as float32.  Returns y (Bt, S, Dm) float32 and the
    final state (Bt, Dm, N) float32.
    """
    u, delta, A, B, C, D = (t.float() for t in (u, delta, A, B, C, D))
    bt, s, dm = u.shape
    h = torch.zeros((bt, dm, A.shape[1]), dtype=torch.float32,
                    device=u.device)
    y = torch.empty((bt, s, dm), dtype=torch.float32, device=u.device)
    for t in range(s):
        d_t, u_t = delta[:, t], u[:, t]
        h = torch.exp(d_t[:, :, None] * A) * h \
            + (d_t * u_t)[:, :, None] * B[:, t, None, :]
        y[:, t] = torch.einsum("bdn,bn->bd", h, C[:, t]) + D * u_t
    return y, h
