"""Plain PyTorch RG-LRU recurrence: a sequential loop over time.

    h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * x_t,   h_{-1} = 0

The reference (``repro/kernels/rglru_scan/ref.py::rglru_ref``) runs the
associative scan, which sums in another order (ROADMAP's bar: 1e-4).
"""

from __future__ import annotations

import torch


def rglru_ref(x, a):
    """x, a: (B, S, W).  Returns every h_t, (B, S, W) float32."""
    x = x.float()
    a = a.float()
    bx = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0)) * x
    h = torch.zeros_like(x[:, 0])
    out = torch.empty_like(x)
    for t in range(x.shape[1]):
        h = a[:, t] * h + bx[:, t]
        out[:, t] = h
    return out
