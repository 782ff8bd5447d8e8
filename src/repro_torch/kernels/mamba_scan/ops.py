"""The selective scan dispatched by device.

Every Mamba layer's prefill (``repro_torch/models/mamba.py``) goes
through :func:`selective_scan`, one call over the whole prompt.  A CUDA
tensor launches the hand-written kernel (``csrc/mamba_scan.cu``); a CPU
tensor takes the plain sequential loop.  Decode's one-step update stays
plain PyTorch, as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.mamba_scan.kernel import selective_scan_cuda
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref


def selective_scan(u, delta, A, B, C, D):
    """u, delta (Bt, S, Dm); A (Dm, N) float32; B, C (Bt, S, N); D (Dm,)
    float32.  u, delta, B and C share a dtype (float32 or bfloat16) and
    are read as float32.  Returns (y (Bt, S, Dm) float32, final state
    (Bt, Dm, N) float32)."""
    if u.device.type == "cpu":
        return selective_scan_ref(u, delta, A, B, C, D)
    return selective_scan_cuda(*(t.contiguous() for t in (u, delta, A, B,
                                                          C, D)))
