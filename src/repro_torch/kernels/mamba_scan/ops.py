"""The selective scan dispatched by device.

Every Mamba layer's prefill (``repro_torch/models/mamba.py``) goes
through :func:`selective_scan`, one call over the whole prompt.  It is
the custom operator ``repro_torch::selective_scan``: a CUDA tensor
launches the hand-written kernel (``csrc/mamba_scan.cu``), a CPU tensor
takes the plain sequential loop, and a fake tensor (the dry-run's,
:mod:`repro_torch.launch.dryrun`) gets its output shapes from the
operator's fake function, never entering the loop.  Decode's one-step
update stays plain PyTorch, as in the reference.
"""

from __future__ import annotations

import torch
from torch import Tensor

from repro_torch.kernels.mamba_scan.kernel import selective_scan_cuda
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref


@torch.library.custom_op("repro_torch::selective_scan", mutates_args=())
def _selective_scan(u: Tensor, delta: Tensor, A: Tensor, B: Tensor,
                    C: Tensor, D: Tensor) -> tuple[Tensor, Tensor]:
    if u.device.type == "cpu":
        return selective_scan_ref(u, delta, A, B, C, D)
    return selective_scan_cuda(*(t.contiguous() for t in (u, delta, A, B,
                                                          C, D)))


@_selective_scan.register_fake
def _(u, delta, A, B, C, D):
    return (u.new_empty(u.shape, dtype=torch.float32),
            u.new_empty((u.shape[0], u.shape[2], A.shape[1]),
                        dtype=torch.float32))


def selective_scan(u, delta, A, B, C, D):
    """u, delta (Bt, S, Dm); A (Dm, N) float32; B, C (Bt, S, N); D (Dm,)
    float32.  u, delta, B and C share a dtype (float32 or bfloat16) and
    are read as float32.  Returns (y (Bt, S, Dm) float32, final state
    (Bt, Dm, N) float32)."""
    return _selective_scan(u, delta, A, B, C, D)
