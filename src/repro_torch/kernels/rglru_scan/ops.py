"""The RG-LRU scan dispatched by device.

The recurrent layers' prefill (``repro_torch/models/rglru.py``) goes
through :func:`rglru`, the custom operator ``repro_torch::rglru``: a
CUDA tensor launches the hand-written kernel (``csrc/rglru_scan.cu``),
a CPU tensor takes the plain sequential loop, and a fake tensor (the
dry-run's, :mod:`repro_torch.launch.dryrun`) gets its output shape from
the operator's fake function, never entering the loop.
"""

from __future__ import annotations

import torch
from torch import Tensor

from repro_torch.kernels.rglru_scan.kernel import rglru_cuda
from repro_torch.kernels.rglru_scan.ref import rglru_ref


@torch.library.custom_op("repro_torch::rglru", mutates_args=())
def _rglru(x: Tensor, a: Tensor) -> Tensor:
    if x.device.type == "cpu":
        return rglru_ref(x, a)
    return rglru_cuda(x.contiguous(), a.contiguous())


@_rglru.register_fake
def _(x, a):
    return x.new_empty(x.shape, dtype=torch.float32)


def rglru(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """x, a: (B, S, W) float32 -> every state h_t, (B, S, W) float32."""
    return _rglru(x, a)
