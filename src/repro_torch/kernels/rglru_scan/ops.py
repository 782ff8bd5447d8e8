"""The RG-LRU scan dispatched by device.

The recurrent layers' prefill (``repro_torch/models/rglru.py``) goes
through :func:`rglru`.  A CUDA tensor launches the hand-written kernel
(``csrc/rglru_scan.cu``); a CPU tensor takes the plain sequential loop.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rglru_scan.kernel import rglru_cuda
from repro_torch.kernels.rglru_scan.ref import rglru_ref


def rglru(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """x, a: (B, S, W) float32 -> every state h_t, (B, S, W) float32."""
    if x.device.type == "cpu":
        return rglru_ref(x, a)
    return rglru_cuda(x.contiguous(), a.contiguous())
