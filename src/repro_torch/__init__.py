"""DIAL on PyTorch and CUDA: the closed tuning loop on one NVIDIA GPU.

A port of the JAX package ``repro`` (which stays the reference).  This
slice carries DIAL's main path: the PFS engine interval (float64, every
segment reduction through the hand-written ``segment_sum`` kernel), the
fleet probe, the designed metrics, GBDT scoring of every (interface x θ)
row through the hand-written paired-forest kernel, Algorithm 1 and the
knob write-back -- all on the device.

Entry points take ``device=None``, which means ``torch.device("cuda")``;
without a card they raise.  The CPU is used only when the caller passes
``device="cpu"``, and then each kernel wrapper runs its plain PyTorch
version (the tests' path).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card; raise when a CUDA device is unavailable.

    A CUDA device comes back with its index (``cuda`` -> ``cuda:0``), as
    the tensors made on it report it, so devices compare equal.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch needs a CUDA device (none is available); pass "
                "device='cpu' explicitly to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
