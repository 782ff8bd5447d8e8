"""ctypes binding of ``csrc/rglru_scan.cu`` (see its header note)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels import LAUNCHES, refuse_grad

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.library("rglru_scan").rglru_scan_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def rglru_cuda(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Launch the RG-LRU scan on contiguous float32 ``(B, S, W)`` x and a;
    returns every state, ``(B, S, W)`` float32.  Raises ``RuntimeError``
    on inputs that require a gradient (the kernel has no backward)."""
    refuse_grad("rglru_cuda", x, a)
    dev = x.device
    if dev.type != "cuda" or a.device != dev:
        raise ValueError(f"rglru_cuda: x on {dev}, a on {a.device}")
    for name, t in (("x", x), ("a", a)):
        if t.dtype != torch.float32 or t.dim() != 3 \
                or t.shape != x.shape or not t.is_contiguous():
            raise ValueError(f"rglru_cuda: {name} must be a contiguous "
                             f"float32 {tuple(x.shape)} tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    b, s, w = x.shape
    if s < 1 or b * w >= 2 ** 31:
        raise ValueError(f"rglru_cuda: shape {tuple(x.shape)} not taken")
    out = torch.empty_like(x)
    err = _entry()(x.data_ptr(), a.data_ptr(), out.data_ptr(), b, s, w,
                   torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan_f32 launch failed: CUDA error {err}")
    LAUNCHES["rglru_scan"] += 1
    return out
