"""ctypes binding of ``csrc/pow_cr.cu`` (see its header note)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels import LAUNCHES

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.library("pow_cr").pow_cr_f64
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_double,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def pow_cr_cuda(x: torch.Tensor, e: float) -> torch.Tensor:
    """Launch the correctly rounded ``x ** e`` on a contiguous float64
    CUDA tensor; returns a new tensor of x's shape."""
    if x.device.type != "cuda" or x.dtype != torch.float64 \
            or not x.is_contiguous():
        raise ValueError(f"pow_cr_cuda: x must be a contiguous float64 CUDA "
                         f"tensor, got {x.dtype} on {x.device}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"pow_cr_cuda: {x.numel()} elements not taken")
    out = torch.empty_like(x)
    if x.numel():
        err = _entry()(x.data_ptr(), out.data_ptr(), float(e), x.numel(),
                       torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"pow_cr_f64 launch failed: CUDA error {err}")
        LAUNCHES["pow_cr"] += 1
    return out
