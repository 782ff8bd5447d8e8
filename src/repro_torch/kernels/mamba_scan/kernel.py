"""ctypes binding of ``csrc/mamba_scan.cu`` (see its header note)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels import LAUNCHES, refuse_grad

STATE_SIZES = (4, 8, 16)   # the kernel's instantiations of N
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.library("mamba_scan").selective_scan_fwd
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def selective_scan_cuda(u, delta, A, B, C, D):
    """Launch the selective scan on contiguous tensors: u, delta ``(Bt, S,
    Dm)``, B, C ``(Bt, S, N)`` of one dtype (float32 or bfloat16), A
    ``(Dm, N)`` and D ``(Dm,)`` float32.  Returns y ``(Bt, S, Dm)`` and the
    final state ``(Bt, Dm, N)``, both float32.  Raises ``RuntimeError`` on
    inputs that require a gradient (the kernel has no backward)."""
    refuse_grad("selective_scan_cuda", u, delta, A, B, C, D)
    dev = u.device
    if dev.type != "cuda":
        raise ValueError(f"selective_scan_cuda: u on {dev}")
    bt, s, dm = u.shape
    n = A.shape[-1]
    want = {"u": (u, u.dtype, (bt, s, dm)), "delta": (delta, u.dtype,
                                                      (bt, s, dm)),
            "A": (A, torch.float32, (dm, n)), "B": (B, u.dtype, (bt, s, n)),
            "C": (C, u.dtype, (bt, s, n)), "D": (D, torch.float32, (dm,))}
    for name, (t, dtype, shape) in want.items():
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"selective_scan_cuda: {name} must be a "
                             f"contiguous {dtype} {shape} tensor on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if u.dtype not in _DTYPES or n not in STATE_SIZES or s < 1 \
            or bt > 65535:
        raise ValueError(f"selective_scan_cuda: dtype {u.dtype}, N={n}, "
                         f"Bt={bt} not taken (N in {STATE_SIZES})")
    y = torch.empty((bt, s, dm), dtype=torch.float32, device=dev)
    h = torch.empty((bt, dm, n), dtype=torch.float32, device=dev)
    err = _entry()(_DTYPES[u.dtype], u.data_ptr(), delta.data_ptr(),
                   A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(),
                   y.data_ptr(), h.data_ptr(), bt, s, dm, n,
                   torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"selective_scan_fwd launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["selective_scan"] += 1
    return y, h
