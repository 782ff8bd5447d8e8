"""ctypes binding of ``csrc/segment_sum.cu`` (see its header note)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels import LAUNCHES

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.library("segment_sum").segment_sum_f64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] \
            + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def segment_sum_cuda(values: torch.Tensor, smap) -> torch.Tensor:
    """Launch the ordered float64 segment sum of ``values`` over ``smap``:
    ``(E,)`` gives ``(S,)``, ``(K, E)`` gives ``(K, S)`` (each row its own
    ordered sum, all in one launch)."""
    if values.device.type != "cuda" or smap.order.device != values.device:
        raise ValueError(f"segment_sum_cuda: values on {values.device}, "
                         f"map on {smap.order.device}")
    if values.dtype != torch.float64 or values.dim() not in (1, 2) \
            or not values.is_contiguous():
        raise ValueError("segment_sum_cuda: values must be contiguous 1-D or "
                         f"2-D float64, got {values.dtype} "
                         f"{tuple(values.shape)}")
    if values.shape[-1] != smap.n_entries:
        raise ValueError(f"segment_sum_cuda: {values.shape[-1]} values for a "
                         f"map of {smap.n_entries} entries")
    n_cols = values.shape[0] if values.dim() == 2 else 1
    out = torch.empty((*values.shape[:-1], smap.num_segments),
                      dtype=torch.float64, device=values.device)
    if smap.num_segments and n_cols:
        err = _entry()(values.data_ptr(), smap.n_entries,
                       smap.order.data_ptr(), smap.offsets.data_ptr(),
                       out.data_ptr(), smap.num_segments, n_cols,
                       smap.max_len,
                       torch.cuda.current_stream(values.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"segment_sum_f64 launch failed: CUDA error "
                               f"{err}")
        LAUNCHES["segment_sum"] += 1
    return out
