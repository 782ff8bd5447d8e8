"""ctypes binding of ``csrc/flash_attention.cu`` (see its header note)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels import LAUNCHES

HEAD_DIMS = (16, 32, 64, 128, 256)   # the kernel's instantiations
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.library("flash_attention").flash_attention_fwd
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p]
                       + [ctypes.c_int] * 2 + [ctypes.c_float] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         softcap: float = 0.0) -> torch.Tensor:
    """Launch the attention kernel.

    q ``(B, Hq, Sq, D)``, k/v ``(B, Hkv, Skv, D)``, one dtype (float32 or
    bfloat16), any strides with a contiguous last axis (a cache slice is
    passed as a view).  Returns ``(B, Hq, Sq, D)`` in q's dtype, laid out
    ``(B, Sq, Hq, D)`` in memory (a transposed view).
    """
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention_cuda: q on {dev}, k on "
                         f"{k.device}, v on {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention_cuda: q, k, v must share a "
                         f"float32 or bfloat16 dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention_cuda: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    _, hkv, skv, dk = k.shape
    if k.shape[0] != b or dk != d or hq % hkv or d not in HEAD_DIMS \
            or sq < 1 or skv < 1 or b * hq > 65535:
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} not taken (head dims "
                         f"{HEAD_DIMS}, Hq % Hkv == 0)")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention_cuda: the head axis must be "
                         "contiguous")
    out = torch.empty((b, sq, hq, d), dtype=q.dtype,
                      device=dev).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    err = _entry()(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, hq, hkv, sq, skv, d, ctypes.addressof(strides),
        int(causal), int(window or 0), float(softcap), float(d ** -0.5),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["flash_attention"] += 1
    return out
