"""ctypes binding of ``csrc/tree_histogram.cu`` (see its header note)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels import LAUNCHES

MAX_CHANNELS = 4   # the kernel's shared-memory staging width
_ENTRIES = {torch.float64: "tree_histogram_f64",
            torch.float32: "tree_histogram_f32"}
_fns: dict = {}


def _entry(dtype):
    fn = _fns.get(dtype)
    if fn is None:
        fn = getattr(_build.library("tree_histogram"), _ENTRIES[dtype])
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"tree_histogram kernel: {name} must be a contiguous {dtype} "
            f"{shape} tensor on {device}, got {t.dtype} {tuple(t.shape)} "
            f"on {t.device}")


def tree_histogram_cuda(values: torch.Tensor, perm: torch.Tensor,
                        bnd: torch.Tensor, node: torch.Tensor,
                        n_nodes: int) -> torch.Tensor:
    """Launch the ordered histogram kernel.

    ``values`` ``(B, C, n)`` float64 or float32, ``node`` ``(B, n)``
    int32, ``perm`` ``(B, F, n)`` / ``bnd`` ``(B, F, n_bins + 1)`` int32
    (:class:`~repro_torch.kernels.tree_histogram.ops.BinIndex`).
    Returns ``(B, C, n_nodes, F, n_bins)`` in the values' dtype.
    """
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"tree_histogram_cuda: values on {dev}")
    if values.dtype not in _ENTRIES or values.dim() != 3:
        raise ValueError("tree_histogram_cuda: values must be (B, C, n) "
                         f"float64 or float32, got {values.dtype} "
                         f"{tuple(values.shape)}")
    b, c, n = values.shape
    if perm.dim() != 3 or bnd.dim() != 3:
        raise ValueError("tree_histogram_cuda: perm and bnd must be 3-D")
    f, n_bins = perm.shape[1], bnd.shape[2] - 1
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"tree_histogram_cuda: {c} channels, the kernel "
                         f"takes 1 to {MAX_CHANNELS}")
    if n_nodes < 1 or n_bins < 1 or f < 1 or n >= 2 ** 31:
        raise ValueError(f"tree_histogram_cuda: n_nodes={n_nodes}, "
                         f"n_bins={n_bins}, F={f}, n={n} out of range")
    _check("values", values, values.dtype, (b, c, n), dev)
    _check("node", node, torch.int32, (b, n), dev)
    _check("perm", perm, torch.int32, (b, f, n), dev)
    _check("bnd", bnd, torch.int32, (b, f, n_bins + 1), dev)
    if perm.data_ptr() % 16:
        raise ValueError("tree_histogram_cuda: perm must start on a 16-byte "
                         "boundary (the kernel copies it 16 bytes at a time)")
    out = torch.empty((b, c, n_nodes, f, n_bins), dtype=values.dtype,
                      device=dev)
    err = _entry(values.dtype)(
        values.data_ptr(), node.data_ptr(), perm.data_ptr(), bnd.data_ptr(),
        out.data_ptr(), b, c, n, f, n_bins, n_nodes,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{_ENTRIES[values.dtype]} launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["tree_histogram"] += 1
    return out


def add_chain_cuda(v: torch.Tensor, n: int) -> torch.Tensor:
    """The float64 order bound's probe: one thread's sum of ``v[i % 8]``
    for ``i < n``, in that order -- ``n`` dependent adds on registers.
    ``v`` is 8 float64 values on the card; returns a ``(1,)`` tensor.
    Not a port of a TPU kernel, so no launch is counted."""
    if v.device.type != "cuda" or v.dtype != torch.float64 \
            or tuple(v.shape) != (8,) or not v.is_contiguous() or n < 0:
        raise ValueError("add_chain_cuda: v must be 8 contiguous float64 "
                         f"values on the card and n >= 0, got {v.dtype} "
                         f"{tuple(v.shape)} on {v.device}, n={n}")
    fn = _fns.get("add_chain")
    if fn is None:
        fn = _build.library("tree_histogram").add_chain_f64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["add_chain"] = fn
    out = torch.empty(1, dtype=torch.float64, device=v.device)
    err = fn(v.data_ptr(), n, out.data_ptr(),
             torch.cuda.current_stream(v.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"add_chain_f64 launch failed: CUDA error {err}")
    return out
