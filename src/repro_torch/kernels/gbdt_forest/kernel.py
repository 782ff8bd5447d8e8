"""ctypes binding of ``csrc/gbdt_forest.cu`` (see its header note)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels import LAUNCHES

# dynamic shared memory a block may opt into on the H100 (227 KB)
SMEM_LIMIT = 232_448
TILE_ROWS = (512, 256, 128, 64, 32)

_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.library("gbdt_forest").forest_margin_f32
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"forest kernel: {name} must be a contiguous {dtype} {shape} "
            f"tensor on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def forest_layout(n_forests: int, n_trees: int, depth: int,
                  n_features: int):
    """``(rows, shared bytes)`` of a launch: the forests' packed nodes
    (8 B) and leaves (4 B), and an x tile of ``rows`` rows, the largest
    of :data:`TILE_ROWS` that fits :data:`SMEM_LIMIT`.  Raises
    ``ValueError`` when not even 32 rows fit."""
    forests = n_forests * n_trees * ((2 ** depth - 1) * 8 + 2 ** depth * 4)
    for rows in TILE_ROWS:
        smem = forests + rows * n_features * 4
        if smem <= SMEM_LIMIT:
            return rows, smem
    raise ValueError(
        f"forest kernel: {n_forests} forest(s) of {n_trees} trees of depth "
        f"{depth} and {n_features} features need {forests + 32 * n_features * 4}"
        f" B of shared memory, over {SMEM_LIMIT}")


def forest_margin_cuda(x, op, feature, threshold, leaf, base,
                       depth: int) -> torch.Tensor:
    """Launch the forest kernel: paired form with ``op``, single without.

    ``feature``/``threshold`` are ``(P, T, 2^D - 1)``, ``leaf``
    ``(P, T, 2^D)``, ``base`` ``(P,)``; ``op`` is ``(N,)`` int32 with
    values in ``[0, P)`` (the caller's contract, as in the TPU kernel).
    """
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"forest_margin_cuda: x on {dev}")
    if x.dim() != 2:
        raise ValueError(f"forest_margin_cuda: x must be 2-D, got {x.dim()}-D")
    n, n_features = x.shape
    p, t, n_internal = feature.shape
    if n_internal != 2 ** depth - 1:
        raise ValueError(f"forest_margin_cuda: {n_internal} internal nodes "
                         f"for depth {depth}")
    _check("x", x, torch.float32, (n, n_features), dev)
    _check("feature", feature, torch.int32, (p, t, n_internal), dev)
    _check("threshold", threshold, torch.float32, (p, t, n_internal), dev)
    _check("leaf", leaf, torch.float32, (p, t, 2 ** depth), dev)
    _check("base", base, torch.float32, (p,), dev)
    if op is not None:
        _check("op", op, torch.int32, (n,), dev)
    if not 1 <= p <= 32:
        raise ValueError(f"forest_margin_cuda: {p} forests, at most 32")
    rows, _ = forest_layout(p, t, depth, n_features)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    err = _entry()(x.data_ptr(), None if op is None else op.data_ptr(),
                   feature.data_ptr(), threshold.data_ptr(), leaf.data_ptr(),
                   base.data_ptr(), out.data_ptr(), n, n_features, p, t,
                   depth, rows, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"forest_margin_f32 launch failed: CUDA error {err}")
    LAUNCHES["forest_margin" if op is None else "paired_forest_margin"] += 1
    return out
