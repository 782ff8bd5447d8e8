"""Forest margins dispatched by device, forest pairing and the predictors.

:func:`pair_forests` / :func:`_pad_forest` are numpy copies of the
reference's (``repro/kernels/gbdt_forest/ops.py``), bit-equal to it:
depth and tree padding that changes no prediction.  The fleet predictor
reproduces ``make_fleet_predictor``'s scores: zero-padded feature
columns, one launch over the read rows then the write rows, and a
float32 sigmoid clipped at +-30.  It scores the exact rows: the
reference's power-of-two row bucket bounds XLA's recompiles, which
PyTorch does not have.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.gbdt_forest.kernel import forest_margin_cuda
from repro_torch.kernels.gbdt_forest.ref import (forest_margin_ref,
                                                 paired_forest_margin_ref)


def paired_forest_margin(x, op, feature, threshold, leaf, base,
                         depth: int) -> torch.Tensor:
    """Per-row forest selection over two stacked forests (float32)."""
    if x.device.type == "cpu":
        return paired_forest_margin_ref(x, op, feature, threshold, leaf,
                                        base, depth)
    return forest_margin_cuda(x, op, feature, threshold, leaf, base, depth)


def forest_margin(x, feature, threshold, leaf, base_score: float,
                  depth: int) -> torch.Tensor:
    """Single-forest margins; ``feature``/``threshold`` (T, 2^D - 1)."""
    if x.device.type == "cpu":
        return forest_margin_ref(x, feature, threshold, leaf, base_score,
                                 depth)
    base = torch.tensor([base_score], dtype=torch.float32, device=x.device)
    return forest_margin_cuda(x, None, feature[None], threshold[None],
                              leaf[None], base, depth)


def sigmoid32(m: torch.Tensor) -> torch.Tensor:
    """The reference predictors' float32 sigmoid, clipped at +-30."""
    return 1.0 / (1.0 + torch.exp(-torch.clamp(m, -30.0, 30.0)))


def _pad_forest(feature, threshold, leaf, depth: int, to_depth: int,
                to_trees: int):
    """Pad one dense forest to ``(to_trees, to_depth)`` without changing
    its predictions: leaves become pass-through nodes (threshold
    ``+inf``) whose left child keeps the value; extra trees are inert."""
    feature = np.asarray(feature, dtype=np.int32)
    threshold = np.asarray(threshold, dtype=np.float32)
    leaf = np.asarray(leaf, dtype=np.float32)
    t = feature.shape[0]
    for _ in range(to_depth - depth):
        n_leaves = leaf.shape[1]
        feature = np.concatenate(
            [feature, np.zeros((t, n_leaves), dtype=np.int32)], axis=1)
        threshold = np.concatenate(
            [threshold, np.full((t, n_leaves), np.inf, dtype=np.float32)],
            axis=1)
        new_leaf = np.zeros((t, 2 * n_leaves), dtype=np.float32)
        new_leaf[:, 0::2] = leaf
        leaf = new_leaf
    if to_trees > t:
        n_internal, n_leaves = feature.shape[1], leaf.shape[1]
        pad = to_trees - t
        feature = np.concatenate(
            [feature, np.zeros((pad, n_internal), dtype=np.int32)], axis=0)
        threshold = np.concatenate(
            [threshold, np.full((pad, n_internal), np.inf, dtype=np.float32)],
            axis=0)
        leaf = np.concatenate(
            [leaf, np.zeros((pad, n_leaves), dtype=np.float32)], axis=0)
    return feature, threshold, leaf


def pair_forests(read_forest, write_forest):
    """Stack two forests (numpy arrays, forest axis 0 = read, 1 = write).

    Returns ``(feature, threshold, leaf, base, depth, n_features)``, both
    padded to the larger depth and tree count; samples are zero-padded
    to ``n_features`` columns.
    """
    depth = max(read_forest.depth, write_forest.depth)
    t = max(read_forest.n_trees, write_forest.n_trees)
    padded = [_pad_forest(*f.numpy_arrays(), f.depth, depth, t)
              for f in (read_forest, write_forest)]
    feature, threshold, leaf = (np.stack([padded[0][i], padded[1][i]])
                                for i in range(3))
    base = np.array([read_forest.base_score, write_forest.base_score],
                    dtype=np.float32)
    n_features = max(read_forest.n_features, write_forest.n_features)
    return feature, threshold, leaf, base, depth, n_features


def pack_fleet_rows(x_read: torch.Tensor, x_write: torch.Tensor,
                    n_features: int):
    """One ``(nr + nw, n_features)`` float32 batch and its int32 forest
    selector: the read rows (``op = 0``), then the write rows
    (``op = 1``), feature columns zero-padded to ``n_features``."""
    nr, nw = x_read.shape[0], x_write.shape[0]
    dev = x_read.device
    x = torch.zeros((nr + nw, n_features), dtype=torch.float32, device=dev)
    op = torch.zeros(nr + nw, dtype=torch.int32, device=dev)
    x[:nr, :x_read.shape[1]] = x_read
    x[nr:nr + nw, :x_write.shape[1]] = x_write
    op[nr:nr + nw] = 1
    return x, op


def make_fleet_predictor(read_forest, write_forest, device):
    """The fleet scorer ``(X_read, X_write) -> (p_read, p_write)``.

    Both ops' rows go into one batch with a per-row forest selector and
    are scored in a single launch.
    Inputs and outputs are float32 tensors on ``device``.
    """
    feature, threshold, leaf, base, depth, n_features = pair_forests(
        read_forest, write_forest)
    to = lambda a: torch.as_tensor(a, device=device)
    feature, threshold, leaf, base = map(to, (feature, threshold, leaf, base))

    def predict(x_read: torch.Tensor, x_write: torch.Tensor):
        nr, nw = x_read.shape[0], x_write.shape[0]
        if nr + nw == 0:
            empty = torch.zeros(0, dtype=torch.float32, device=device)
            return empty, empty
        x, op = pack_fleet_rows(x_read, x_write, n_features)
        p = sigmoid32(paired_forest_margin(x, op, feature, threshold, leaf,
                                           base, depth))
        return p[:nr], p[nr:]

    return predict
