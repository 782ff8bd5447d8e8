"""Plain PyTorch dense-forest margins: a gather-based level descent.

The same static ``depth``-step descent as the kernel, written as whole
``(N, T)`` tensor gathers (as ``repro/kernels/gbdt_forest/ref.py`` does
in jnp).  Float32 throughout.  The reached leaves are summed tree by
tree in ascending order, then the base is added -- the kernel's order --
so the two agree however large the margins grow (a float32 sum of 160
leaves in another order can differ by many ulps of the margin).
"""

from __future__ import annotations

import torch


def paired_forest_margin_ref(x, op, feature, threshold, leaf, base,
                             depth: int) -> torch.Tensor:
    """Margins with a per-row forest selector.

    Args:
        x:         (N, F) float32 samples.
        op:        (N,) integer forest per row, or None for forest 0.
        feature:   (P, T, 2^D - 1) int32 split features, P forests.
        threshold: (P, T, 2^D - 1) float32 (+inf = pass left).
        leaf:      (P, T, 2^D) float32 leaf values.
        base:      (P,) float32 base margins.
        depth:     D.

    Returns:
        (N,) float32 margins (pre-sigmoid).
    """
    n = x.shape[0]
    _, t, n_internal = feature.shape
    n_leaves = leaf.shape[2]
    dev = x.device
    forest = (torch.zeros(n, dtype=torch.int64, device=dev) if op is None
              else op.to(torch.int64))
    tree = torch.arange(t, device=dev)[None, :]
    node_base = forest[:, None] * (t * n_internal) + tree * n_internal
    feat_flat = feature.reshape(-1).to(torch.int64)
    thr_flat = threshold.reshape(-1)
    idx = torch.zeros((n, t), dtype=torch.int64, device=dev)
    for _ in range(depth):
        node = node_base + idx
        xv = x.gather(1, feat_flat[node])
        idx = 2 * idx + 1 + (xv > thr_flat[node]).to(torch.int64)
    leaf_pos = (forest[:, None] * (t * n_leaves) + tree * n_leaves
                + (idx - n_internal))
    vals = leaf.reshape(-1)[leaf_pos]
    acc = torch.zeros(n, dtype=torch.float32, device=dev)
    for i in range(t):
        acc = acc + vals[:, i]
    return acc + base[forest]


def forest_margin_ref(x, feature, threshold, leaf, base_score: float,
                      depth: int) -> torch.Tensor:
    """Single-forest margins; ``feature``/``threshold`` (T, 2^D - 1)."""
    base = torch.tensor([base_score], dtype=torch.float32, device=x.device)
    return paired_forest_margin_ref(x, None, feature[None], threshold[None],
                                    leaf[None], base, depth)
