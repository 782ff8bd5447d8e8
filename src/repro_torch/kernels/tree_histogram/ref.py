"""Plain PyTorch training histograms: ``index_add_`` on flat cell ids.

One ``index_add_`` per channel over the flattened ``(batch, node,
feature, bin)`` cell of every (sample, feature) pair, in the values'
dtype.  Entries are laid out sample-major, so on the CPU, where
``index_add_`` adds in entry order, each cell is summed in ascending
sample order and a float64 result is bit-equal to ``np.bincount`` (the
reference's ``tree_histogram_np``).  On the card ``index_add_`` uses
atomics and sums in no fixed order.

Node ids outside ``[0, n_nodes)`` are dropped: they are redirected to
node 0 with a value of ``+0.0``, which leaves every sum unchanged bit
for bit (a sum that starts at ``+0.0`` never holds ``-0.0``), without a
host sync.  Features outside ``walk`` (when one is given) get 0 in every
cell, as the kernel gives them (their segments are empty).
"""

from __future__ import annotations

import torch


def tree_histogram_ref(values: torch.Tensor, bins: torch.Tensor,
                       node: torch.Tensor, n_nodes: int,
                       n_bins: int,
                       walk: torch.Tensor | None = None) -> torch.Tensor:
    """``out[b, c, j, f, k] = sum(values[b, c, i] : node[b, i] == j,
    bins[b, i, f] == k)``.

    Args:
        values: ``(B, C, n)`` float per-sample channel statistics.
        bins:   ``(B, n, F)`` integer bin codes in ``[0, n_bins)``.
        node:   ``(B, n)`` integer level-local node ids.
        walk:   ``(B, F)`` bool features to sum (None = all).

    Returns ``(B, C, n_nodes, F, n_bins)`` in the values' dtype.
    """
    b, c, n = values.shape
    f = bins.shape[2]
    dev = values.device
    keep = (node >= 0) & (node < n_nodes)
    nd = torch.where(keep, node, 0).to(torch.int64)
    batch = torch.arange(b, device=dev)[:, None, None]
    feat = torch.arange(f, device=dev)[None, None, :]
    flat = (((batch * n_nodes + nd[:, :, None]) * f + feat) * n_bins
            + bins.to(torch.int64)).reshape(-1)
    out = values.new_zeros((c, b * n_nodes * f * n_bins))
    for ch in range(c):
        w = torch.where(keep, values[:, ch], 0.0)
        out[ch].index_add_(0, flat, w[:, :, None].expand(b, n, f).reshape(-1))
    out = out.reshape(c, b, n_nodes, f, n_bins).transpose(0, 1)
    if walk is not None:
        out = torch.where(walk[:, None, None, :, None], out, 0.0)
    return out.contiguous()
