"""Training histograms over a static bin index, dispatched by device.

Every per-level reduction of the port's trainer
(:mod:`repro_torch.learn.boost`) goes through :func:`tree_histogram`
with a :class:`BinIndex` built once per training run (bin codes never
change during one).  A CUDA tensor launches the hand-written kernel
(``csrc/tree_histogram.cu``); a CPU tensor takes the plain
``index_add_`` version.  The reference's ``numpy``/``jax``/``matmul``/
``cumsum``/``pallas`` strategies have no counterpart: the kernel
replaces them all.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.tree_histogram.kernel import tree_histogram_cuda
from repro_torch.kernels.tree_histogram.ref import tree_histogram_ref


def sort_index(bins: torch.Tensor, n_bins: int):
    """The kernel's view of ``(B, n, F)`` bin codes: ``perm`` ``(B, F,
    n)`` int32 sorts the samples of each feature by bin code (ties in
    ascending sample index) and ``bnd`` ``(B, F, n_bins + 1)`` int32
    holds each bin's start in that order -- the reference's
    ``learn/boost.py::sort_structs``, batched."""
    perm = torch.argsort(bins, dim=1, stable=True)              # (B, n, F)
    codes = torch.gather(bins, 1, perm).transpose(1, 2).to(torch.int64)
    edges = torch.arange(n_bins + 1, device=bins.device).expand(
        bins.shape[0], bins.shape[2], n_bins + 1)
    bnd = torch.searchsorted(codes.contiguous(), edges.contiguous())
    return (perm.transpose(1, 2).to(torch.int32).contiguous(),
            bnd.to(torch.int32))


@dataclasses.dataclass(frozen=True)
class BinIndex:
    """Bin codes, the features the histogram covers, and on the card
    their per-feature sample order.

    ``bins`` ``(B, n, F)`` int32 is what the plain version reads.
    ``walk`` ``(B, F)`` bool marks the features whose cells are summed
    (all, unless ``build`` is given a mask); the others' cells are 0, so the trainer skips
    features that can never split.  ``perm``/``bnd`` (:func:`sort_index`,
    the walked features only) are what the kernel reads; they are built
    for CUDA codes only and are None on the CPU.
    """

    bins: torch.Tensor
    walk: torch.Tensor
    perm: torch.Tensor | None
    bnd: torch.Tensor | None
    n_bins: int

    @classmethod
    def build(cls, bins: torch.Tensor, n_bins: int,
              walk: torch.Tensor | None = None) -> "BinIndex":
        """Index ``(B, n, F)`` bin codes in ``[0, n_bins)``, on their
        device (one host check of the code range)."""
        if bins.dim() != 3:
            raise ValueError(f"BinIndex: bins must be (B, n, F), got "
                             f"{tuple(bins.shape)}")
        if bins.shape[1] >= 2 ** 31:
            raise ValueError("BinIndex: more than 2^31 samples")
        if bins.numel() and not (0 <= int(bins.min())
                                 and int(bins.max()) < n_bins):
            raise ValueError(f"BinIndex: bin codes outside [0, {n_bins})")
        if walk is not None and (walk.dtype != torch.bool or tuple(
                walk.shape) != (bins.shape[0], bins.shape[2])):
            raise ValueError("BinIndex: walk must be a (B, F) bool mask")
        bins = bins.to(torch.int32).contiguous()
        if walk is None:
            walk = torch.ones((bins.shape[0], bins.shape[2]),
                              dtype=torch.bool, device=bins.device)
        perm = bnd = None
        if bins.device.type == "cuda":
            perm, bnd = sort_index(bins, n_bins)
            # a skipped feature's segments are empty: nothing to walk
            bnd = torch.where(walk[:, :, None], bnd, 0)
        return cls(bins=bins, walk=walk, perm=perm, bnd=bnd,
                   n_bins=int(n_bins))


def tree_histogram(values: torch.Tensor, index: BinIndex, node: torch.Tensor,
                   n_nodes: int) -> torch.Tensor:
    """``(B, C, n_nodes, F, n_bins)`` channel sums of ``values``
    ``(B, C, n)`` per (node, feature, bin) cell of the walked features
    (0 elsewhere); ``node`` ``(B, n)`` int32, ids outside
    ``[0, n_nodes)`` dropped.

    On the card: the ordered kernel, bit-equal to ``np.bincount`` in
    float64.  On the CPU: the plain ``index_add_`` version (bit-equal
    there too).
    """
    if values.device.type == "cpu":
        return tree_histogram_ref(values, index.bins, node, n_nodes,
                                  index.n_bins, index.walk)
    return tree_histogram_cuda(values, index.perm, index.bnd, node, n_nodes)
