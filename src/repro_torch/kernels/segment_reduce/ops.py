"""Segment sum over a static mapping, dispatched by the values' device.

Every per-OST, per-client and stripe reduction of the engine goes
through :func:`segment_sum` with a :class:`SegmentMap` built once where
the topology or the workload table is frozen.  A CUDA tensor launches
the hand-written kernel (``csrc/segment_sum.cu``); a CPU tensor takes
the plain ``index_add_`` version.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.segment_reduce.kernel import segment_sum_cuda
from repro_torch.kernels.segment_reduce.ref import segment_sum_ref


@dataclasses.dataclass(frozen=True)
class SegmentMap:
    """A static ``entry -> segment`` mapping with its CSR form.

    ``ids`` are the raw segment ids (int64, what the plain version
    reads); ``order`` is a stable argsort of the ids in range (int32
    positions into the values), ``offsets`` the ``S + 1`` segment starts
    into ``order`` (int32) -- what the kernel reads; ``max_len`` the
    longest segment (the kernel's chunk size follows it).
    """

    ids: torch.Tensor
    order: torch.Tensor
    offsets: torch.Tensor
    num_segments: int
    max_len: int

    @property
    def n_entries(self) -> int:
        return self.ids.shape[0]

    @classmethod
    def build(cls, segment_ids, num_segments: int, device) -> "SegmentMap":
        ids = np.asarray(segment_ids, dtype=np.int64).reshape(-1)
        if ids.shape[0] >= 2**31:
            raise ValueError("SegmentMap: more than 2^31 entries")
        pos = np.nonzero((ids >= 0) & (ids < num_segments))[0]
        kept = ids[pos]
        order = pos[np.argsort(kept, kind="stable")]
        counts = np.bincount(kept, minlength=num_segments)
        offsets = np.zeros(num_segments + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        to = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
        return cls(ids=to(ids, torch.int64), order=to(order, torch.int32),
                   offsets=to(offsets, torch.int32),
                   num_segments=int(num_segments),
                   max_len=int(counts.max(initial=0)))


def segment_sum(values: torch.Tensor, smap: SegmentMap) -> torch.Tensor:
    """``out[..., s] = sum(values[..., i] for i with ids[i] == s)``,
    float64, for ``(E,)`` or ``(K, E)`` values: several sums over one map
    whose inputs are ready together cost one launch.

    On the card: the ordered kernel, bit-equal to ``np.bincount`` column
    by column.  On the CPU: the plain ``index_add_`` version (also
    bit-equal there).
    """
    if values.device.type == "cpu":
        return segment_sum_ref(values, smap.ids, smap.num_segments)
    return segment_sum_cuda(values, smap)
