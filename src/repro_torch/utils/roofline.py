"""Collective accounting and the roofline terms of one step.

The counterpart of ``repro/utils/hlo.py``.  The reference parses the
partitioned program's text for its collectives; an eager PyTorch step
issues each one as an operator, so :class:`CollectiveRecorder` (a
``TorchDispatchMode``) records every ``_c10d_functional`` collective a
step dispatches -- DTensor's redistributions and a region's own
``torch.distributed._functional_collectives`` calls -- with its result
bytes, from the result tensor's own dtype and shape (on this rank).
Eager PyTorch runs every loop trip, so there are no while-loop trip
counts to parse, and a bf16 tensor is recorded at its own width: the
reference's ``tpu_adjusted_wire_bytes`` (which undid its CPU compiler's
float32 upcast) has no counterpart.  Per-chip wire bytes use the
reference's multipliers (ring algorithms):

    all-reduce        2x result bytes   (reduce-scatter + all-gather)
    all-gather        1x result bytes
    reduce-scatter    1x result bytes
    all-to-all        1x result bytes
    collective-permute 1x result bytes
    broadcast         1x result bytes

:class:`Roofline` divides a step's per-chip FLOPs, HBM bytes and wire
bytes by the NVIDIA H100 SXM's published peaks (the card at its 700 W
limit; a card set lower runs slower): bf16 dense tensor cores 989
TFLOP/s, HBM3 3.35 TB/s, and for the collective term the slower link a
group of ranks spans -- NVLink 4 at 450 GB/s each way between the 8
cards of a node, or the DGX H100's 400 Gb/s NIC per card (50 GB/s)
across nodes.  Every 16-rank group of the production meshes (32 or 64
nodes of 8 cards) spans nodes, so their collective term is the NIC's.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12          # H100 SXM bf16 dense, tensor cores (700 W)
HBM_BW = 3.35e12             # H100 SXM HBM3, bytes/s
NVLINK_BW = 450e9            # NVLink 4, bytes/s each way per card
NIC_BW = 50e9                # DGX H100: one 400 Gb/s NIC per card
NODE_CARDS = 8               # cards a DGX H100 node joins by NVLink
CARD = "NVIDIA H100 SXM (700 W)"

WIRE_MULT = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
    "broadcast": 1.0,
}

# _c10d_functional operator name -> kind (the reference's HLO names)
_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}


def _nbytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(t) for t in out)
    return 0


@dataclasses.dataclass
class CollectiveStats:
    """Counts and result bytes by kind, and every record in order."""
    counts: dict = dataclasses.field(default_factory=dict)
    bytes_by_kind: dict = dataclasses.field(default_factory=dict)
    records: list = dataclasses.field(default_factory=list)

    def add(self, kind: str, nbytes: int, op: str) -> None:
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + nbytes
        self.records.append((kind, nbytes, op))

    @property
    def total_wire_bytes(self) -> float:
        return sum(WIRE_MULT[k] * v for k, v in self.bytes_by_kind.items())


class CollectiveRecorder(TorchDispatchMode):
    """Records every functional collective dispatched inside the block
    into :attr:`stats`.  An operator on DTensors is let through first
    (``NotImplemented``), so the collectives DTensor lowers it to come
    back here on plain tensors, as ``CommDebugMode`` does."""

    def __init__(self):
        super().__init__()
        self.stats = CollectiveStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **(kwargs or {}))
        from torch.distributed.tensor import DTensor

        if any(t is DTensor or issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if func.namespace in ("_c10d_functional", "_dtensor"):
            name = func._overloadpacket.__name__
            kind = _KINDS.get(name)
            if kind is not None:
                self.stats.add(kind, _nbytes(out), name)
        return out


def link_bw(group_cards: int, node_cards: int = NODE_CARDS) -> float:
    """Bytes/s per card of a collective over ``group_cards`` ranks: NVLink
    inside one node, the NIC once the group spans nodes (the slower link
    holds a ring)."""
    return NVLINK_BW if group_cards <= node_cards else NIC_BW


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-chip analytic FLOPs
    hbm_bytes: float             # per-chip analytic HBM bytes
    wire_bytes: float            # per-chip collective wire bytes
    model_flops: float           # 6 (train) or 2 x N_active x tokens, global
    chips: int
    link_bw: float = NIC_BW      # the slowest link the step's groups span

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.wire_bytes / self.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / (FLOPs summed over chips)."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Achievable MFU if the step runs exactly at the dominant bound."""
        if self.bound_s == 0:
            return 0.0
        return self.model_flops / (self.chips * PEAK_FLOPS * self.bound_s)

    def to_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "wire_bytes_per_chip": self.wire_bytes,
            "model_flops": self.model_flops,
            "chips": self.chips,
            "link_bw": self.link_bw,
            "card": CARD,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_flops_frac": self.useful_flops_frac,
            "mfu_bound": self.mfu_bound,
        }
