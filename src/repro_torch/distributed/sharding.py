"""The DIAL fleet axis: a scenario batch split over several devices.

The fleet part of the reference's ``repro/distributed/sharding.py``.  A
batch of B scenarios is one block-diagonal fleet
(:mod:`repro_torch.lab.batch`), and every DIAL decision reads only its
own interface's counters, so the batch splits over devices along its
elements with no communication: each device runs a contiguous shard of
elements as a fleet of its own.  A mesh here is a tuple of
``torch.device``; :func:`fleet_mesh` builds one, and :func:`pad_fleet`
/ :func:`unpad_fleet` pad a batch that does not divide the device count
and drop the phantoms again.
"""

from __future__ import annotations

import numpy as np
import torch

#: the name of the one axis a fleet mesh has (the reference's
#: ``PartitionSpec`` axis name; kept for the records that name it)
FLEET_AXIS = "fleet"


def fleet_mesh(n_devices: int | None = None, *, devices=None) -> tuple:
    """A 1-D fleet mesh: a tuple of ``torch.device``.

    Every visible CUDA device by default, the first ``n_devices``
    otherwise; ``devices=`` takes explicit ones (any device, repeats
    allowed: the CPU tests split a batch over several ``"cpu"``
    entries).  Raises when more devices are asked for than exist.
    """
    if devices is not None:
        mesh = tuple(torch.device(d) for d in devices)
        if n_devices is not None:
            mesh = mesh[:n_devices]
        if not mesh:
            raise ValueError("fleet mesh over no devices")
        return mesh
    n_visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_visible == 0:
        raise RuntimeError("fleet_mesh: no CUDA device is visible (pass "
                           "devices=[...] to name devices explicitly)")
    if n_devices is not None and n_devices > n_visible:
        raise ValueError(f"fleet mesh wants {n_devices} devices but only "
                         f"{n_visible} are visible")
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"fleet mesh wants {n_devices} devices")
    return tuple(torch.device("cuda", i)
                 for i in range(n_visible if n_devices is None
                                else n_devices))


def fleet_batch_size(tree) -> int:
    """Leading-axis extent shared by every leaf of a stacked batch (a
    tensor, an array, or a list / tuple / dict of them)."""
    leaves = _leaves(tree)
    if not leaves:
        raise ValueError("empty tree has no batch axis")
    return int(leaves[0].shape[0])


def pad_fleet(tree, n_shards: int, n_pad: int | None = None):
    """Pad every leaf's leading batch axis up to a multiple of
    ``n_shards`` by repeating element 0.

    Returns ``(padded_tree, n_pad)``.  Callers that carry per-element
    *decision* masks pad those with ``False`` themselves, so phantom
    elements never decide.
    """
    b = fleet_batch_size(tree)
    if n_pad is None:
        n_pad = (-b) % int(n_shards)
    if n_pad == 0:
        return tree, 0

    def one(a):
        if torch.is_tensor(a):
            return torch.cat([a, a[:1].repeat((n_pad,) + (1,) * (a.dim()
                                                                - 1))])
        a = np.asarray(a)
        return np.concatenate([a, np.repeat(a[:1], n_pad, axis=0)])
    return _map(one, tree), n_pad


def unpad_fleet(tree, n_pad: int):
    """Strip :func:`pad_fleet`'s phantom trailing elements again."""
    if n_pad == 0:
        return tree
    return _map(lambda a: a[:-n_pad], tree)


def shard_elements(n_elems: int, n_shards: int) -> list:
    """The element indices each shard runs: contiguous and equal, the
    batch padded by repeating element 0 (:func:`pad_fleet`'s rule)."""
    idx, _ = pad_fleet(np.arange(n_elems), n_shards)
    return list(idx.reshape(int(n_shards), -1))


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)
