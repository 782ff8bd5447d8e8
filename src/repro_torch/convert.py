"""Carry the reference's parameters and state across as numpy arrays.

The port has no neural weights: its parameters are the GBDT forests,
the simulator state and the frozen workload table.  Each ``*_from_numpy``
function takes plain numpy arrays (for example ``{f: getattr(obj, f)}``
of a ``repro`` object) and returns the port's object with its tensors on
``device``; :func:`forest_to_numpy` carries a forest the port trained
back the other way.
Float fields stay float64, integer fields int64, masks bool, exactly as
the reference holds them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "f":
        a = a.astype(np.float64, copy=False)
    elif a.dtype.kind in "iu":
        a = a.astype(np.int64, copy=False)
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def forest_from_numpy(feature, threshold, leaf, base_score, depth,
                      n_features, device=None):
    """A :class:`~repro_torch.core.gbdt.DenseForest` on ``device``."""
    from repro_torch.core.gbdt import DenseForest
    dev = resolve_device(device)
    return DenseForest(
        feature=torch.as_tensor(np.asarray(feature, dtype=np.int32),
                                device=dev),
        threshold=torch.as_tensor(np.asarray(threshold, dtype=np.float32),
                                  device=dev),
        leaf=torch.as_tensor(np.asarray(leaf, dtype=np.float32), device=dev),
        base_score=float(base_score), depth=int(depth),
        n_features=int(n_features))


def forest_to_numpy(forest) -> dict:
    """A port forest as the reference's ``DenseForest`` field dict (host
    numpy), e.g. ``repro.core.gbdt.DenseForest(**forest_to_numpy(f))``."""
    feature, threshold, leaf = forest.numpy_arrays()
    return dict(feature=feature, threshold=threshold, leaf=leaf,
                base_score=float(forest.base_score), depth=int(forest.depth),
                n_features=int(forest.n_features))


def model_from_numpy(read: dict, write: dict, k: int = 1, device=None):
    """A :class:`~repro_torch.core.model.DIALModel` from two forest dicts
    with the :class:`DenseForest` field names."""
    from repro_torch.core.model import DIALModel
    dev = resolve_device(device)
    return DIALModel(read_forest=forest_from_numpy(**read, device=dev),
                     write_forest=forest_from_numpy(**write, device=dev),
                     k=k)


def state_from_numpy(fields: dict, device=None):
    """A :class:`~repro_torch.pfs.state.SimState` from its field dict."""
    from repro_torch.pfs.state import SimState
    dev = resolve_device(device)
    out = {}
    for f in dataclasses.fields(SimState):
        v = fields[f.name]
        if f.name == "now":
            out[f.name] = float(v)
        elif f.name == "tick_index":
            out[f.name] = int(v)
        else:
            out[f.name] = _tensor(v, dev)
    return SimState(**out)


def table_from_numpy(fields: dict, n_osc: int, n_waves: int, device=None):
    """A :class:`~repro_torch.pfs.workloads.WorkloadTable` from the
    reference table's array fields (``client``, ``op``, ... ,
    ``entry_row``, ``entry_osc``, ``row_valid``)."""
    from repro_torch.pfs.workloads import WorkloadTable
    dev = resolve_device(device)
    return WorkloadTable.from_arrays(
        {k: np.asarray(v) for k, v in fields.items()}, n_osc=n_osc,
        n_waves=n_waves, device=dev)
