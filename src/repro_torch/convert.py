"""Carry the reference's parameters and state across as numpy arrays.

DIAL's parameters are the GBDT forests, the simulator state and the
frozen workload table (and, for a batch of scenarios, the reference's
stacked state and table with a leading B, which become the port's
block-diagonal fleet).  Each ``*_from_numpy`` function takes plain numpy
arrays (for example ``{f: getattr(obj, f)}`` of a ``repro`` object) and
returns the port's object with its tensors on ``device``;
:func:`forest_to_numpy` carries a forest the port trained back the other
way.  Float fields stay float64, integer fields int64, masks bool,
exactly as the reference holds them.

The LM's weights and decode caches (:func:`lm_params_from_numpy`,
:func:`lm_cache_from_numpy`) keep their dtypes: float32 stays float32,
bfloat16 (ml_dtypes' ``bfloat16`` in numpy, which ``torch.from_numpy``
rejects) goes through float32, which holds every bfloat16 exactly.
:func:`lm_params_to_numpy` and the optimizer-state pair
(:func:`opt_state_to_numpy`, :func:`opt_state_from_numpy`) carry the
port's trees back into the reference's stacked layout, bfloat16 as
float32 (numpy has no bfloat16 of its own); the checkpoint manager
writes that layout.
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


# --------------------------------------------------------------------- #
# a batch of scenarios (the reference's stacked arrays, leading B)
# --------------------------------------------------------------------- #
def _fleet(a: np.ndarray) -> np.ndarray:
    """``(B, n)`` -> ``(B * n,)`` and ``(B, 2, n)`` -> ``(2, B * n)``:
    element b's column ``i`` becomes fleet column ``b * n + i``."""
    a = np.asarray(a)
    if a.ndim == 2:
        return a.reshape(-1)
    return np.moveaxis(a, 1, 0).reshape(a.shape[1], -1)


def batch_state_from_numpy(fields: dict, device=None):
    """A reference batch's stacked state (every field with a leading B;
    the clock equal across the batch) as the port's fleet
    :class:`~repro_torch.pfs.state.SimState` (see
    :mod:`repro_torch.lab.batch`)."""
    from repro_torch.pfs.state import SimState
    out = {}
    for f in dataclasses.fields(SimState):
        v = np.asarray(fields[f.name])
        if f.name in ("now", "tick_index"):
            out[f.name] = v.reshape(-1)[0].item()
        else:
            out[f.name] = _fleet(v)
    return state_from_numpy(out, device=device)


def batch_wstate_from_numpy(fields: dict, device=None):
    """A reference batch's stacked ``(B, R)`` workload state as the
    fleet's ``(B * R,)`` :class:`~repro_torch.pfs.workloads.WorkloadState`."""
    from repro_torch.pfs.workloads import WorkloadState
    dev = resolve_device(device)
    return WorkloadState(*(_tensor(np.asarray(fields[f]).reshape(-1), dev)
                           for f in ("issued", "done_base")))


def batch_table_from_numpy(fields: dict, n_osc: int, n_waves: int,
                           n_clients: int, device=None):
    """A reference batch's stacked table (every array with a leading B;
    ``n_osc`` interfaces and ``n_clients`` clients an element) as the
    fleet's :class:`~repro_torch.pfs.workloads.WorkloadTable`
    (:meth:`~repro_torch.pfs.workloads.WorkloadTable.block`)."""
    from repro_torch.pfs.workloads import WorkloadTable
    a = {k: np.asarray(v) for k, v in fields.items()}
    tables = [table_from_numpy({k: v[b] for k, v in a.items()}, n_osc=n_osc,
                               n_waves=n_waves, device="cpu")
              for b in range(a["op"].shape[0])]
    return WorkloadTable.block(tables, n_clients, resolve_device(device))


# --------------------------------------------------------------------- #
# the LM
# --------------------------------------------------------------------- #
def _lm_tensor(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.tensor(a, device=device)


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _flat_layers(cfg, tree) -> list:
    """The reference's ``{"stack": per pattern position, leading n_rep
    axis; "tail": ...}`` as one list of per-layer trees, in layer order."""
    layers = [_tree(lambda a, r=r: np.asarray(a)[r], tree["stack"][i])
              for r in range(cfg.n_rep)
              for i in range(len(cfg.layer_pattern))]
    return layers + list(tree["tail"])


def lm_params_from_numpy(cfg, params, device=None) -> dict:
    """The reference LM's parameter tree (``repro.models.lm.init_params``,
    leaves as numpy arrays) as the port's: ``embed``, ``final_norm``,
    ``head`` if untied, and ``layers``, one dict per layer in order."""
    dev = resolve_device(device)
    to = lambda a: _lm_tensor(a, dev)          # noqa: E731
    out = {k: _tree(to, v) for k, v in params.items()
           if k not in ("stack", "tail")}
    out["layers"] = [_tree(to, p) for p in _flat_layers(cfg, params)]
    return out


def lm_cache_from_numpy(cfg, cache, device=None) -> list:
    """The reference's decode cache (``init_cache``/``prefill``, leaves as
    numpy arrays) as the port's per-layer list; attention ``k``/``v`` go
    from (B, Smax, Hkv, Dh) to the port's (B, Hkv, Smax, Dh)."""
    dev = resolve_device(device)
    out = []
    for c in _flat_layers(cfg, cache):
        if "k" in c:
            c = {k: np.swapaxes(np.asarray(c[k]), 1, 2) for k in ("k", "v")}
        out.append(_tree(lambda a: _lm_tensor(a, dev), c))
    return out


def _stack_trees(trees: list):
    """Trees of one structure -> one tree, each leaf stacked on a new
    leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def lm_params_to_numpy(cfg, params) -> dict:
    """The inverse of :func:`lm_params_from_numpy`: the port's parameters
    as the reference's tree, host numpy -- ``stack`` a tuple over the
    pattern positions, each leaf with the leading ``n_rep`` axis,
    ``tail`` the rest; bfloat16 leaves as float32 (exact)."""
    out = {k: _tree(_host, v) for k, v in params.items() if k != "layers"}
    layers = [_tree(_host, p) for p in params["layers"]]
    n_pat = len(cfg.layer_pattern)
    out["stack"] = tuple(
        _stack_trees([layers[r * n_pat + i] for r in range(cfg.n_rep)])
        for i in range(n_pat))
    out["tail"] = tuple(layers[cfg.n_rep * n_pat:])
    return out


def opt_state_to_numpy(cfg, opt_state) -> dict:
    """The optimizer state ``{"step", "m", "v"}`` in the reference's
    layout (``step`` a 0-dim int32 array, the moments as
    :func:`lm_params_to_numpy`)."""
    return {"step": np.asarray(int(opt_state["step"]), dtype=np.int32),
            "m": lm_params_to_numpy(cfg, opt_state["m"]),
            "v": lm_params_to_numpy(cfg, opt_state["v"])}


def opt_state_from_numpy(cfg, opt_state, device=None) -> dict:
    """The reference's optimizer state (numpy leaves) as the port's, on
    ``device``: ``step`` a 0-dim int32 tensor, float32 moments."""
    dev = resolve_device(device)
    return {"step": torch.tensor(int(np.asarray(opt_state["step"])),
                                 dtype=torch.int32, device=dev),
            "m": lm_params_from_numpy(cfg, opt_state["m"], dev),
            "v": lm_params_from_numpy(cfg, opt_state["v"], dev)}
