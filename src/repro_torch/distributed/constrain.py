"""Sharding-constraint hooks usable from inside model code.

Mirrors ``repro/distributed/constrain.py``.  ``constrain(x, *axes)``
redistributes a DTensor to the named layout when called under an active
mesh (:func:`use_mesh`, the counterpart of the reference's ``with
mesh:``) and returns ``x`` itself otherwise: on a plain tensor, or with
no mesh, so every single-card path runs as before.  The special axis
name "dp" expands to the data-parallel axes of the active mesh (('pod',
'data') on the multi-pod mesh), and axes absent from the mesh are
dropped -- the same annotation works on any mesh shape.

The models run regions DTensor has no rule for on the card's torch,
and loops DTensor would dispatch op by op (ROADMAP Queue 3), on each
rank's local shards through ``torch.distributed.tensor.experimental.
local_map`` (:func:`local_map`, the reference's ``shard_map``), with
their input, output and gradient layouts given by :func:`layout`.
:func:`is_dtensor`, :func:`laid_out_as` and :func:`full` serve AdamW
and the checkpoint.

Serving a batch that does not divide the data axes (long-context decode,
batch 1) runs under :func:`batch_rows`: "dp" then names no axis, so the
activations are replicated over the data axes, and the attention cache
shards its sequence over them instead (``cache_pspecs(shard_seq=True)``).
:func:`axis_rank` gives a region the rank's index along mesh axes (a
head group's or a sequence slice's offset).
"""

from __future__ import annotations

import contextlib
import sys

# the meshes of the open use_mesh blocks, innermost last.  Process-wide,
# not thread-local: the backward pass, and the checkpointed forward it
# recomputes, run on autograd's device threads, which must see the mesh
_ACTIVE: list = []
# one entry per open batch_rows block: whether its batch is replicated
_BATCH_REPLICATED: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) the active mesh inside the block."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def active_mesh():
    """The mesh of the innermost :func:`use_mesh` block, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def batch_rows(batch: int):
    """Inside the block "dp" names the data axes only when ``batch``
    rows divide them (the reference's ``input_specs`` rule); else the
    batch is replicated over them.  Nothing with no active mesh."""
    mesh = active_mesh()
    _BATCH_REPLICATED.append(bool(mesh is not None
                                  and batch % axes_size(data_axes())))
    try:
        yield
    finally:
        _BATCH_REPLICATED.pop()


def batch_replicated() -> bool:
    """Whether the innermost :func:`batch_rows` block replicates its
    batch over the data axes."""
    return bool(_BATCH_REPLICATED and _BATCH_REPLICATED[-1])


def data_axes() -> tuple:
    """The data-parallel axes of the active mesh (('pod', 'data') on the
    multi-pod mesh), whatever :func:`batch_rows` says; () with none."""
    mesh = active_mesh()
    return () if mesh is None else _data(mesh)


def dp_dividing(n: int) -> tuple:
    """The data axes ("dp", as it names them now) whose sizes' product
    divides ``n``: all of them, else the last ('data') alone, else the
    first, else none -- the axes ``n`` routing groups can shard over
    with whole groups on each rank."""
    mesh = active_mesh()
    if mesh is None:
        return ()
    axes = _dp(mesh)
    for cand in (axes, axes[-1:], axes[:1]):
        if n % axes_size(cand) == 0:
            return cand
    return ()


def axes_size(names) -> int:
    """The product of the active mesh's sizes along the axes ``names``."""
    mesh = active_mesh()
    n = 1
    for a in names:
        n *= int(mesh.size(mesh.mesh_dim_names.index(a)))
    return n


def axis_rank(names) -> int:
    """This rank's index along the mesh axes ``names`` of the active mesh
    (major first; axes the mesh lacks count as size 1)."""
    mesh = active_mesh()
    idx = 0
    coord = mesh.get_coordinate()
    for n in names:
        if n in mesh.mesh_dim_names:
            i = mesh.mesh_dim_names.index(n)
            idx = idx * int(mesh.size(i)) + int(coord[i])
    return idx


def model_axis_size() -> int:
    """Size of the 'model' axis in the active mesh (0 when no mesh)."""
    mesh = active_mesh()
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return 0
    return int(mesh.size(mesh.mesh_dim_names.index("model")))


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor; a process that never imported
    DTensor's module holds none, and this does not import it."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def laid_out_as(x, like):
    """``x`` redistributed to ``like``'s mesh and placements when both are
    DTensors (a partial gradient reduce-scattered onto a data-sharded
    moment, an update all-gathered onto its parameter); else ``x``."""
    if is_dtensor(x) and is_dtensor(like):
        return x.redistribute(like.device_mesh, like.placements)
    return x


def full(x):
    """A DTensor's whole value as a plain tensor on every rank; else
    ``x``."""
    return x.full_tensor() if is_dtensor(x) else x


def _data(mesh) -> tuple:
    return tuple(n for n in ("pod", "data") if n in mesh.mesh_dim_names)


def _dp(mesh) -> tuple:
    return () if batch_replicated() else _data(mesh)


def layout(*axes, partial=()):
    """The placements on the active mesh of a tensor laid out as ``axes``
    (one entry per dim, as :func:`constrain` takes them: an axis name,
    "dp", None, or a tuple of names) that holds partial sums over the
    mesh axes named in ``partial`` ("dp" for the data axes; None and
    absent names dropped).  None with no active mesh."""
    mesh = active_mesh()
    if mesh is None:
        return None
    from torch.distributed.tensor import Partial

    from repro_torch.distributed.sharding import P, placements

    names = mesh.mesh_dim_names

    def one(a):
        if a == "dp":
            return _dp(mesh) or None
        if isinstance(a, tuple):
            return tuple(n for n in a if n in names) or None
        return a if a in names else None

    over = {n for a in partial
            for n in (_dp(mesh) if a == "dp" else
                      a if isinstance(a, tuple) else (a,))}
    return [Partial() if n in over else p
            for n, p in zip(names, placements(mesh, P(*map(one, axes))))]


def constrain(x, *axes):
    """``x`` laid out as ``axes`` (one entry per dim) on the active mesh."""
    mesh = active_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    return x.redistribute(mesh, layout(*axes))


def local_map(fn, out_placements, in_placements, in_grad_placements=None):
    """``torch.distributed.tensor.experimental.local_map`` of ``fn`` on the
    active mesh, its DTensor inputs redistributed to ``in_placements``
    (placements from :func:`layout`); ``fn`` itself with no active mesh,
    so a single-card path never imports DTensor's module (about a
    second)."""
    mesh = active_mesh()
    if mesh is None:
        return fn
    from torch.distributed.tensor.experimental import local_map as lmap

    return lmap(fn, out_placements, in_placements, in_grad_placements, mesh,
                redistribute_inputs=True)
