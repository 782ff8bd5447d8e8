"""Mesh construction for the port's launchers.

Mirrors ``repro/launch/mesh.py``: functions, never module-level
constants, so importing this module touches no device.  The LM's mesh
is a ``DeviceMesh`` over the process group the caller initialised (one
process per card, NCCL; ``gloo`` on the CPU when the caller asks for
it); the fleet mesh is a tuple of devices in one process.
:func:`end_run_on_error` holds one rank of such a run, so that a rank
that raises ends every rank.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
import traceback


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's production mesh: (16, 16) ``("data", "model")``
    (256 ranks), or (2, 16, 16) ``("pod", "data", "model")`` (512), over
    the initialised default process group, whose world size must be the
    mesh's (raises otherwise; never a smaller mesh).  On H100s that is
    32 (or 64) nodes of 8 cards, one process a card; the dry-run
    (:mod:`repro_torch.launch.dryrun`) builds it over a fake process
    group in one CPU process."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, names, device_type, "make_production_mesh")


def make_test_mesh(n_data: int = 2, n_model: int = 4, *,
                   multi_pod: bool = False, device_type: str = "cuda"):
    """A ``("data", "model")`` mesh, or ``("pod", "data", "model")`` with
    2 pods, over the initialised default process group, whose world size
    must be the mesh's size (raises otherwise; never a smaller mesh)."""
    shape = (2, n_data, n_model) if multi_pod else (n_data, n_model)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, names, device_type, "make_test_mesh")


def _mesh(shape, names, device_type, what):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    size = 1
    for n in shape:
        size *= n
    if not dist.is_initialized():
        raise RuntimeError(f"{what}: initialise the process group "
                           "(one process per device) first")
    if dist.get_world_size() != size:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{size} processes, the group has "
                         f"{dist.get_world_size()}")
    if device_type == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError(f"{what}: no CUDA device is visible "
                               "(pass device_type='cpu' for gloo)")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_fleet_mesh(n_devices: int | None = None) -> tuple:
    """1-D mesh over the DIAL fleet (scenario-batch) axis: every visible
    CUDA device by default, the first ``n_devices`` otherwise (an alias
    of :func:`repro_torch.distributed.sharding.fleet_mesh`)."""
    from repro_torch.distributed.sharding import fleet_mesh

    return fleet_mesh(n_devices)


@contextlib.contextmanager
def end_run_on_error(rank: int):
    """Hold one rank of a run of one process a rank (``torch.multiprocessing
    .spawn`` over an initialised process group).  When the body raises,
    print the rank and its traceback (flushed) and end this process at
    once with exit code 1, skipping ``destroy_process_group`` (NCCL's can
    wait on peers), so that ``spawn`` ends the other ranks within its
    grace period instead of leaving them in a collective until the
    group's timeout; the run still fails.  When the body returns,
    destroy the default process group."""
    import torch.distributed as dist

    try:
        yield
    except Exception:
        sys.stdout.flush()
        print(f"rank {rank} raised at unix time {time.time():.3f}; ending "
              f"every rank:\n{traceback.format_exc()}", file=sys.stderr,
              flush=True)
        os._exit(1)
    dist.destroy_process_group()
