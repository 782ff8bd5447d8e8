"""Mesh construction for the port's launchers.

The fleet part of the reference's ``repro/launch/mesh.py``: a function,
never a module-level constant, so importing this module touches no
device.
"""

from __future__ import annotations


def make_fleet_mesh(n_devices: int | None = None) -> tuple:
    """1-D mesh over the DIAL fleet (scenario-batch) axis: every visible
    CUDA device by default, the first ``n_devices`` otherwise (an alias
    of :func:`repro_torch.distributed.sharding.fleet_mesh`)."""
    from repro_torch.distributed.sharding import fleet_mesh

    return fleet_mesh(n_devices)
