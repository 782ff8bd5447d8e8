"""Distribution: sharding rules, ZeRO-1, gradient compression, and the
DIAL fleet axis (:mod:`repro_torch.distributed.sharding`)."""

from repro_torch.distributed.sharding import (
    FLEET_AXIS,
    batch_pspec,
    cache_pspecs,
    dp_axes,
    fleet_mesh,
    pad_fleet,
    param_pspecs,
    unpad_fleet,
    zero1_pspecs,
)

__all__ = ["FLEET_AXIS", "batch_pspec", "cache_pspecs", "dp_axes",
           "fleet_mesh", "pad_fleet", "param_pspecs", "unpad_fleet",
           "zero1_pspecs"]
