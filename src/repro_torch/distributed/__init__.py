"""Multi-device layout of the port: the DIAL fleet axis
(:mod:`repro_torch.distributed.sharding`)."""
