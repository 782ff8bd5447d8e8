"""The simulated Lustre-like PFS on PyTorch tensors (float64).

    state layer      repro_torch.pfs.state         SimState + engine_step
    workload layer   repro_torch.pfs.workloads     presets + WorkloadTable
    execution layer  repro_torch.pfs.engine        stateful PFSSim
                     repro_torch.pfs.engine_torch  FusedEngine intervals
    probing          repro_torch.pfs.stats         FleetStats / probe_all
"""
