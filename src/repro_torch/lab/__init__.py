"""Scenario Lab: batched multi-scenario runs and the fleet-scale
collect -> train -> evaluate pipeline, on one device.

The port of the reference's ``repro/lab`` batch layer:

    scenarios.py   declarative :class:`ScenarioSpec` (topology, workload
                   mix, disturbance schedule, seed) and the registry of
                   named scenarios (the paper setups and beyond-paper
                   stress scenarios);
    batch.py       B scenarios as one block-diagonal fleet on the device,
                   padded into shape buckets where their structures
                   differ, tuned in-batch by the fleet agent or the fused
                   loop (each interval one CUDA graph on the card);
    campaign.py    offline collection on the batch path, training, and
                   versioned model artifacts;
    evaluate.py    every scenario under tuned vs default vs best-static
                   policies, as a JSON + markdown report;
    continual.py   a drifting scenario with online refits (frozen vs
                   online), and the hard-case curriculum over a fuzz
                   report's triaged losers;
    fuzz.py        seeded scenario generation, sweeps of DIAL against a
                   static-θ grid, auto-triaged loss reports;
    trace.py       one scenario replayed through the traced fused loop,
                   written as JSONL, Chrome trace and markdown;
    diagnose.py    counterfactual diagnosis of a scenario or of a fuzz
                   report's losers (:mod:`repro_torch.obs.diagnose`).

CLI: ``python -m repro_torch.lab {list,campaign,evaluate,continual,fuzz,
trace,diagnose}`` (``--smoke`` for the CI-sized runs, ``--device cpu`` for the
plain versions).
"""

from repro_torch.lab.batch import (BatchEngine, BatchPort, ScenarioBatch,
                                   bucket_scenarios, run_batch,
                                   stack_scenarios)
from repro_torch.lab.continual import (ContinualResult, run_comparison,
                                       run_continual,
                                       run_hard_case_curriculum)
from repro_torch.lab.scenarios import (SCENARIOS, BuiltScenario,
                                       DisturbanceEvent, ScenarioSpec, build,
                                       get_scenario, make_schedule,
                                       scenario_names, variants)

__all__ = [
    "ScenarioSpec", "DisturbanceEvent", "BuiltScenario", "SCENARIOS",
    "build", "get_scenario", "scenario_names", "variants", "make_schedule",
    "ScenarioBatch", "BatchEngine", "BatchPort", "stack_scenarios",
    "bucket_scenarios", "run_batch", "ContinualResult", "run_continual",
    "run_comparison", "run_hard_case_curriculum",
]
