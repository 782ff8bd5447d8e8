"""Telemetry for the port of DIAL: traces, sinks, timers, diagnosis.

The counterpart of the reference's ``repro/obs``.  Opt-in tracing
through both execution paths -- decision provenance and per-OST
timelines as more outputs of the fused loop's interval (static buffers
of its CUDA graph on the card), mirrored record for record by the host
loop's :class:`HostTracer`, both kept on the device until the run ends
-- plus the host-side sinks (JSONL, Chrome ``trace_event``, markdown),
phase timers, run provenance and counterfactual loss diagnosis.
"""

from repro_torch.obs.diagnose import (ARMS, CAUSES, DIAGNOSIS_SCHEMA,
                                      DiagnoseConfig, cause_counts, diagnose,
                                      render_diagnosis_markdown,
                                      write_diagnosis_report)
from repro_torch.obs.host import HostTracer
from repro_torch.obs.schema import (DECISION_FIELDS, TIMELINE_FIELDS,
                                    TRACE_SCHEMA, RunTrace, TraceConfig,
                                    timeline_tap)
from repro_torch.obs.sinks import (chrome_trace, read_jsonl,
                                   read_jsonl_diagnosis, render_summary,
                                   write_chrome, write_jsonl)
from repro_torch.obs.timers import (PhaseTimers, collect_provenance,
                                    compile_execute_split)

__all__ = [
    "TRACE_SCHEMA", "DECISION_FIELDS", "TIMELINE_FIELDS",
    "TraceConfig", "RunTrace", "timeline_tap", "HostTracer",
    "write_jsonl", "read_jsonl", "read_jsonl_diagnosis", "chrome_trace",
    "write_chrome", "render_summary",
    "DIAGNOSIS_SCHEMA", "CAUSES", "ARMS", "DiagnoseConfig", "diagnose",
    "cause_counts", "write_diagnosis_report", "render_diagnosis_markdown",
    "PhaseTimers", "compile_execute_split", "collect_provenance",
]
