"""repro_torch.obs — structured span tracing + metrics export (the port's
own copy of the JAX package's ``obs``; standard library only).

The time-resolved observability layer over the superstep/I-O/recovery
stack: a bounded ring-buffer :class:`Tracer` (spans, instants, counters;
:data:`NOOP` singleton when disabled), Chrome/Perfetto ``trace_event``
JSON export with per-process lane merge (:mod:`repro_torch.obs.export`),
and a report CLI (``python -m repro_torch.obs report <trace>``).  The
trace format is the JAX package's event for event, so either package's
report reads the other's traces.

Enable via ``PemsConfig(trace=True, trace_path="/tmp/run.json")`` and
export with ``pems.export_trace()``.
"""

from .export import load_trace, merge_trace_files, trace_events, write_trace
from .report import render, report, summarize
from .tracer import NOOP, NoopTracer, Tracer

__all__ = [
    "Tracer", "NoopTracer", "NOOP",
    "trace_events", "write_trace", "merge_trace_files", "load_trace",
    "summarize", "render", "report",
]
