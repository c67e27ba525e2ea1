"""Runtime telemetry used by the serving slice: the typed metric registry
(Counter/Gauge/Histogram), the per-request tracer (FLAGS_trace_dir) and the
flight recorder (FLAGS_flightrec_dir) that dumps the tracer's ring and the
registry when a trigger fires."""

from . import flightrec, registry, tracing  # noqa: F401
