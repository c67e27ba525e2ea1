"""Runtime telemetry used by the serving slice: the typed metric registry
(Counter/Gauge/Histogram) and the per-request tracer (FLAGS_trace_dir)."""

from . import registry, tracing  # noqa: F401
