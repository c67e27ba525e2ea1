"""Always-on runtime telemetry (the torch counterpart of
paddle_tpu/observability/, the same names, records and files).

The post-hoc profiler (paddle_tpu_torch.profiler: RecordEvent tables,
xla_trace on torch.profiler) answers "where did a profiled run's time
go"; this package answers "is the run healthy RIGHT NOW":

- registry:  typed thread-safe metrics (Counter/Gauge/Histogram) shared by
             every subsystem; resilience.health is a shim over it;
- stepstats: per-step StepStats collected from Executor/ParallelExecutor,
             the input pipeline's stall time, the NaN guard, and the
             pipeline-parallel schedule (runtime bubble fraction);
- export:    flag-gated JSONL event sink + Prometheus scrape file, per-rank
             shards with a rank-0 merged view (FLAGS_telemetry_dir);
- opprof:    op-LEVEL attribution: the per-op device-time/FLOPs profile
             (op_profile records, tools/op_profile.py), FLAGS_tensor_stats
             on-device output statistics, and FLAGS_nan_provenance
             first-bad-op localization when a NaN guard trips;
- tracing:   per-request distributed tracing with tail sampling and
             per-process JSONL span shards (FLAGS_trace_dir);
- flightrec: dump-on-trigger anomaly bundles (FLAGS_flightrec_dir);
- promparse: Prometheus exposition text -> registry-shaped snapshots,
             the exact inverse of registry.render_prometheus;
- aggregate: FleetAggregator: scrapes every replica's /metrics (the
             ModelServer's) plus a local registry and merges them;
- slo:       declarative SLO objects + AlertEngine (multi-window
             multi-burn-rate rules) + drift sentinels.

Live view: `python tools/monitor.py --dir <telemetry_dir>`.
"""

from . import (  # noqa: F401
    aggregate,
    export,
    flightrec,
    opprof,
    promparse,
    registry,
    slo,
    stepstats,
    tracing,
)
from .aggregate import FleetAggregator
from .flightrec import FlightRecorder
from .registry import Counter, Gauge, Histogram, MetricRegistry, default_registry
from .slo import SLO, AlertEngine
from .stepstats import (
    StepStats,
    StepStatsCollector,
    active,
    collector,
    maybe_flush,
)
from .tracing import NULL_SPAN, Span, Tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "default_registry",
    "StepStats",
    "StepStatsCollector",
    "active",
    "collector",
    "maybe_flush",
    "registry",
    "stepstats",
    "export",
    "opprof",
    "tracing",
    "flightrec",
    "promparse",
    "aggregate",
    "slo",
    "NULL_SPAN",
    "Span",
    "Tracer",
    "FlightRecorder",
    "FleetAggregator",
    "SLO",
    "AlertEngine",
]
