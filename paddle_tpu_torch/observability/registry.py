"""Typed, thread-safe metric registry: Counter / Gauge / Histogram.

Reference analog: the reference's observability is strictly post-hoc
(platform/profiler RecordEvent tables read AFTER a session stops); a
production runtime also needs the streaming complement — always-on named
metrics an operator can scrape mid-run, the way accelerator fleets pair traces
with continuous monitoring. This registry is that surface: every subsystem
(executor step stats, input pipeline, resilience health counters) registers
typed metrics here, and observability/export.py serializes `snapshot()` into
JSONL / Prometheus text.

Design constraints:
- one lock per registry (metrics are updated on hot paths, but a training
  step is milliseconds — an uncontended lock acquire is ~100 ns);
- histograms have BOUNDED buckets (fixed upper-bound list), so memory is
  O(metrics), never O(steps);
- labels are kwargs on counters/gauges (`inc(1, kind="rpc")`), stored per
  label-tuple; histograms are label-free by design (bounded cardinality);
- re-registering a name returns the existing metric, and a kind mismatch is
  a hard error (two subsystems silently sharing "steps" as counter AND
  gauge is a bug, not a merge).

`resilience.health` is a compatibility shim over counters named
"health/<name>" — its incr/get/snapshot/reset API is unchanged, but the
counters now ride the same export path as everything else.
"""

import math
import re
import threading

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "default_registry",
    "render_prometheus",
    "DEFAULT_MS_BUCKETS",
]

# default buckets for millisecond-scale latencies: ~exponential, 0.1 ms ..
# 2 min, 23 buckets + overflow — per-step wall times from a CPU unit test
# (~1 ms) to a multi-minute pathological stall all land in a bounded table
DEFAULT_MS_BUCKETS = (
    0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500,
    1000, 2500, 5000, 10000, 25000, 50000, 120000,
)


def _label_key(labels):
    return tuple(sorted(labels.items()))


class _Metric:
    kind = None

    def __init__(self, name, help, lock):
        self.name = name
        self.help = help
        self._lock = lock


class Counter(_Metric):
    """Monotonic float counter, optionally labelled."""

    kind = "counter"

    def __init__(self, name, help, lock):
        super().__init__(name, help, lock)
        self._values = {}

    def inc(self, n=1, **labels):
        if n < 0:
            raise ValueError("counter %r cannot decrease (n=%r)" % (self.name, n))
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + n
            return self._values[key]

    def value(self, **labels):
        with self._lock:
            return self._values.get(_label_key(labels), 0)

    def clear(self):
        with self._lock:
            self._values.clear()

    def _snapshot_locked(self):
        return {
            "kind": self.kind,
            "values": {_render_labels(k): v for k, v in self._values.items()},
        }


class Gauge(_Metric):
    """Last-written value, optionally labelled."""

    kind = "gauge"

    def __init__(self, name, help, lock):
        super().__init__(name, help, lock)
        self._values = {}

    def set(self, value, **labels):
        with self._lock:
            self._values[_label_key(labels)] = value
        return value

    def value(self, **labels):
        with self._lock:
            return self._values.get(_label_key(labels))

    def clear(self):
        with self._lock:
            self._values.clear()

    def _snapshot_locked(self):
        return {
            "kind": self.kind,
            "values": {_render_labels(k): v for k, v in self._values.items()},
        }


class Histogram(_Metric):
    """Fixed-bucket histogram: counts per upper bound + one overflow bucket,
    running sum/count/min/max. Quantiles are estimated by linear
    interpolation inside the containing bucket — exact enough for p50/p95
    dashboards, O(buckets) memory forever."""

    kind = "histogram"

    def __init__(self, name, help, lock, buckets=DEFAULT_MS_BUCKETS):
        super().__init__(name, help, lock)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram %r needs at least one bucket" % name)
        self._counts = [0] * (len(self.buckets) + 1)  # +1: overflow
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, value):
        value = float(value)
        with self._lock:
            i = 0
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    break
            else:
                i = len(self.buckets)
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            self._min = min(self._min, value)
            self._max = max(self._max, value)

    @property
    def count(self):
        with self._lock:
            return self._count

    def percentile(self, q):
        """q in [0, 100]. Interpolated within the containing bucket; the
        overflow bucket reports the observed max."""
        with self._lock:
            if not self._count:
                return None
            target = self._count * q / 100.0
            cum = 0
            lo = 0.0
            for i, ub in enumerate(self.buckets):
                prev = cum
                cum += self._counts[i]
                if cum >= target:
                    frac = (target - prev) / max(self._counts[i], 1)
                    return min(lo + frac * (ub - lo), self._max)
                lo = ub
            return self._max

    def clear(self):
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._sum = 0.0
            self._count = 0
            self._min = math.inf
            self._max = -math.inf

    def _snapshot_locked(self):
        return {
            "kind": self.kind,
            "buckets": list(self.buckets),
            "counts": list(self._counts),
            "sum": self._sum,
            "count": self._count,
            "min": self._min if self._count else None,
            "max": self._max if self._count else None,
        }


def _render_labels(key):
    """label tuple -> stable string form for snapshots ('' when unlabelled)."""
    return ",".join("%s=%s" % (k, v) for k, v in key)


def _label_pairs(labels):
    """Rendered label string -> [[k, v], ...]. A piece without '=' is the
    tail of a comma-holding label VALUE split apart by the join — rejoin it
    instead of 500ing every /metrics scrape."""
    pairs = []
    for p in labels.split(","):
        if "=" in p:
            pairs.append(p.split("=", 1))
        elif pairs:
            pairs[-1][1] += "," + p
    return pairs


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name):
    n = _PROM_BAD.sub("_", name)
    return ("_" + n) if n[:1].isdigit() else n


def _escape_label(v):
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _fmt_value(v):
    """Full-precision sample value: ints stay integral, floats render via
    repr (shortest round-trip form), non-finite uses the Prometheus
    spellings. %g would drop digits and break promparse exactness."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return repr(v)


def render_prometheus(snapshot, helps=None):
    """Registry-shaped snapshot dict -> Prometheus text exposition (0.0.4).

    Spec-conformant for real scrapers — `# HELP`/`# TYPE` lines, cumulative
    `le`-labelled `_bucket` series ending in `+Inf`, `_sum`/`_count` per
    histogram, escaped label values — plus two LOSSLESS extras that ride as
    legal comment / untyped-sample lines so observability.promparse can
    invert the text exactly back into the snapshot:

      - ``# NAME <prom_name> <registry_name>`` maps each sanitized sample
        family back to its registry name (slashes survive the round trip);
      - ``<name>_min`` / ``<name>_max`` samples carry the histogram extremes
        the standard exposition drops (percentile() clamps against max, and
        the fleet aggregator needs them for exact merged percentiles).

    Used by MetricRegistry.to_prometheus and by aggregate.FleetAggregator
    for the merged `GET /fleet/metrics` view.
    """
    helps = helps or {}
    lines = []
    for name, rec in sorted(snapshot.items()):
        pname = _prom_name(name)
        if helps.get(name):
            lines.append("# HELP %s %s" % (
                pname,
                str(helps[name]).replace("\\", "\\\\").replace("\n", "\\n"),
            ))
        lines.append("# TYPE %s %s" % (pname, rec["kind"]))
        lines.append("# NAME %s %s" % (pname, name))
        if rec["kind"] in ("counter", "gauge"):
            for labels, v in sorted(rec["values"].items()):
                if labels:
                    rendered = ",".join(
                        '%s="%s"' % (k, _escape_label(val))
                        for k, val in _label_pairs(labels)
                    )
                    lines.append("%s{%s} %s" % (pname, rendered, _fmt_value(v)))
                else:
                    lines.append("%s %s" % (pname, _fmt_value(v)))
        else:  # histogram
            cum = 0
            for ub, c in zip(rec["buckets"], rec["counts"]):
                cum += c
                lines.append(
                    '%s_bucket{le="%s"} %d' % (pname, _fmt_value(float(ub)), cum)
                )
            cum += rec["counts"][-1]
            lines.append('%s_bucket{le="+Inf"} %d' % (pname, cum))
            lines.append("%s_sum %s" % (pname, _fmt_value(rec["sum"])))
            lines.append("%s_count %d" % (pname, rec["count"]))
            if rec.get("min") is not None:
                lines.append("%s_min %s" % (pname, _fmt_value(rec["min"])))
            if rec.get("max") is not None:
                lines.append("%s_max %s" % (pname, _fmt_value(rec["max"])))
    return "\n".join(lines) + "\n"


class MetricRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}

    def _get_or_create(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise TypeError(
                        "metric %r already registered as %s, wanted %s"
                        % (name, m.kind, cls.kind)
                    )
                return m
            m = cls(name, help, self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help=""):
        return self._get_or_create(Counter, name, help)

    def gauge(self, name, help=""):
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name, help="", buckets=DEFAULT_MS_BUCKETS):
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name):
        """Existing metric or None — lookups must not create (health.get's
        contract: reading an unknown counter is 0, not a registration)."""
        with self._lock:
            return self._metrics.get(name)

    def names(self, prefix=""):
        with self._lock:
            return sorted(n for n in self._metrics if n.startswith(prefix))

    def remove(self, name):
        with self._lock:
            self._metrics.pop(name, None)

    def reset(self, prefix=""):
        """Clear values (and, with a prefix, the registrations themselves) —
        health.reset semantics: a reset counter disappears from snapshots."""
        with self._lock:
            for name in list(self._metrics):
                if name.startswith(prefix):
                    del self._metrics[name]

    def snapshot(self):
        """{name: {kind, values|buckets...}} — one lock pass, so the view is
        consistent across metrics."""
        with self._lock:
            return {
                name: m._snapshot_locked()
                for name, m in sorted(self._metrics.items())
            }

    def to_prometheus(self):
        """Prometheus text exposition of the whole registry (export.py writes
        this to the flag-gated scrape file; promparse.parse inverts it
        exactly — see render_prometheus)."""
        snap = self.snapshot()
        with self._lock:
            helps = {n: m.help for n, m in self._metrics.items()}
        return render_prometheus(snap, helps=helps)


_default = MetricRegistry()


def default_registry():
    return _default
