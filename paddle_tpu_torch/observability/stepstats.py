"""Per-step runtime statistics (StepStats), collected from the executor stack
(the torch counterpart of paddle_tpu/observability/stepstats.py, the same
records and metric names).

Hook points (all behind `active()`: one flags lookup when telemetry is off,
so the disabled path costs nothing measurable against a millisecond step):

- Executor.run / ParallelExecutor.run call `collector().record_step(...)`
  with the step's host wall time, block-cache hit or miss, the NaN guard's
  verdict, and (for pipelined blocks) the pp schedule parameters. The loss
  is read only when the fetch is already on the host: telemetry adds no
  device sync of its own;
- py_reader.PyReader.next_batch and data.DataRuntime.next_batch report the
  time spent BLOCKED on the staging queue via `add_feed_stall()`,
  attributed to the next recorded step (the time the device would have
  idled waiting for data);
- resilience.health counters ride the shared registry, so retry, backoff
  and NaN events appear in the same snapshots.

Pipeline-bubble measurement: with t(m) = c + (m+pp-1)*tau (the GPipe/1F1B
step model), a single microbatch count m cannot separate the per-tick time
tau from the fixed overhead c, so the collector keeps per-(pp, schedule, m)
minimum step times and, once two m groups exist, computes tau from the
two-m slope and the bubble 1 - m*tau/t(m) for the smallest m. Until a
second m group exists, only the analytic gauge `pp/bubble_analytic` =
(pp-1)/(m+pp-1) is published. Min-over-steps is the right aggregate here:
harness noise is one-sided (stalls only ever ADD time).
"""

import sys
import threading
import time
from collections import deque

from . import registry as _registry

__all__ = [
    "StepStats",
    "StepStatsCollector",
    "collector",
    "active",
    "analytic_bubble",
]


def analytic_bubble(pp, n_micro):
    """Classic GPipe/1F1B fill-drain bubble fraction (pp-1)/(m+pp-1); both
    schedules share it (1F1B changes liveness, not the bubble)."""
    return (pp - 1) / float(n_micro + pp - 1)


class StepStats:
    """One recorded executor step (possibly a k-step multi-step call)."""

    __slots__ = (
        "step", "ts", "wall_ms", "n_steps", "feed_stall_ms", "cache_hit",
        "nan_trip", "pp", "n_micro", "schedule", "loss", "training",
        "items", "item_unit",
    )

    def __init__(self, step, ts, wall_ms, n_steps=1, feed_stall_ms=0.0,
                 cache_hit=True, nan_trip=False, pp=None, n_micro=None,
                 schedule=None, loss=None, training=True, items=0,
                 item_unit="img"):
        self.step = step
        self.ts = ts
        self.wall_ms = wall_ms
        self.n_steps = n_steps
        self.feed_stall_ms = feed_stall_ms
        self.cache_hit = cache_hit
        self.nan_trip = nan_trip
        self.pp = pp
        self.n_micro = n_micro
        self.schedule = schedule
        self.loss = loss
        self.training = training
        self.items = items
        self.item_unit = item_unit

    def to_dict(self):
        d = {
            "kind": "step",
            "step": self.step,
            "ts": self.ts,
            "wall_ms": round(self.wall_ms, 4),
            "n_steps": self.n_steps,
            "feed_stall_ms": round(self.feed_stall_ms, 4),
            "cache_hit": self.cache_hit,
            "nan_trip": self.nan_trip,
            "training": self.training,
        }
        if self.pp:
            d["pp"] = self.pp
            d["n_micro"] = self.n_micro
            d["schedule"] = self.schedule
        if self.loss is not None:
            d["loss"] = self.loss
        if self.items:
            d["items"] = self.items
            d["item_unit"] = self.item_unit
        return d


def _flags():
    from .. import flags as f

    return f.get_flags(
        ("telemetry_dir", "telemetry_interval_steps", "telemetry_log_every")
    )


def active():
    """Cheap per-run gate: telemetry is on iff an export dir or the periodic
    health line is configured (FLAGS_telemetry_dir /
    FLAGS_telemetry_log_every), or a collector was force-enabled in code."""
    f = _flags()
    return bool(f["telemetry_dir"]) or f["telemetry_log_every"] > 0 or \
        _collector_forced


_collector_forced = False


class StepStatsCollector:
    def __init__(self, registry=None, window=1024):
        self._lock = threading.Lock()
        self.registry = registry or _registry.default_registry()
        self.recent = deque(maxlen=window)
        self._step = 0
        self._pending_stall_ms = 0.0
        # (pp, schedule, n_micro) -> [count, total_ms, min_ms]
        self._pp_groups = {}
        self._exporter = None
        self._exporter_dir = None
        self._last_health = {}
        self._last_line_ts = None
        self._last_line_step = 0
        self._m = {
            "steps": self.registry.counter(
                "steps_total", "training steps recorded"),
            "step_ms": self.registry.histogram(
                "step_ms", "per-step host wall time (ms)"),
            "stall_ms": self.registry.counter(
                "input/feed_stall_ms_total",
                "time blocked waiting on the input pipeline (ms)"),
            "cache_hits": self.registry.counter(
                "compile_cache/hits", "executor compile-cache hits"),
            "cache_misses": self.registry.counter(
                "compile_cache/misses",
                "executor compile-cache misses (trace+compile paid)"),
            "nan_trips": self.registry.counter(
                "nan_guard/trips", "NaN/Inf step-guard activations"),
            "items": self.registry.counter(
                "goodput/items_total",
                "rows/images/tokens processed, by unit (slo.GoodputSentinel "
                "divides the windowed delta by wall time for MFU-online)"),
        }

    # ---- hook API -----------------------------------------------------
    def add_feed_stall(self, ms):
        """Called by PyReader.next_batch with the time it spent blocked on
        the staging queue; folded into the NEXT recorded step."""
        with self._lock:
            self._pending_stall_ms += ms
        self._m["stall_ms"].inc(ms)

    def record_step(self, wall_ms, n_steps=1, cache_hit=True, nan_trip=False,
                    pp=None, n_micro=None, schedule=None, loss=None,
                    training=True, items=0, item_unit="img"):
        """One executor run. `n_steps` > 1 for multi-step (steps_per_run)
        calls: counters advance by k, per-step time is wall/k. `items` is
        the number of rows/images/tokens the run processed — it feeds the
        `goodput/items_total` counter the slo.GoodputSentinel divides by
        wall time for the live MFU-online gauge."""
        now = time.time()
        with self._lock:
            stall = self._pending_stall_ms
            self._pending_stall_ms = 0.0
            self._step += n_steps
            step = self._step
        st = StepStats(
            step, now, wall_ms, n_steps=n_steps, feed_stall_ms=stall,
            cache_hit=cache_hit, nan_trip=nan_trip, pp=pp, n_micro=n_micro,
            schedule=schedule, loss=loss, training=training, items=items,
            item_unit=item_unit,
        )
        per_step_ms = wall_ms / max(n_steps, 1)
        if training:
            self._m["steps"].inc(n_steps)
            self._m["step_ms"].observe(per_step_ms)
        if items:
            self._m["items"].inc(items, unit=item_unit)
        self._m["cache_hits" if cache_hit else "cache_misses"].inc()
        if nan_trip:
            self._m["nan_trips"].inc()
        if pp and n_micro:
            self._record_pp(pp, schedule or "gpipe", n_micro, per_step_ms)
        with self._lock:
            self.recent.append(st)
        self._export(st)
        self._maybe_log_line(st)
        return st

    # ---- pipeline bubble ----------------------------------------------
    def _record_pp(self, pp, schedule, n_micro, step_ms):
        with self._lock:
            g = self._pp_groups.setdefault(
                (pp, schedule, n_micro), [0, 0.0, float("inf")]
            )
            g[0] += 1
            g[1] += step_ms
            g[2] = min(g[2], step_ms)
        self.registry.gauge(
            "pp/bubble_analytic",
            "GPipe fill-drain bound (pp-1)/(m+pp-1) for the running config",
        ).set(round(analytic_bubble(pp, n_micro), 4))
        est = self.bubble_estimate()
        if est is not None:
            self.registry.gauge(
                "pp/bubble_measured",
                "two-m-slope runtime bubble (bench.py run_pp_bench estimator)",
            ).set(round(max(0.0, min(1.0, est["bubble"])), 4))

    def bubble_estimate(self):
        """Two-m-slope bubble over the recorded (pp, schedule) groups, or
        None until two microbatch counts have been observed. Returns
        {pp, schedule, m1, m2, t1_ms, t2_ms, tick_ms, bubble, analytic}."""
        with self._lock:
            by_cfg = {}
            for (pp, sched, m), (_c, _tot, mn) in self._pp_groups.items():
                by_cfg.setdefault((pp, sched), []).append((m, mn))
        for (pp, sched), pts in sorted(by_cfg.items()):
            if len(pts) < 2:
                continue
            pts.sort()
            (m1, t1), (m2, t2) = pts[0], pts[-1]
            tau = (t2 - t1) / (m2 - m1)
            return {
                "pp": pp,
                "schedule": sched,
                "m1": m1,
                "m2": m2,
                "t1_ms": round(t1, 4),
                "t2_ms": round(t2, 4),
                "tick_ms": round(tau, 4),
                "bubble": round(1.0 - m1 * tau / t1, 4) if t1 > 0 else None,
                "analytic": round(analytic_bubble(pp, m1), 4),
            }
        return None

    # ---- export / logging ----------------------------------------------
    def _get_exporter(self):
        f = _flags()
        d = f["telemetry_dir"]
        if not d:
            return None
        if self._exporter is None or self._exporter_dir != d:
            from .export import TelemetryExporter

            if self._exporter is not None:
                self._exporter.close()
            self._exporter = TelemetryExporter(
                d,
                interval_steps=max(int(f["telemetry_interval_steps"]), 1),
                registry=self.registry,
            )
            self._exporter_dir = d
        return self._exporter

    def _export(self, st):
        exp = self._get_exporter()
        if exp is not None:
            exp.on_step(st.to_dict(), self)

    def flush(self):
        """Force the exporter's interval work (snapshot record, Prometheus
        file, rank-0 merge) now — run loops call this at epoch ends."""
        exp = self._get_exporter()
        if exp is not None:
            exp.flush(self)

    def _maybe_log_line(self, st):
        every = int(_flags()["telemetry_log_every"])
        if every <= 0:
            return
        with self._lock:
            due = st.step - self._last_line_step >= every
            if not due:
                return
            prev_ts, prev_step = self._last_line_ts, self._last_line_step
            self._last_line_ts, self._last_line_step = st.ts, st.step
            prev_health = self._last_health
        from ..resilience import health as _health

        h = _health.snapshot()
        with self._lock:
            self._last_health = dict(h)
        deltas = {
            k: v - prev_health.get(k, 0)
            for k, v in sorted(h.items())
            if v - prev_health.get(k, 0)
        }
        parts = [
            "step=%d" % st.step,
            "step_ms=%.2f" % (st.wall_ms / max(st.n_steps, 1)),
        ]
        if prev_ts is not None and st.ts > prev_ts:
            parts.append(
                "steps_per_s=%.2f" % ((st.step - prev_step) / (st.ts - prev_ts))
            )
        if st.loss is not None:
            parts.append("loss=%.6g" % st.loss)
        if st.feed_stall_ms:
            parts.append("stall_ms=%.2f" % st.feed_stall_ms)
        if st.pp:
            parts.append("pp=%d m=%d" % (st.pp, st.n_micro))
        for k, v in deltas.items():
            parts.append("%s=+%d" % (k, v))
        # the "is it alive" line: stderr, so JSON emitters on stdout stay
        # parseable
        print("[telemetry] " + " ".join(parts), file=sys.stderr, flush=True)

    # ---- introspection --------------------------------------------------
    def snapshot(self):
        with self._lock:
            recent = list(self.recent)
        return {
            "step": self._step,
            "recent": [s.to_dict() for s in recent],
            "bubble": self.bubble_estimate(),
        }

    def reset(self):
        with self._lock:
            self.recent.clear()
            self._step = 0
            self._pending_stall_ms = 0.0
            self._pp_groups.clear()
            self._last_health = {}
            self._last_line_ts = None
            self._last_line_step = 0

    def close(self):
        if self._exporter is not None:
            self._exporter.close()
            self._exporter = None
            self._exporter_dir = None


_collector = None
_collector_lock = threading.Lock()


def collector():
    """Process-wide StepStatsCollector (lazy singleton)."""
    global _collector
    if _collector is None:
        with _collector_lock:
            if _collector is None:
                _collector = StepStatsCollector()
    return _collector


def maybe_flush():
    """Flush a snapshot/Prometheus rewrite IF telemetry is on — the interval
    clock for subsystems with no training step to ride (the serving batcher
    every N dispatches, the online HotReloader after a swap). Never raises:
    telemetry must not fail the caller's hot path."""
    try:
        if active():
            collector().flush()
    except Exception:
        pass
