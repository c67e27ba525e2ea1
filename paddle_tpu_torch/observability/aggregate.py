"""Fleet-wide metrics aggregation: one pane of glass over N replicas.

Monarch-style (VLDB'20) leaf scraping: a `FleetAggregator` periodically
pulls every registered replica's `GET /metrics` exposition, parses it back
into registry-shaped snapshots (observability/promparse.py), folds in the
router's own registry, and merges:

- counters   by SUM across sources, per label set;
- gauges     into per-replica-labelled series (a `replica=<name>` label is
             added), with min/max/sum/mean rollups computed in `stats()`;
- histograms BUCKET-WISE — every process shares the registry's bounded
             bucket grid (DEFAULT_MS_BUCKETS unless a metric opts out), so
             element-wise count addition yields exactly the histogram a
             single pooled process would have held, and fleet-level
             p50/p99 from `hist_percentile` are bit-equal to percentiles
             over the pooled raw observations (tested + gated by
             `bench.py slo`). Mismatched grids are skipped and counted.

The merged view is served by the fleet router as `GET /fleet/metrics`
(exposition text via registry.render_prometheus) and `GET /fleet/stats`
(JSON rollups), rendered live by `tools/monitor.py --fleet_url`, and
retained as a bounded in-memory history of (ts, snapshot) pairs — the
window store the SLO burn-rate engine (observability/slo.py) evaluates
over. A replica dying mid-scrape is tolerated: its fetch error is recorded
in the scrape metadata and `fleet/scrape_errors`, and the merge proceeds
with the survivors.

Everything here is pull-based and off by default: no scrape loop runs
unless Router(fleet_metrics=True) or FleetAggregator.start() is called.

A copy of paddle_tpu/observability/aggregate.py (pure Python, no device
code), kept in the port so that the port imports nothing of the JAX
package.
"""

import json
import threading
import time
import urllib.request
from collections import deque

from . import promparse
from . import registry as _registry

__all__ = [
    "FleetAggregator",
    "FleetSnapshot",
    "hist_percentile",
    "merge_snapshots",
]


def hist_percentile(rec, q):
    """Percentile of a snapshot-shaped histogram record — the same linear
    interpolation Histogram.percentile performs, operating on merged
    counts. Identical arithmetic on identical counts/max is what makes the
    fleet p99 bit-equal to the pooled-observation p99."""
    count = rec.get("count") or 0
    if not count:
        return None
    target = count * q / 100.0
    cum = 0
    lo = 0.0
    counts = rec["counts"]
    mx = rec.get("max")
    for i, ub in enumerate(rec["buckets"]):
        prev = cum
        cum += counts[i]
        if cum >= target:
            frac = (target - prev) / max(counts[i], 1)
            v = lo + frac * (ub - lo)
            return min(v, mx) if mx is not None else v
        lo = ub
    return mx if mx is not None else rec["buckets"][-1]


def _labels_with(labels, **extra):
    """Add labels to a rendered label string, keeping the sorted form the
    registry snapshot uses."""
    pairs = [tuple(p) for p in _registry._label_pairs(labels)] if labels else []
    pairs.extend((k, str(v)) for k, v in extra.items())
    return ",".join("%s=%s" % (k, v) for k, v in sorted(pairs))


def _merge_minmax(a, b, fn):
    if a is None:
        return b
    if b is None:
        return a
    return fn(a, b)


def merge_snapshots(named, mismatch_counter=None):
    """[(source_name, snapshot)] -> one merged registry-shaped snapshot.

    Sources whose histogram bucket grid disagrees with the first-seen grid
    for a metric are skipped for that metric (and counted on
    `mismatch_counter` when given) — summing counts across different
    grids would silently corrupt percentiles."""
    merged = {}
    for src, snap in named:
        for name, rec in snap.items():
            kind = rec.get("kind")
            dst = merged.get(name)
            if dst is not None and dst.get("kind") != kind:
                if mismatch_counter is not None:
                    mismatch_counter.inc(metric=name)
                continue
            if kind == "counter":
                if dst is None:
                    dst = merged[name] = {"kind": "counter", "values": {}}
                for labels, v in rec.get("values", {}).items():
                    dst["values"][labels] = dst["values"].get(labels, 0) + v
            elif kind == "gauge":
                if dst is None:
                    dst = merged[name] = {"kind": "gauge", "values": {}}
                for labels, v in rec.get("values", {}).items():
                    dst["values"][_labels_with(labels, replica=src)] = v
            elif kind == "histogram":
                if dst is None:
                    merged[name] = {
                        "kind": "histogram",
                        "buckets": list(rec["buckets"]),
                        "counts": list(rec["counts"]),
                        "sum": rec["sum"],
                        "count": rec["count"],
                        "min": rec.get("min"),
                        "max": rec.get("max"),
                    }
                else:
                    if list(dst["buckets"]) != list(rec["buckets"]):
                        if mismatch_counter is not None:
                            mismatch_counter.inc(metric=name)
                        continue
                    dst["counts"] = [
                        a + b for a, b in zip(dst["counts"], rec["counts"])
                    ]
                    dst["sum"] += rec["sum"]
                    dst["count"] += rec["count"]
                    dst["min"] = _merge_minmax(dst["min"], rec.get("min"), min)
                    dst["max"] = _merge_minmax(dst["max"], rec.get("max"), max)
    return dict(sorted(merged.items()))


class FleetSnapshot:
    """One scrape round: wall time, the merged snapshot, per-target meta."""

    __slots__ = ("ts", "merged", "targets")

    def __init__(self, ts, merged, targets):
        self.ts = ts
        self.merged = merged
        self.targets = targets


def _default_fetch(url, timeout_s):
    with urllib.request.urlopen(url + "/metrics", timeout=timeout_s) as r:
        return r.read().decode("utf-8", "replace")


class FleetAggregator:
    """Scrape loop + bounded snapshot history (see module docstring).

    `targets` is {name: base_url} or a callable returning one — the router
    passes a closure over its replica table so membership changes are
    picked up on the next scrape. `fetch` and `clock` are injectable for
    tests."""

    def __init__(self, targets, local_registry=None, local_name="router",
                 interval_s=2.0, timeout_s=2.0, history_s=6 * 3600 + 600,
                 max_history=4096, clock=time.time, fetch=None):
        self._targets = targets
        self._local_registry = local_registry
        self._local_name = local_name
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self.history_s = float(history_s)
        self._clock = clock
        self._fetch = fetch or _default_fetch
        self._lock = threading.Lock()
        self._history = deque(maxlen=max_history)
        self._listeners = []
        self._stop = threading.Event()
        self._thread = None
        reg = local_registry or _registry.default_registry()
        self._m_scrapes = reg.counter(
            "fleet/scrapes", "aggregator scrape rounds completed"
        )
        self._m_errors = reg.counter(
            "fleet/scrape_errors", "replica /metrics fetches that failed"
        )
        self._m_mismatch = reg.counter(
            "fleet/scrape_grid_mismatch",
            "histogram merges skipped for a disagreeing bucket grid",
        )
        self._h_scrape = reg.histogram(
            "fleet/scrape_ms", "wall time of one full scrape+merge round"
        )

    # ---- scraping ---------------------------------------------------------
    def add_listener(self, cb):
        """cb(FleetSnapshot) after every scrape — the AlertEngine hook."""
        self._listeners.append(cb)

    def scrape_once(self):
        t0 = time.perf_counter()
        now = self._clock()
        named = []
        meta = {}
        if self._local_registry is not None:
            named.append((self._local_name, self._local_registry.snapshot()))
            meta[self._local_name] = {"ok": True, "error": None,
                                      "scrape_ms": 0.0}
        targets = (self._targets() if callable(self._targets)
                   else self._targets)
        for name, url in sorted(dict(targets).items()):
            f0 = time.perf_counter()
            try:
                snap = promparse.parse(self._fetch(url, self.timeout_s))
                named.append((name, snap))
                meta[name] = {
                    "ok": True, "error": None,
                    "scrape_ms": round((time.perf_counter() - f0) * 1e3, 3),
                }
            except Exception as e:  # dead mid-scrape: merge the survivors
                self._m_errors.inc(replica=name)
                meta[name] = {
                    "ok": False, "error": repr(e),
                    "scrape_ms": round((time.perf_counter() - f0) * 1e3, 3),
                }
        merged = merge_snapshots(named, mismatch_counter=self._m_mismatch)
        fs = FleetSnapshot(now, merged, meta)
        with self._lock:
            self._history.append(fs)
            while (len(self._history) > 1
                   and now - self._history[0].ts > self.history_s):
                self._history.popleft()
        self._m_scrapes.inc()
        self._h_scrape.observe((time.perf_counter() - t0) * 1e3)
        for cb in list(self._listeners):
            cb(fs)
        return fs

    def latest(self):
        with self._lock:
            return self._history[-1] if self._history else None

    def history(self, window_s=None):
        """Ascending [(ts, merged_snapshot)] — the SLO engine's window
        store."""
        with self._lock:
            items = list(self._history)
        if window_s is not None and items:
            cutoff = items[-1].ts - window_s
            items = [fs for fs in items if fs.ts >= cutoff]
        return [(fs.ts, fs.merged) for fs in items]

    # ---- serving-side views ----------------------------------------------
    def metrics_text(self):
        """Merged fleet snapshot as exposition text (GET /fleet/metrics)."""
        fs = self.latest() or self.scrape_once()
        return _registry.render_prometheus(fs.merged)

    def stats(self):
        """JSON-shaped fleet rollup (GET /fleet/stats)."""
        fs = self.latest() or self.scrape_once()
        counters, gauges, hists = {}, {}, {}
        for name, rec in fs.merged.items():
            if rec["kind"] == "counter":
                vals = [v for v in rec["values"].values()
                        if isinstance(v, (int, float))]
                counters[name] = {"total": sum(vals), "series": len(vals)}
            elif rec["kind"] == "gauge":
                vals = [v for v in rec["values"].values()
                        if isinstance(v, (int, float))]
                if vals:
                    gauges[name] = {
                        "n": len(vals),
                        "min": min(vals),
                        "max": max(vals),
                        "sum": sum(vals),
                        "mean": sum(vals) / len(vals),
                    }
            else:
                hists[name] = {
                    "count": rec["count"],
                    "sum": rec["sum"],
                    "min": rec.get("min"),
                    "max": rec.get("max"),
                    "p50": hist_percentile(rec, 50),
                    "p90": hist_percentile(rec, 90),
                    "p99": hist_percentile(rec, 99),
                }
        return {
            "ts": fs.ts,
            "interval_s": self.interval_s,
            "targets": fs.targets,
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
        }

    def stats_json(self):
        return json.dumps(self.stats())

    # ---- lifecycle --------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="fleet-aggregator", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.scrape_once()
            except Exception:  # a bad round must not kill the loop
                pass
            self._stop.wait(self.interval_s)

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(5.0)
