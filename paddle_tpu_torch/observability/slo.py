"""Declarative SLOs, multi-window burn-rate alerting, and drift sentinels.

Alerting follows the Google SRE Workbook (ch. 5) multi-window
multi-burn-rate recipe rather than raw thresholds: an `SLO` declares an
objective (availability of a counter selector, or a latency threshold over
a histogram selector), and the `AlertEngine` evaluates each SLO's error
ratio over a SHORT and a LONG window per rule. An alert fires only when
both windows burn error budget faster than the rule's factor — the long
window proves the problem is real, the short window makes the alert
resolve quickly once the fault clears. Defaults are the Workbook's page
(5m/1h at 14.4x) and ticket (30m/6h at 6x) rules; windows, factors and the
clock are injectable so tests and `bench.py slo` run at compressed
timescales.

The engine reads windowed deltas from any history provider with a
`history(window_s=None) -> [(ts, snapshot)]` method: the fleet-merged
store of aggregate.FleetAggregator, or the in-process `LocalSampler` for
single-process training loops. Firing/resolving produces `AlertEvent`s
that

- update the `slo/alerts_firing` gauge and `slo/alert_events` counter,
- write one structured `[slo] {...}` JSON line to stderr,
- append to an optional JSONL file (`tools/timeline.py --alerts_path`
  renders fire->resolve pairs as a chrome-trace track), and
- trigger a flight-recorder bundle (reason "slo_alert") carrying the
  offending window's merged series, so the anomaly dump holds the exact
  numbers that fired the alert.

Sentinels ride the same evaluation loop and catch regressions no static
threshold sees: `DriftSentinel` (EWMA fast/slow step-time or token-latency
drift), `RetraceSentinel` (compile-cache miss counter moving after steady
state — a post-warmup retrace), and `GoodputSentinel` (tokens/s / img/s vs
a roofline the caller gives, i.e. MFU-online, fed from the stepstats
counters). Everything is off by default: nothing evaluates unless an
engine is constructed and driven.

A copy of paddle_tpu/observability/slo.py (pure Python, no device
code), kept in the port so that the port imports nothing of the JAX
package.
"""

import json
import sys
import time

from . import flightrec as _flightrec
from . import registry as _registry

__all__ = [
    "SLO",
    "AlertEngine",
    "AlertEvent",
    "BurnRateRule",
    "DEFAULT_RULES",
    "DriftSentinel",
    "GoodputSentinel",
    "LocalSampler",
    "RetraceSentinel",
    "window_delta",
]


# --------------------------------------------------------------- windows
def _counter_total(snapshot, name):
    rec = snapshot.get(name)
    if not rec or rec.get("kind") != "counter":
        return 0
    return sum(v for v in rec["values"].values()
               if isinstance(v, (int, float)))


def window_delta(history, now, window_s, name):
    """Delta of cumulative metric `name` over [now - window_s, now].

    `history` is ascending [(ts, snapshot)]. The current point is the
    newest snapshot at/before `now`; the baseline is the newest snapshot
    at/before `now - window_s`, falling back to the OLDEST snapshot when
    history is younger than the window (partial window — standard burn-rate
    behaviour while history warms up). Returns (delta_rec, span_s) with
    delta_rec shaped like a snapshot record, or (None, 0.0) when fewer than
    two usable points exist. Counter resets (a restarted replica) clamp to
    the current value instead of going negative."""
    cur = base = None
    for ts, snap in history:
        if ts <= now:
            if base is None or ts <= now - window_s:
                base = (ts, snap)
            cur = (ts, snap)
    if cur is None or base is None or cur[0] <= base[0]:
        return None, 0.0
    span_s = cur[0] - base[0]
    c = cur[1].get(name)
    b = base[1].get(name, None)
    if c is None:
        return None, 0.0
    if c["kind"] == "counter":
        bvals = (b or {}).get("values", {}) if b else {}
        values = {}
        for labels, v in c["values"].items():
            d = v - bvals.get(labels, 0)
            values[labels] = d if d >= 0 else v  # reset: restart from 0
        return {"kind": "counter", "values": values}, span_s
    if c["kind"] == "histogram":
        if (not b or b.get("kind") != "histogram"
                or list(b["buckets"]) != list(c["buckets"])):
            return dict(c), span_s
        counts = [x - y for x, y in zip(c["counts"], b["counts"])]
        if any(x < 0 for x in counts):  # reset mid-window
            return dict(c), span_s
        return {
            "kind": "histogram",
            "buckets": list(c["buckets"]),
            "counts": counts,
            "sum": c["sum"] - b["sum"],
            "count": c["count"] - b["count"],
            # cumulative histograms don't carry windowed extremes; the
            # lifetime ones are the best available clamp
            "min": c.get("min"),
            "max": c.get("max"),
        }, span_s
    return dict(c), span_s


# --------------------------------------------------------------- SLO
class SLO:
    """One declarative objective over a registry metric selector.

    Availability (counter selector)::

        SLO("availability", objective=0.999, counter="fleet/requests",
            bad={"code": "5"})           # label prefix match -> bad event
        SLO("errors", objective=0.999, counter="serving/m/requests",
            bad_counter="serving/m/errors")

    Latency threshold (histogram selector)::

        SLO("latency", objective=0.99, histogram="fleet/request_ms",
            threshold_ms=100)            # good = observation <= threshold

    `error_ratio(history, now, window_s)` returns the fraction of events in
    the window that violated the objective, or None when the window holds
    fewer than `min_events` events (no traffic must not fire alerts)."""

    def __init__(self, name, objective, counter=None, bad=None,
                 bad_counter=None, histogram=None, threshold_ms=None,
                 min_events=1, description=""):
        if not 0.0 < objective < 1.0:
            raise ValueError("objective must be in (0, 1), got %r" % objective)
        if bool(counter) == bool(histogram):
            raise ValueError(
                "SLO %r needs exactly one of counter=/histogram=" % name)
        if counter and not (bad or bad_counter):
            raise ValueError(
                "counter SLO %r needs bad= label prefixes or bad_counter="
                % name)
        if histogram and threshold_ms is None:
            raise ValueError("histogram SLO %r needs threshold_ms=" % name)
        self.name = name
        self.objective = float(objective)
        self.counter = counter
        self.bad = dict(bad or {})
        self.bad_counter = bad_counter
        self.histogram = histogram
        self.threshold_ms = None if threshold_ms is None else float(threshold_ms)
        self.min_events = int(min_events)
        self.description = description

    @property
    def budget(self):
        """Allowed error ratio: 1 - objective."""
        return 1.0 - self.objective

    @property
    def selector(self):
        return self.counter or self.histogram

    def _is_bad(self, labels):
        if not self.bad:
            return False
        d = dict((k, v) for k, v in _registry._label_pairs(labels))
        return all(
            k in d and str(d[k]).startswith(str(prefix))
            for k, prefix in self.bad.items()
        )

    def error_ratio(self, history, now, window_s):
        delta, _span = window_delta(history, now, window_s, self.selector)
        if delta is None:
            return None
        if self.counter:
            total = sum(delta["values"].values())
            if total < self.min_events:
                return None
            if self.bad_counter:
                bad_delta, _ = window_delta(
                    history, now, window_s, self.bad_counter)
                bad = sum(bad_delta["values"].values()) if bad_delta else 0
            else:
                bad = sum(v for labels, v in delta["values"].items()
                          if self._is_bad(labels))
            return min(max(bad / total, 0.0), 1.0)
        count = delta.get("count") or 0
        if count < self.min_events:
            return None
        good = sum(
            c for ub, c in zip(delta["buckets"], delta["counts"])
            if ub <= self.threshold_ms + 1e-9
        )
        return min(max(1.0 - good / count, 0.0), 1.0)

    def to_dict(self):
        return {
            "name": self.name,
            "objective": self.objective,
            "selector": self.selector,
            "kind": "availability" if self.counter else "latency",
            "threshold_ms": self.threshold_ms,
        }


class BurnRateRule:
    """Fire when BOTH windows burn budget faster than `factor`."""

    def __init__(self, severity, short_s, long_s, factor):
        self.severity = severity
        self.short_s = float(short_s)
        self.long_s = float(long_s)
        self.factor = float(factor)

    def to_dict(self):
        return {
            "severity": self.severity,
            "short_s": self.short_s,
            "long_s": self.long_s,
            "factor": self.factor,
        }

    def __repr__(self):  # stable: DEFAULT_RULES appear in API signatures
        return "BurnRateRule(%r, %g, %g, %g)" % (
            self.severity, self.short_s, self.long_s, self.factor
        )


# SRE Workbook ch.5: 14.4x over 5m+1h pages (2% of a 30d budget in 1h),
# 6x over 30m+6h tickets (5% of the budget in 6h)
DEFAULT_RULES = (
    BurnRateRule("page", 300.0, 3600.0, 14.4),
    BurnRateRule("ticket", 1800.0, 21600.0, 6.0),
)


class AlertEvent:
    """One fire or resolve transition."""

    def __init__(self, name, severity, state, ts, info=None, series=None):
        self.name = name          # SLO or sentinel name
        self.severity = severity  # page | ticket | drift | goodput | ...
        self.state = state        # "firing" | "resolved"
        self.ts = ts
        self.info = dict(info or {})
        self.series = series      # offending window's merged series (fire)

    def to_dict(self, with_series=False):
        d = {
            "kind": "alert",
            "name": self.name,
            "severity": self.severity,
            "event": "fired" if self.state == "firing" else "resolved",
            "ts": self.ts,
        }
        d.update(self.info)
        if with_series and self.series is not None:
            d["series"] = self.series
        return d


# --------------------------------------------------------------- engine
class AlertEngine:
    """Evaluates SLO burn rates + sentinels against a snapshot history.

    Driven either by FleetAggregator.add_listener(engine.on_snapshot) — the
    router wires this when slos/sentinels are passed — or by calling
    `evaluate(now)` directly on an injected clock (tests, bench)."""

    def __init__(self, slos=(), history=None, rules=DEFAULT_RULES,
                 registry=None, clock=time.time, out_path=None,
                 log_stderr=True, flightrec=True):
        self.slos = list(slos)
        self.rules = list(rules)
        self._history = history
        self._clock = clock
        self.out_path = out_path
        self.log_stderr = log_stderr
        self.flightrec = flightrec
        self._sentinels = []
        self._active = {}   # (name, severity) -> AlertEvent (firing)
        self.events = []    # every transition, in order
        reg = registry or _registry.default_registry()
        self._g_firing = reg.gauge(
            "slo/alerts_firing", "alerts currently firing (SLO + sentinel)"
        )
        self._g_firing.set(0)
        self._m_events = reg.counter(
            "slo/alert_events", "alert transitions by name/severity/event"
        )
        self._g_burn = reg.gauge(
            "slo/burn_rate", "latest burn rate per SLO and window"
        )

    def add_sentinel(self, sentinel):
        self._sentinels.append(sentinel)
        return sentinel

    # ---- transitions ------------------------------------------------------
    def _emit(self, ev):
        self.events.append(ev)
        self._g_firing.set(len(self._active))
        self._m_events.inc(
            name=ev.name, severity=ev.severity,
            event="fired" if ev.state == "firing" else "resolved",
        )
        line = json.dumps(ev.to_dict(), sort_keys=True)
        if self.log_stderr:
            sys.stderr.write("[slo] %s\n" % line)
        if self.out_path:
            try:
                with open(self.out_path, "a") as f:
                    f.write(json.dumps(ev.to_dict(with_series=True),
                                       sort_keys=True) + "\n")
            except OSError:
                pass
        if ev.state == "firing" and self.flightrec:
            # the bundle carries the exact windowed series that fired
            _flightrec.trigger(
                "slo_alert", name=ev.name, severity=ev.severity,
                series=ev.series, **ev.info
            )

    def _fire(self, key, now, info, series=None):
        if key in self._active:
            return None
        ev = AlertEvent(key[0], key[1], "firing", now, info, series)
        self._active[key] = ev
        self._emit(ev)
        return ev

    def _resolve(self, key, now, info):
        fired = self._active.pop(key, None)
        if fired is None:
            return None
        info = dict(info)
        info["fired_ts"] = fired.ts
        info["duration_s"] = round(now - fired.ts, 3)
        ev = AlertEvent(key[0], key[1], "resolved", now, info)
        self._emit(ev)
        return ev

    # ---- evaluation -------------------------------------------------------
    def on_snapshot(self, fs):
        """FleetAggregator listener: evaluate at the scrape's timestamp."""
        self.evaluate(now=fs.ts)

    def evaluate(self, now=None):
        """One tick: every SLO x rule, then every sentinel. Returns this
        tick's transitions (AlertEvents)."""
        now = self._clock() if now is None else now
        hist = self._history.history() if self._history is not None else []
        out = []
        for slo in self.slos:
            for rule in self.rules:
                r_short = slo.error_ratio(hist, now, rule.short_s)
                r_long = slo.error_ratio(hist, now, rule.long_s)
                budget = slo.budget
                b_short = None if r_short is None else r_short / budget
                b_long = None if r_long is None else r_long / budget
                if b_short is not None:
                    self._g_burn.set(
                        round(b_short, 4),
                        slo=slo.name, window="%ds" % int(rule.short_s),
                    )
                firing = (
                    b_short is not None and b_long is not None
                    and b_short > rule.factor and b_long > rule.factor
                )
                key = (slo.name, rule.severity)
                info = {
                    "slo": slo.to_dict(),
                    "rule": rule.to_dict(),
                    "burn_short": b_short,
                    "burn_long": b_long,
                }
                if firing:
                    series, _ = window_delta(
                        hist, now, rule.short_s, slo.selector)
                    ev = self._fire(key, now, info, series=series)
                else:
                    ev = self._resolve(key, now, info)
                if ev is not None:
                    out.append(ev)
        for s in self._sentinels:
            state, info, series = s.evaluate(hist, now)
            key = (s.name, s.severity)
            if state == "firing":
                ev = self._fire(key, now, info, series=series)
            elif state == "ok":
                ev = self._resolve(key, now, info)
            else:  # warming / hold: no transition either way
                ev = None
            if ev is not None:
                out.append(ev)
        self._g_firing.set(len(self._active))
        return out

    def firing(self):
        return list(self._active.values())

    def stats(self):
        return {
            "slos": [s.to_dict() for s in self.slos],
            "rules": [r.to_dict() for r in self.rules],
            "sentinels": [s.name for s in self._sentinels],
            "firing": [ev.to_dict() for ev in self._active.values()],
            "events_total": len(self.events),
        }


# --------------------------------------------------------------- sampler
class LocalSampler:
    """In-process history provider: snapshots a registry on demand. The
    AlertEngine's window store when there is no fleet to scrape (training
    loops, tests, the bench drift round)."""

    def __init__(self, registry=None, clock=time.time, maxlen=4096):
        from collections import deque

        self.registry = registry or _registry.default_registry()
        self._clock = clock
        self._history = deque(maxlen=maxlen)

    def sample(self, now=None):
        now = self._clock() if now is None else now
        snap = self.registry.snapshot()
        self._history.append((now, snap))
        return now, snap

    def history(self, window_s=None):
        items = list(self._history)
        if window_s is not None and items:
            cutoff = items[-1][0] - window_s
            items = [(t, s) for t, s in items if t >= cutoff]
        return items


# --------------------------------------------------------------- sentinels
class DriftSentinel:
    """EWMA drift detector over a histogram's per-tick mean — catches a
    step-time or token-latency regression (e.g. after a model hot swap)
    that never crosses any static threshold. A fast EWMA tracks the
    current level, a slow EWMA the baseline; firing when fast exceeds
    slow by `rel_threshold` (with hysteresis at half the threshold for
    resolve). Stationary streams never fire (tested)."""

    def __init__(self, name, histogram, alpha_fast=0.3, alpha_slow=0.03,
                 rel_threshold=0.5, warmup=8, min_count=3, severity="drift"):
        self.name = name
        self.histogram = histogram
        self.alpha_fast = float(alpha_fast)
        self.alpha_slow = float(alpha_slow)
        self.rel_threshold = float(rel_threshold)
        self.warmup = int(warmup)
        self.min_count = int(min_count)
        self.severity = severity
        self._last = None   # (sum, count) at previous tick
        self._fast = None
        self._slow = None
        self._ticks = 0
        self._firing = False

    def evaluate(self, hist, now):
        if not hist:
            return "hold", {}, None
        snap = hist[-1][1]
        rec = snap.get(self.histogram)
        if not rec or rec.get("kind") != "histogram":
            return "hold", {}, None
        cur = (rec["sum"], rec["count"])
        last, self._last = self._last, cur
        if last is None:
            return "hold", {}, None
        dsum = cur[0] - last[0]
        dcount = cur[1] - last[1]
        if dcount < self.min_count:
            return ("firing" if self._firing else "hold"), {}, None
        mean = dsum / dcount
        if self._fast is None:
            self._fast = self._slow = mean
        else:
            self._fast += self.alpha_fast * (mean - self._fast)
            self._slow += self.alpha_slow * (mean - self._slow)
        self._ticks += 1
        info = {
            "sentinel": "drift",
            "histogram": self.histogram,
            "fast_ms": round(self._fast, 4),
            "slow_ms": round(self._slow, 4),
            "ratio": round(self._fast / self._slow, 4) if self._slow else None,
        }
        if self._ticks < self.warmup or not self._slow or self._slow <= 0:
            return "hold", info, None
        ratio = self._fast / self._slow
        if ratio > 1.0 + self.rel_threshold:
            self._firing = True
        elif ratio < 1.0 + self.rel_threshold / 2.0:
            self._firing = False
        series = {"kind": "histogram_mean", "mean_ms": round(mean, 4)}
        return ("firing" if self._firing else "ok"), info, series


class RetraceSentinel:
    """Post-warmup retrace detector: once a compile-miss style counter has
    been quiet for `steady_ticks`, ANY further movement fires — a retrace
    after steady state means the compile cache is being invalidated in
    production (shape drift, eviction, a bad hot swap)."""

    def __init__(self, name="retrace", counter="compile_cache/misses",
                 steady_ticks=5, severity="drift"):
        self.name = name
        self.counter = counter
        self.steady_ticks = int(steady_ticks)
        self.severity = severity
        self._last = None
        self._quiet = 0
        self._armed = False
        self._firing = False

    def evaluate(self, hist, now):
        if not hist:
            return "hold", {}, None
        total = _counter_total(hist[-1][1], self.counter)
        last, self._last = self._last, total
        if last is None:
            return "hold", {}, None
        delta = total - last
        info = {"sentinel": "retrace", "counter": self.counter,
                "delta": delta, "total": total, "armed": self._armed}
        if delta <= 0:
            self._quiet += 1
            if self._quiet >= self.steady_ticks:
                self._armed = True
            if self._firing and self._quiet >= 2:
                self._firing = False
            return ("firing" if self._firing else
                    ("ok" if not self._firing and self._armed else "hold")), \
                info, None
        was_armed = self._armed
        self._quiet = 0
        if was_armed:
            self._firing = True
            return "firing", info, {"kind": "counter_delta", "delta": delta}
        return "hold", info, None  # still warming up: first compiles are fine


class GoodputSentinel:
    """Live goodput vs a roofline the caller gives (MFU-online): reads the
    delta of an item counter (gen tokens, stepstats items/images) between
    the last two snapshots, publishes `slo/goodput_per_s{unit=}` and
    `slo/goodput_vs_roofline{unit=}` gauges, and — when `min_frac` is set —
    fires once sustained goodput falls below that fraction of roofline."""

    def __init__(self, name, counter, roofline_per_s, unit="tokens",
                 scale=1.0, min_frac=None, warmup=2, severity="goodput",
                 registry=None):
        self.name = name
        self.counter = counter
        self.roofline_per_s = float(roofline_per_s)
        self.unit = unit
        self.scale = float(scale)
        self.min_frac = None if min_frac is None else float(min_frac)
        self.warmup = int(warmup)
        self.severity = severity
        self.registry = registry or _registry.default_registry()
        self._last = None  # (ts, total)
        self._ticks = 0
        self._firing = False
        self.last_per_s = None
        self.last_frac = None

    def evaluate(self, hist, now):
        if not hist:
            return "hold", {}, None
        ts, snap = hist[-1]
        total = _counter_total(snap, self.counter)
        last, self._last = self._last, (ts, total)
        if last is None or ts <= last[0]:
            return "hold", {}, None
        per_s = max(total - last[1], 0) * self.scale / (ts - last[0])
        frac = per_s / self.roofline_per_s if self.roofline_per_s else 0.0
        self.last_per_s = per_s
        self.last_frac = frac
        self.registry.gauge(
            "slo/goodput_per_s", "observed goodput (items/s) by unit"
        ).set(round(per_s, 3), unit=self.unit, name=self.name)
        self.registry.gauge(
            "slo/goodput_vs_roofline",
            "goodput as a fraction of the given roofline (MFU-online)",
        ).set(round(frac, 4), unit=self.unit, name=self.name)
        self._ticks += 1
        info = {"sentinel": "goodput", "counter": self.counter,
                "per_s": round(per_s, 3), "roofline_per_s": self.roofline_per_s,
                "frac": round(frac, 4), "unit": self.unit}
        if self.min_frac is None or self._ticks <= self.warmup:
            return "hold", info, None
        if frac < self.min_frac:
            self._firing = True
        elif frac >= self.min_frac:
            self._firing = False
        return ("firing" if self._firing else "ok"), info, None
