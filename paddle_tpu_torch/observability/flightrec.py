"""Anomaly flight recorder: dump-on-trigger black box for serving (the torch
counterpart of paddle_tpu/observability/flightrec.py, same bundle layout).

Aggregate metrics say a breaker opened; the flight recorder preserves what
the process looked like the INSTANT it happened. It rides the tracing
module's bounded span ring (observability/tracing.py — the lookback window
of recently ended spans, sampled or not) and, when a trigger fires, writes
one atomic bundle directory under FLAGS_flightrec_dir:

    bundle-<ms>-<reason>-p<pid>/
      event.json    the triggering event: reason, ts, pid/host, caller info
      spans.jsonl   the span ring at trigger time (the request-level story)
      metrics.json  full registry snapshot + health counters + the health
                    deltas since the previous trigger (what moved)
      env.json      flags, FLAGS_*/PADDLE_TPU_* environment, argv

Bundles are staged in a ``.tmp-`` directory and os.rename()d into place, so
a collector never sees a torn bundle; at most FLAGS_flightrec_max_bundles
are kept (oldest pruned) and triggers for one reason are rate-limited to
one per FLAGS_flightrec_min_interval_s.

Trigger sites (each passes reason-specific context):
- ``http_5xx``            a replica answered 5xx (serving/server.py)
- ``nan_guard``           the resilience NaN guard skipped a step (executor)
- ``watchdog_stall``      a supervised step blew its deadline (resilience/
                          elastic.py)
- ``slo_alert``           an SLO burn-rate alert or drift sentinel fired
                          (observability/slo.py)
The JAX package's other reasons (router_5xx, breaker_transition,
staleness_throttle) belong to its fleet and online modules, still to come.

The module-level ``trigger(reason, **info)`` is the only call sites use; it
is a near-free no-op when FLAGS_flightrec_dir is unset and must NEVER raise
into the path that tripped it.
"""

import json
import os
import shutil
import sys
import threading
import time

__all__ = ["FlightRecorder", "recorder", "trigger", "reset"]

BUNDLE_PREFIX = "bundle-"


class FlightRecorder:
    def __init__(self, out_dir, max_bundles=16, min_interval_s=2.0):
        from . import registry as _registry
        from .export import _process_index

        self.out_dir = out_dir
        self.max_bundles = max(int(max_bundles), 1)
        self.min_interval_s = float(min_interval_s)
        self._host = _process_index()
        self._pid = os.getpid()
        self._lock = threading.Lock()
        self._last = {}  # reason -> monotonic time of last bundle
        self._prev_health = None
        reg = _registry.default_registry()
        self._m_bundles = reg.counter(
            "flightrec/bundles", "flight-recorder bundles written, by reason"
        )
        self._m_suppressed = reg.counter(
            "flightrec/suppressed", "triggers dropped by the rate limit"
        )
        os.makedirs(out_dir, exist_ok=True)

    def trigger(self, reason, **info):
        """Write one bundle for `reason` (rate-limited per reason). Returns
        the bundle path, or None when suppressed/disabled. Never raises —
        the recorder must not take down the path that tripped it."""
        try:
            now = time.monotonic()
            with self._lock:
                last = self._last.get(reason)
                if last is not None and now - last < self.min_interval_s:
                    self._m_suppressed.inc(reason=reason)
                    return None
                self._last[reason] = now
            path = self._write_bundle(reason, info)
            self._m_bundles.inc(reason=reason)
            return path
        except Exception:
            return None

    # ---- bundle assembly --------------------------------------------------
    def _write_bundle(self, reason, info):
        from . import tracing as _tracing

        name = "%s%013d-%s-p%d" % (
            BUNDLE_PREFIX, int(time.time() * 1e3), reason, self._pid
        )
        tmp = os.path.join(self.out_dir, ".tmp-" + name)
        os.makedirs(tmp)
        event = {
            "reason": reason,
            "ts": time.time(),
            "pid": self._pid,
            "host": self._host,
            "info": _jsonable(info),
        }
        self._dump(tmp, "event.json", event)
        spans = _tracing.tracer().recent()
        with open(os.path.join(tmp, "spans.jsonl"), "w") as f:
            for rec in spans:
                f.write(json.dumps(rec) + "\n")
        self._dump(tmp, "metrics.json", self._metrics())
        self._dump(tmp, "env.json", {
            "flags": _flags_snapshot(),
            "env": {
                k: v for k, v in os.environ.items()
                if k.startswith(("FLAGS_", "PADDLE_TPU_"))
            },
            "argv": list(sys.argv),
        })
        final = os.path.join(self.out_dir, name)
        os.rename(tmp, final)  # atomic publish: no torn bundles
        self._prune()
        return final

    def _metrics(self):
        from . import registry as _registry

        out = {"metrics": {}, "health": {}, "health_delta": {}}
        try:
            out["metrics"] = _registry.default_registry().snapshot()
        except Exception:
            pass
        try:
            from ..resilience import health as _health

            cur = dict(_health.snapshot())
            out["health"] = cur
            prev = self._prev_health or {}
            out["health_delta"] = {
                k: v - prev.get(k, 0)
                for k, v in cur.items()
                if v - prev.get(k, 0)
            }
            self._prev_health = cur
        except Exception:
            pass
        return out

    @staticmethod
    def _dump(dirname, fname, obj):
        with open(os.path.join(dirname, fname), "w") as f:
            json.dump(obj, f, indent=1, default=repr)

    def _prune(self):
        bundles = sorted(
            d for d in os.listdir(self.out_dir)
            if d.startswith(BUNDLE_PREFIX)
        )
        for stale in bundles[:-self.max_bundles]:
            shutil.rmtree(os.path.join(self.out_dir, stale),
                          ignore_errors=True)

    def bundles(self):
        """Bundle paths, oldest first."""
        return [
            os.path.join(self.out_dir, d)
            for d in sorted(os.listdir(self.out_dir))
            if d.startswith(BUNDLE_PREFIX)
        ]


def _jsonable(obj):
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        return repr(obj)


def _flags_snapshot():
    try:
        from .. import flags as _flags

        return _flags.get_flags()
    except Exception:
        return {}


# ---- process singleton ----------------------------------------------------
_rec = None
_disabled = False  # cached "flags say off": trigger() stays near-free
_rec_lock = threading.Lock()


def recorder():
    """The process recorder built from FLAGS_flightrec_* on first use, or
    None when FLAGS_flightrec_dir is unset."""
    global _rec, _disabled
    if _rec is not None or _disabled:
        return _rec
    with _rec_lock:
        if _rec is None and not _disabled:
            from .. import flags as _flags

            f = _flags.get_flags([
                "flightrec_dir", "flightrec_max_bundles",
                "flightrec_min_interval_s",
            ])
            if f["flightrec_dir"]:
                _rec = FlightRecorder(
                    f["flightrec_dir"],
                    max_bundles=f["flightrec_max_bundles"],
                    min_interval_s=f["flightrec_min_interval_s"],
                )
            else:
                _disabled = True
    return _rec


def trigger(reason, **info):
    """Fire one trigger. No-op (returns None) when the recorder is off."""
    rec = _rec
    if rec is None:
        if _disabled:
            return None
        rec = recorder()
        if rec is None:
            return None
    return rec.trigger(reason, **info)


def reset():
    """Forget the process recorder so the next call re-reads flags."""
    global _rec, _disabled
    with _rec_lock:
        _rec, _disabled = None, False
