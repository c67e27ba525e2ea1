"""Per-replica health: active probes + passive outcomes + staleness gate (a
copy of paddle_tpu/fleet/health.py).

One `Replica` record per fleet member, owned by the router. Three signal
sources feed it, deliberately different in what they can prove:

- **active probes** (`probe()`, driven by the router's prober thread): GET
  ``/healthz`` — the ModelServer's readiness contract — yields liveness ("the
  process answers"), readiness ("every model warmed; serving won't trace"),
  the per-model ``model_version`` actually live in the engines, and queue
  depth. Consecutive probe failures past `down_after` mark the replica DOWN.
- **passive outcomes** (`record_success`/`record_failure`, from real request
  attempts): feed the replica's CircuitBreaker and a latency EWMA. Passive
  signals react in one request; probes take a poll interval — both are
  needed (a replica can pass probes while failing real work, and vice
  versa).
- **staleness acks** (`apply_ack`): the online HotReloader writes
  ``ack-<consumer>.json`` into the model repository when a version has
  LANDED in the engines. The router reads those acks and gates routing on
  them — a freshly restarted replica is UP and READY long before it has
  replayed the published delta chain, and routing to it would serve stale
  predictions. `version_for_gate` prefers the ack (proof of landing) and
  falls back to the probed engine version.

`routable(targets)` is the single question the router asks: alive, ready,
not draining, breaker permitting, and at-or-past every target version.
"""

import http.client
import json
import threading
import time

from .breaker import CircuitBreaker

__all__ = ["Replica", "STARTING", "READY", "UNREADY", "DOWN", "DRAINING",
           "parse_url"]

STARTING = "starting"   # registered, no successful probe yet
READY = "ready"         # probed: live and every model warmed
UNREADY = "unready"     # probed: live but not (yet) warmed
DOWN = "down"           # `down_after` consecutive probe failures
DRAINING = "draining"   # administratively unroutable; in-flight finishing


def parse_url(url):
    """'http://host:port' -> (host, port). Scheme optional; no paths."""
    rest = url.split("//", 1)[-1].rstrip("/")
    if "/" in rest:
        raise ValueError("replica url %r must not carry a path" % url)
    host, _, port = rest.partition(":")
    if not host or not port:
        raise ValueError("replica url %r needs host:port" % url)
    return host, int(port)


class Replica:
    """One fleet member's live health record (thread-safe)."""

    def __init__(self, name, url, breaker=None, down_after=3,
                 latency_alpha=0.2):
        self.name = name
        self.url = url.rstrip("/")
        self.host, self.port = parse_url(url)
        self.breaker = breaker or CircuitBreaker(name=name)
        self.down_after = int(down_after)
        self._latency_alpha = float(latency_alpha)
        self._lock = threading.Lock()
        self.state = STARTING
        self.draining = False
        self.ready = False
        self.model_versions = {}   # model -> engine-reported version (probe)
        self.acked_version = None  # newest HotReloader ack seen in the repo
        self.queue_depth = 0
        self.inflight = 0
        self.probe_failures = 0
        self.last_probe_t = None
        self.last_error = None
        self.latency_ewma_ms = None
        self.requests_ok = 0
        self.requests_failed = 0

    # ------------------------------------------------------------ probing
    def probe(self, timeout_s=2.0):
        """One active probe: GET /healthz, fold the readiness doc in.
        Returns True when the replica answered (regardless of readiness)."""
        try:
            conn = http.client.HTTPConnection(
                self.host, self.port, timeout=timeout_s
            )
            try:
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                body = resp.read()
                if resp.status != 200:
                    raise IOError("healthz status %d" % resp.status)
                doc = json.loads(body.decode())
            finally:
                conn.close()
        except Exception as e:
            with self._lock:
                self.probe_failures += 1
                self.last_error = repr(e)
                self.last_probe_t = time.monotonic()
                if self.probe_failures >= self.down_after:
                    self.state = DOWN
                    self.ready = False
            return False
        with self._lock:
            self.probe_failures = 0
            self.last_error = None
            self.last_probe_t = time.monotonic()
            self.ready = bool(doc.get("ready", True))
            self.model_versions = {
                m: int(info.get("model_version", 0))
                for m, info in (doc.get("models") or {}).items()
                if isinstance(info, dict)
            }
            self.queue_depth = sum(
                int(info.get("queue_depth", 0))
                for info in (doc.get("models") or {}).values()
                if isinstance(info, dict)
            )
            if not self.draining:
                self.state = READY if self.ready else UNREADY
        return True

    def apply_ack(self, version):
        """Fold in the newest HotReloader ack the router read from the model
        repository for this replica's consumer name."""
        with self._lock:
            self.acked_version = int(version)

    # ---------------------------------------------------- passive outcomes
    def begin_request(self):
        with self._lock:
            self.inflight += 1

    def end_request(self):
        with self._lock:
            self.inflight = max(self.inflight - 1, 0)

    def record_success(self, latency_ms=None):
        self.breaker.record_success()
        with self._lock:
            self.requests_ok += 1
            if latency_ms is not None:
                self.latency_ewma_ms = (
                    latency_ms if self.latency_ewma_ms is None
                    else (1.0 - self._latency_alpha) * self.latency_ewma_ms
                    + self._latency_alpha * latency_ms
                )

    def record_failure(self, err=None):
        self.breaker.record_failure()
        with self._lock:
            self.requests_failed += 1
            if err is not None:
                self.last_error = repr(err)

    # -------------------------------------------------------------- gating
    def version_for_gate(self, model):
        """The version this replica can PROVE it serves for `model`: the
        repo ack when one exists (landing proof), else the probed engine
        version."""
        with self._lock:
            if self.acked_version is not None:
                return self.acked_version
            return self.model_versions.get(model, 0)

    def routable(self, target_versions=None):
        """May the router send NEW requests here? Alive + ready + not
        draining + breaker closed/probing + current on every gated model.
        Does NOT claim a half-open probe slot (allow() does, at pick time)."""
        with self._lock:
            if self.draining or self.state != READY:
                return False
        if self.breaker.state == "open":
            return False
        for model, target in (target_versions or {}).items():
            if target is not None and self.version_for_gate(model) < target:
                return False
        return True

    def stats(self):
        with self._lock:
            return {
                "name": self.name,
                "url": self.url,
                "state": DRAINING if self.draining else self.state,
                "ready": self.ready,
                "breaker": self.breaker.stats(),
                "model_versions": dict(self.model_versions),
                "acked_version": self.acked_version,
                "queue_depth": self.queue_depth,
                "inflight": self.inflight,
                "latency_ewma_ms": (
                    round(self.latency_ewma_ms, 3)
                    if self.latency_ewma_ms is not None else None
                ),
                "requests_ok": self.requests_ok,
                "requests_failed": self.requests_failed,
                "last_error": self.last_error,
            }
