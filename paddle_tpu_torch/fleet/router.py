"""Health-aware fleet router: retries, hedging, circuit breakers, drain (the
port of paddle_tpu/fleet/router.py over the port's observability, retry and
staleness modules).

One `Router` process fronts N replica ModelServers and owns the fleet's
failure policy, so clients see ONE url and (within the deadline they chose)
zero 5xx while replicas die, restart, brown out and hot-swap underneath:

- **placement**: least-inflight among routable replicas (random tie-break).
  Routable = probed READY + not draining + breaker not open + at-or-past
  every gated model version (see health.Replica.routable).
- **retries**: a failed attempt (connect error, reset, 5xx, attempt
  timeout) fails over to a DIFFERENT replica — same one only when there is
  no alternative — under `resilience.RetryPolicy` with decorrelated jitter,
  never past the request's total deadline (`with_deadline` on the remaining
  budget). A fleet-wide token-bucket retry budget (`retry_budget_ratio`
  tokens earned per request, spent 1 per retry) keeps a brown-out from
  amplifying load: when the fleet is failing broadly, retries stop first.
- **hedging** (`:predict` only — idempotent; `:generate` is not hedged): if
  the primary hasn't answered within the hedge delay (p95 of recent fleet
  latency once warmed up, `hedge_delay_ms` until then), the SAME request is
  sent to a second replica; first reply wins, the loser's connection is
  closed and its outcome is NOT counted against its breaker (cancellation
  is not failure).
- **membership**: register/deregister/drain, programmatic or via POST
  ``/fleet/register|deregister|drain``. Drain stops new sends immediately
  and waits for the replica's in-flight requests; a SIGKILLed replica's
  in-flight requests fail over via the retry path.
- **staleness gate**: pass `repo=` (an online model repository) and
  `repo_model=` to refuse routing to replicas that haven't landed+acked the
  published version — a restarted replica rejoins only after its
  HotReloader catches up, so a fleet mid-hot-swap never serves two model
  generations to one client.

Routes: ``POST /v1/models/<name>:predict|:generate`` (proxied),
``GET /healthz`` (router liveness + routable count), ``GET /fleet`` (full
per-replica stats), ``GET /v1/models`` (proxied to one routable replica),
``GET /metrics``, ``POST /fleet/register|deregister|drain``.
"""

import http.client
import json
import queue
import threading
import time
from random import Random

from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..observability import flightrec as _flightrec
from ..observability import tracing as _tracing
from ..observability.tracing import NULL_SPAN, TRACE_HEADER
from ..resilience.retry import DeadlineExceeded, FatalError, RetryPolicy
from .health import Replica

__all__ = ["Router", "RetryBudget", "NoReplicaAvailable", "UpstreamError"]

PREDICT_PREFIX = "/v1/models/"


class NoReplicaAvailable(ConnectionError):
    """No routable replica right now — retryable: one may close its breaker,
    finish warmup or land the target version within the deadline."""


class UpstreamError(ConnectionError):
    """A replica answered 5xx. Retryable on another replica; carries the
    upstream reply so an exhausted retry loop can surface the real error."""

    def __init__(self, status, body, content_type, retry_after=None):
        super().__init__("upstream status %d" % status)
        self.status = status
        self.body = body
        self.content_type = content_type
        self.retry_after = retry_after


class RetryBudget:
    """Fleet-wide token bucket bounding retry amplification: every routed
    request earns `ratio` tokens (capped), every retry spends one. Under a
    broad brown-out the bucket empties and retries stop — the fleet sheds
    the *extra* load retries would add, instead of melting down twice."""

    def __init__(self, ratio=0.2, max_tokens=50.0):
        self.ratio = float(ratio)
        self.max_tokens = float(max_tokens)
        self._tokens = self.max_tokens  # start full: a cold fleet may retry
        self._lock = threading.Lock()

    def on_request(self):
        with self._lock:
            self._tokens = min(self._tokens + self.ratio, self.max_tokens)

    def take(self):
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    @property
    def tokens(self):
        with self._lock:
            return self._tokens


class Router:
    """Fleet front end (see module docstring)."""

    def __init__(self, host="127.0.0.1", port=0, attempt_timeout_s=5.0,
                 total_deadline_s=15.0, max_attempts=4,
                 retry_budget_ratio=0.2, retry_budget_max=50.0,
                 hedge=True, hedge_delay_ms=75.0, hedge_after_observations=20,
                 probe_interval_s=0.5, down_after=3,
                 repo=None, repo_model=None, breaker_opts=None, seed=0,
                 fleet_metrics=False, scrape_interval_s=2.0,
                 slos=None, sentinels=None, alert_rules=None,
                 alerts_path=None):
        self.host = host
        self._port = port
        self.attempt_timeout_s = float(attempt_timeout_s)
        self.total_deadline_s = float(total_deadline_s)
        self.hedge_enabled = bool(hedge)
        self.hedge_delay_ms = float(hedge_delay_ms)
        self.hedge_after_observations = int(hedge_after_observations)
        self.probe_interval_s = float(probe_interval_s)
        self.down_after = int(down_after)
        self.repo = repo
        self.repo_model = repo_model
        self.breaker_opts = dict(breaker_opts or {})
        self._rng = Random(seed)
        self._lock = threading.Lock()
        self._replicas = {}
        self._targets = {}  # model -> minimum version (manual overrides)
        self._budget = RetryBudget(retry_budget_ratio, retry_budget_max)
        # template only — every request derives a fresh copy (fresh jitter
        # state) via with_deadline, so concurrent requests don't share RNG
        self._retry_template = RetryPolicy(
            max_attempts=int(max_attempts), base_delay=0.02, max_delay=0.5,
            jitter="decorrelated", seed=seed,
            retryable=(NoReplicaAvailable, UpstreamError, ConnectionError,
                       TimeoutError, OSError, EOFError),
        )
        self._httpd = None
        self._http_thread = None
        self._probe_stop = threading.Event()
        self._probe_thread = None
        # fleet-wide observability — entirely off unless asked for:
        # no scrape loop, no SLO evaluation, no extra request-path work
        self.fleet_metrics = bool(fleet_metrics)
        self.scrape_interval_s = float(scrape_interval_s)
        self._slos = list(slos or [])
        self._sentinels = list(sentinels or [])
        self._alert_rules = alert_rules
        self._alerts_path = alerts_path
        self._aggregator = None
        self._alert_engine = None

        from ..observability import registry as _registry

        self._registry = _registry.default_registry()
        self._m_requests = self._registry.counter(
            "fleet/requests", "routed requests by kind + final code"
        )
        self._m_retries = self._registry.counter(
            "fleet/retries", "failover retry attempts by kind"
        )
        self._m_hedges = self._registry.counter(
            "fleet/hedges", "hedge requests launched / won by the hedge"
        )
        self._m_breaker = self._registry.counter(
            "fleet/breaker_transitions", "circuit breaker flips by to-state"
        )
        self._m_budget_denied = self._registry.counter(
            "fleet/retry_budget_denied", "retries refused by the fleet budget"
        )
        self._g_routable = self._registry.gauge(
            "fleet/replicas_routable", "replicas eligible for new requests"
        )
        self._g_total = self._registry.gauge(
            "fleet/replicas_total", "registered replicas"
        )
        self._h_latency = self._registry.histogram(
            "fleet/request_ms", "end-to-end routed request latency"
        )

    # ---- membership -------------------------------------------------------
    def register(self, name, url):
        """Add (or re-add) a replica. It becomes routable only after a
        probe reports ready — registering is cheap and safe mid-traffic."""
        from .breaker import CircuitBreaker

        rep = Replica(
            name, url,
            breaker=CircuitBreaker(
                name=name,
                on_transition=self._on_breaker,
                **self.breaker_opts,
            ),
            down_after=self.down_after,
        )
        with self._lock:
            self._replicas[name] = rep
        rep.probe()  # first look now, not a poll interval later
        self._refresh_acks()
        return rep

    def _on_breaker(self, name, old, new):
        self._m_breaker.inc(replica=name, to=new)
        # a breaker flip is exactly the moment worth a black-box dump: the
        # recent span ring holds the failed attempts that tripped it
        _flightrec.trigger(
            "breaker_transition", replica=name, from_state=old, to_state=new
        )

    def deregister(self, name):
        with self._lock:
            return self._replicas.pop(name, None) is not None

    def drain(self, name, wait_s=10.0):
        """Stop NEW requests to `name` immediately; wait for its in-flight
        requests to finish. Returns True when it drained within `wait_s`."""
        with self._lock:
            rep = self._replicas.get(name)
        if rep is None:
            return False
        rep.draining = True
        deadline = time.monotonic() + float(wait_s)
        while time.monotonic() < deadline:
            if rep.inflight == 0:
                return True
            time.sleep(0.01)
        return rep.inflight == 0

    def replicas(self):
        with self._lock:
            return dict(self._replicas)

    def set_target_version(self, model, version):
        """Manually gate `model` on `version` (repo-less deployments); pass
        None to drop the gate."""
        with self._lock:
            if version is None:
                self._targets.pop(model, None)
            else:
                self._targets[model] = int(version)

    def target_versions(self):
        """{model: minimum version} — manual gates plus the repo's
        LATEST.json pointer for `repo_model`."""
        with self._lock:
            targets = dict(self._targets)
        if self.repo and self.repo_model:
            from ..online.publisher import read_latest

            pointer = read_latest(self.repo)
            if pointer:
                v = int(pointer.get("version", 0))
                if v > targets.get(self.repo_model, -1):
                    targets[self.repo_model] = v
        return targets

    # ---- probing ----------------------------------------------------------
    def _refresh_acks(self):
        if not self.repo:
            return
        from ..online.staleness import read_acks

        acks = read_acks(self.repo)
        with self._lock:
            reps = list(self._replicas.values())
        for rep in reps:
            ack = acks.get(rep.name)
            if ack is not None:
                rep.apply_ack(ack.get("version", 0))

    def probe_once(self):
        """One active probe round over every replica + one ack refresh.
        Called by the prober thread; tests call it directly for lockstep."""
        with self._lock:
            reps = list(self._replicas.values())
        for rep in reps:
            rep.probe()
        self._refresh_acks()
        targets = self.target_versions()
        self._g_total.set(len(reps))
        self._g_routable.set(
            sum(1 for r in reps if r.routable(targets))
        )

    def _probe_loop(self):
        while not self._probe_stop.wait(self.probe_interval_s):
            try:
                self.probe_once()
            except Exception:
                pass  # the prober must outlive any one bad poll

    # ---- placement --------------------------------------------------------
    def _pick(self, exclude=()):
        """Least-inflight routable replica, random tie-break, preferring
        replicas not in `exclude` (the already-tried set); claims the
        breaker's half-open probe slot when applicable."""
        targets = self.target_versions()
        with self._lock:
            reps = list(self._replicas.values())
        cands = [r for r in reps if r.routable(targets)]
        fresh = [r for r in cands if r.name not in exclude]
        pool = fresh or cands  # same replica only when no alternative
        pool.sort(key=lambda r: (r.inflight, self._rng.random()))
        for rep in pool:
            if rep.breaker.allow():
                return rep
        return None

    # ---- one attempt ------------------------------------------------------
    def _send(self, rep, path, body, content_type, timeout_s, holder=None,
              trace_header=None):
        """One upstream HTTP exchange. `holder.conn` exposes the live
        connection so a hedging loser can be cancelled by closing it."""
        conn = http.client.HTTPConnection(rep.host, rep.port,
                                          timeout=timeout_s)
        if holder is not None:
            holder.conn = conn
        headers = {"Content-Type": content_type}
        if trace_header:
            headers[TRACE_HEADER] = trace_header
        try:
            conn.request("POST", path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            return (resp.status, data,
                    resp.getheader("Content-Type", "application/json"),
                    resp.getheader("Retry-After"))
        finally:
            conn.close()

    def _attempt_one(self, rep, path, body, content_type, timeout_s,
                     holder=None, cancelled=None, span=NULL_SPAN):
        """Send to one replica, folding the outcome into its breaker and
        latency EWMA. Returns (status, body, ctype) for any < 500 status;
        raises (retryably) otherwise. A cancelled hedge records nothing.
        The attempt span ends BEFORE the breaker sees the failure, so a
        breaker-transition flight-recorder bundle contains it."""
        span.tag(replica=rep.name, breaker=rep.breaker.state,
                 inflight=rep.inflight)
        rep.begin_request()
        t0 = time.perf_counter()
        try:
            status, data, ctype, retry_after = self._send(
                rep, path, body, content_type, timeout_s, holder,
                trace_header=span.header(),
            )
        except Exception as e:
            if cancelled is not None and cancelled.is_set():
                span.tag(cancelled=True).end()
                raise
            span.error(e).end()
            rep.record_failure(e)
            raise
        finally:
            rep.end_request()
        if status >= 500:
            err = UpstreamError(status, data, ctype, retry_after)
            span.tag(code=status).error(err).end()
            rep.record_failure(err)
            raise err
        span.tag(code=status).end()
        rep.record_success((time.perf_counter() - t0) * 1e3)
        return status, data, ctype

    # ---- hedging ----------------------------------------------------------
    def _hedge_delay_s(self):
        """p95 of recent fleet latency once the histogram has seen enough
        traffic; the configured default until then."""
        if self._h_latency.count >= self.hedge_after_observations:
            p95 = self._h_latency.percentile(95)
            if p95 and p95 > 0:
                return p95 / 1e3
        return self.hedge_delay_ms / 1e3

    def _attempt_hedged(self, path, body, content_type, tried, timeout_s,
                        parent_span=NULL_SPAN):
        """One (possibly hedged) attempt: primary now, a second replica if
        the primary is still silent after the hedge delay; first reply wins,
        the loser's connection is closed without a breaker penalty."""
        primary = self._pick(tried)
        if primary is None:
            raise NoReplicaAvailable("no routable replica")
        tried.add(primary.name)
        results = queue.Queue()
        cancelled = threading.Event()
        holders = []

        def run(rep, hedge_leg=False):
            holder = type("H", (), {"conn": None})()
            holders.append(holder)
            span = parent_span.child(
                "router.attempt", hedge=hedge_leg
            )
            try:
                results.put((rep, self._attempt_one(
                    rep, path, body, content_type, timeout_s,
                    holder=holder, cancelled=cancelled, span=span,
                ), None))
            except Exception as e:
                results.put((rep, None, e))

        threading.Thread(target=run, args=(primary,), daemon=True).start()
        outstanding = 1
        deadline = time.monotonic() + timeout_s
        first = None
        try:
            first = results.get(timeout=min(self._hedge_delay_s(), timeout_s))
        except queue.Empty:
            hedge = self._pick(tried)
            if hedge is not None:
                tried.add(hedge.name)
                self._m_hedges.inc(event="launched")
                # hedges are rare and diagnostic gold: exempt the whole
                # trace from OK-trace sampling
                parent_span.force_keep().event(
                    "hedge_launched", replica=hedge.name
                )
                threading.Thread(target=run, args=(hedge, True),
                                 daemon=True).start()
                outstanding += 1

        last_err = None
        got = [first] if first is not None else []
        while True:
            for rep, ok, err in got:
                outstanding -= 1
                if err is None:
                    cancelled.set()
                    for h in holders:  # cancel the loser mid-flight
                        conn = getattr(h, "conn", None)
                        if conn is not None:
                            try:
                                conn.close()
                            except Exception:
                                pass
                    if rep is not primary:
                        self._m_hedges.inc(event="won")
                        parent_span.event("hedge_won", replica=rep.name)
                    return ok
                last_err = err
            got = []
            if outstanding <= 0:
                break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                cancelled.set()
                raise TimeoutError(
                    "attempt timeout %.2fs with %d upstream(s) silent"
                    % (timeout_s, outstanding)
                )
            try:
                got = [results.get(timeout=remaining)]
            except queue.Empty:
                got = []
        raise last_err if last_err is not None else NoReplicaAvailable(
            "hedged attempt produced no result"
        )

    # ---- routing ----------------------------------------------------------
    def route(self, path, body, content_type="application/json",
              deadline_s=None, parent=None):
        """Route one POST. Returns (status, body bytes, content type) — the
        winning replica's reply, or a router-synthesized 503/504 after the
        deadline/budget/replicas are exhausted. `parent` (a Span or an
        X-Fleet-Trace header value) roots this request's trace; the root
        span records every attempt/hedge/backoff as child spans."""
        kind = "generate" if path.endswith(":generate") else "predict"
        span = _tracing.tracer().start_span(
            "router.request", parent=parent, kind=kind, path=path
        )
        t0 = time.monotonic()
        total = float(deadline_s or self.total_deadline_s)
        hard_deadline = t0 + total
        self._budget.on_request()
        tried = set()
        attempts = [0]

        def attempt():
            if attempts[0] > 0:
                if not self._budget.take():
                    self._m_budget_denied.inc()
                    span.event(
                        "retry_denied",
                        budget_tokens=round(self._budget.tokens, 2),
                    )
                    raise FatalError("fleet retry budget exhausted")
                self._m_retries.inc(kind=kind)
                # retry-budget spend, per Dapper log entry: how much of the
                # fleet's amplification headroom this request consumed
                span.event(
                    "retry", attempt=attempts[0],
                    budget_tokens=round(self._budget.tokens, 2),
                )
            attempts[0] += 1
            remaining = hard_deadline - time.monotonic()
            if remaining <= 0:
                raise FatalError("deadline exhausted before attempt")
            timeout_s = min(self.attempt_timeout_s, max(remaining, 0.05))
            if kind == "predict" and self.hedge_enabled:
                return self._attempt_hedged(
                    path, body, content_type, tried, timeout_s,
                    parent_span=span,
                )
            rep = self._pick(tried)
            if rep is None:
                raise NoReplicaAvailable("no routable replica")
            tried.add(rep.name)
            return self._attempt_one(
                rep, path, body, content_type, timeout_s,
                span=span.child("router.attempt", attempt=attempts[0]),
            )

        policy = self._retry_template.with_deadline(total)
        try:
            status, data, ctype = policy.call(attempt)
        except UpstreamError as e:
            # retries exhausted on a real upstream reply: pass it through
            status, data, ctype = e.status, e.body, e.content_type
        except FatalError as e:
            status, data, ctype = 503, json.dumps(
                {"error": str(e), "attempts": attempts[0]}
            ).encode(), "application/json"
        except DeadlineExceeded as e:
            status, data, ctype = 504, json.dumps(
                {"error": str(e), "attempts": e.attempts}
            ).encode(), "application/json"
        except NoReplicaAvailable as e:
            status, data, ctype = 503, json.dumps(
                {"error": str(e), "attempts": attempts[0]}
            ).encode(), "application/json"
        except (ConnectionError, TimeoutError, OSError, EOFError) as e:
            status, data, ctype = 503, json.dumps(
                {"error": repr(e), "attempts": attempts[0]}
            ).encode(), "application/json"
        self._m_requests.inc(kind=kind, code=str(status))
        self._h_latency.observe((time.monotonic() - t0) * 1e3)
        span.tag(code=status, attempts=attempts[0])
        span.end("ok" if status < 500 else "error")
        if status >= 500:
            # the router gave up on a client request — dump the black box
            # (span ring now includes this request's failed attempts)
            _flightrec.trigger(
                "router_5xx", code=status, path=path,
                attempts=attempts[0], trace=span.trace_id,
            )
        return status, data, ctype

    # ---- stats ------------------------------------------------------------
    def stats(self):
        targets = self.target_versions()
        with self._lock:
            reps = list(self._replicas.values())
        return {
            "replicas": {r.name: r.stats() for r in reps},
            "routable": sorted(
                r.name for r in reps if r.routable(targets)
            ),
            "target_versions": targets,
            "retry_budget_tokens": round(self._budget.tokens, 2),
            "hedge_delay_ms": round(self._hedge_delay_s() * 1e3, 3),
        }

    def _proxy_get(self, path):
        """GET proxied to one routable replica (metadata routes)."""
        rep = self._pick()
        if rep is None:
            return 503, json.dumps({"error": "no routable replica"}).encode()
        conn = http.client.HTTPConnection(rep.host, rep.port,
                                          timeout=self.attempt_timeout_s)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            return resp.status, resp.read()
        except Exception as e:
            return 503, json.dumps({"error": repr(e)}).encode()
        finally:
            conn.close()

    # ---- lifecycle --------------------------------------------------------
    def start(self):
        """Bind the front end + start the prober; returns the bound port."""
        router = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _reply(self, code, body, content_type="application/json",
                       trace=None):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                if trace:
                    # the trace id rides back to the client: "my request
                    # was slow" becomes a greppable span tree
                    self.send_header(TRACE_HEADER, trace)
                self.end_headers()
                self.wfile.write(body)

            def _reply_json(self, code, obj):
                self._reply(code, json.dumps(obj).encode())

            def do_GET(self):
                try:
                    if self.path.startswith("/healthz"):
                        st = router.stats()
                        self._reply_json(200, {
                            "status": "ok",
                            "replicas": len(st["replicas"]),
                            "routable": len(st["routable"]),
                        })
                    elif self.path == "/fleet":
                        self._reply_json(200, router.stats())
                    elif self.path == "/fleet/metrics":
                        agg = router._aggregator
                        if agg is None:
                            self._reply_json(503, {
                                "error": "fleet metrics disabled "
                                         "(Router(fleet_metrics=True))",
                            })
                        else:
                            self._reply(
                                200, agg.metrics_text().encode(),
                                content_type="text/plain; version=0.0.4",
                            )
                    elif self.path == "/fleet/stats":
                        agg = router._aggregator
                        if agg is None:
                            self._reply_json(503, {
                                "error": "fleet metrics disabled "
                                         "(Router(fleet_metrics=True))",
                            })
                        else:
                            st = agg.stats()
                            if router._alert_engine is not None:
                                st["slo"] = router._alert_engine.stats()
                            self._reply_json(200, st)
                    elif self.path == "/metrics":
                        self._reply(
                            200, router._registry.to_prometheus().encode(),
                            content_type="text/plain; version=0.0.4",
                        )
                    elif self.path == "/v1/models" or (
                        self.path.startswith(PREDICT_PREFIX)
                        and ":" not in self.path
                    ):
                        code, body = router._proxy_get(self.path)
                        self._reply(code, body)
                    else:
                        self._reply_json(
                            404, {"error": "no route %s" % self.path}
                        )
                except Exception as e:
                    self._reply_json(500, {"error": repr(e)})

            def do_POST(self):
                try:
                    body = self.rfile.read(
                        int(self.headers.get("Content-Length", 0))
                    )
                    if self.path.startswith("/fleet/"):
                        self._reply_json(*router._admin(self.path, body))
                        return
                    if not (self.path.startswith(PREDICT_PREFIX)
                            and (self.path.endswith(":predict")
                                 or self.path.endswith(":generate"))):
                        self._reply_json(
                            404, {"error": "no route %s" % self.path}
                        )
                        return
                    deadline = self.headers.get("X-Fleet-Deadline-S")
                    # adopt the client's trace context when it sent one;
                    # route() opens the root span either way
                    span = _tracing.tracer().start_span(
                        "router.http", parent=self.headers.get(TRACE_HEADER),
                        path=self.path,
                    )
                    try:
                        status, data, ctype = router.route(
                            self.path, body,
                            self.headers.get("Content-Type",
                                             "application/json"),
                            deadline_s=float(deadline) if deadline else None,
                            parent=span,
                        )
                    except Exception:
                        span.end("error")
                        raise
                    span.tag(code=status).end(
                        "ok" if status < 500 else "error"
                    )
                    self._reply(status, data, content_type=ctype,
                                trace=span.header())
                except Exception as e:
                    self._reply_json(500, {"error": repr(e)})

        self._httpd = ThreadingHTTPServer((self.host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="fleet-router", daemon=True
        )
        self._http_thread.start()
        self._probe_stop.clear()
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name="fleet-prober", daemon=True
        )
        self._probe_thread.start()
        self._start_fleet_observability()
        return self._httpd.server_address[1]

    def _scrape_targets(self):
        with self._lock:
            return {name: rep.url for name, rep in self._replicas.items()}

    def _start_fleet_observability(self):
        """Fleet aggregator + SLO engine, only when asked for. The scrape
        loop pulls every replica's /metrics plus this router's own
        registry; the alert engine evaluates after each scrape."""
        if not (self.fleet_metrics or self._slos or self._sentinels):
            return
        from ..observability.aggregate import FleetAggregator

        self._aggregator = FleetAggregator(
            targets=self._scrape_targets,
            local_registry=self._registry,
            local_name="router",
            interval_s=self.scrape_interval_s,
            timeout_s=min(self.attempt_timeout_s, 2.0),
        )
        if self._slos or self._sentinels:
            from ..observability.slo import DEFAULT_RULES, AlertEngine

            self._alert_engine = AlertEngine(
                slos=self._slos,
                history=self._aggregator,
                rules=self._alert_rules or DEFAULT_RULES,
                registry=self._registry,
                out_path=self._alerts_path,
            )
            for s in self._sentinels:
                self._alert_engine.add_sentinel(s)
            self._aggregator.add_listener(self._alert_engine.on_snapshot)
        self._aggregator.start()

    @property
    def aggregator(self):
        return self._aggregator

    @property
    def alert_engine(self):
        return self._alert_engine

    def _admin(self, path, body):
        """POST /fleet/register|deregister|drain handlers."""
        try:
            doc = json.loads(body.decode() or "{}")
        except ValueError as e:
            return 400, {"error": "bad payload: %r" % e}
        name = doc.get("name")
        if not name:
            return 400, {"error": 'body needs {"name": ...}'}
        if path == "/fleet/register":
            url = doc.get("url")
            if not url:
                return 400, {"error": 'register needs {"name", "url"}'}
            self.register(name, url)
            return 200, {"registered": name}
        if path == "/fleet/deregister":
            return 200, {"deregistered": self.deregister(name)}
        if path == "/fleet/drain":
            ok = self.drain(name, wait_s=float(doc.get("wait_s", 10.0)))
            return 200, {"drained": ok}
        return 404, {"error": "no route %s" % path}

    @property
    def port(self):
        return self._httpd.server_address[1] if self._httpd else self._port

    @property
    def url(self):
        return "http://%s:%d" % (self.host, self.port)

    def stop(self):
        agg, self._aggregator = self._aggregator, None
        if agg is not None:
            agg.stop()
        self._alert_engine = None
        self._probe_stop.set()
        t, self._probe_thread = self._probe_thread, None
        if t is not None:
            t.join(5.0)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._http_thread.join(10.0)
            self._httpd = None
