"""Multi-model HTTP serving front end (stdlib http.server, no deps; the
torch counterpart of paddle_tpu/serving/server.py, the same routes, reply
shapes and failure mapping).

One process hosts many models, each an (engine, batcher) pair; request
threads (ThreadingHTTPServer, one per connection) block on the batcher's
future while the dispatcher packs buckets — the Clipper frontend shape on
the reference's server-demo role (paddle/fluid/inference demos served one
Run() per request; here requests from all connections share device
batches). On the card every hosted engine replays CUDA graphs of its own
pool, from its own dispatcher (or scheduler) thread.

Routes:
- ``POST /v1/models/<name>:predict`` — body either JSON
  ``{"inputs": {feed: nested list, ...}}`` or a raw ``.npz`` payload
  (Content-Type ``application/x-npz``; one array per feed name). JSON
  replies as ``{"outputs": {fetch: nested list}, "latency_ms": float}``;
  npz requests reply as npz bytes.
- ``POST /v1/models/<name>:generate`` — autoregressive models only
  (add_generation_model). JSON body ``{"prompt": [ids...],
  "max_new_tokens": n, "temperature": t, "top_k": k, "seed": s,
  "eos_id": id}`` (prompt required, rest optional; no temperature means
  greedy). Replies ``{"tokens": [...], "finish_reason": "eos"|"length",
  "latency_ms": float}``.
- ``GET /healthz`` — liveness AND per-model readiness: 200 with
  ``{"status", "ready", "model_version", "models": {name: {"kind", "ready",
  "model_version", "queue_depth", "queued_rows", "variants"}}}``. A model is
  *ready* once its warmup prepared (and on the card captured) every bucket —
  "up" (the process answers) and "routable" (this model serves without
  preparing or capturing) are different facts, and a router or load
  balancer routes on the second.
  ``/healthz?verbose=0`` keeps the original liveness-only shape.
- ``GET /v1/models`` — model metadata (feeds, fetches, buckets, stats).
- ``GET /v1/models/<name>`` — one model's metadata plus its live hot-swap
  state: ``model_version`` and the publisher's ``version_stamp`` (train
  step + wall time). Predict/generate replies carry ``model_version`` too —
  which hot-swapped version served THAT request.
- ``GET /metrics`` — the observability registry's Prometheus text
  exposition (registry.to_prometheus).

Failure mapping: unknown model -> 404, malformed body -> 400, queue full /
deadline-shed admission -> 503, request timeout -> 504. 503/504 carry a
``Retry-After`` header derived from the batcher's measured queue drain rate
(rows queued / rows-per-second EWMA) instead of a constant.

Fault hooks (PADDLE_TPU_FAULTS or resilience.faults.install): every POST
consults ``replica_kill`` (SIGKILL self — a replica dying mid-request),
``conn_reset`` (close the socket without replying) and ``slow_response``
(sleep spec.ms first), under deterministic, seeded fault plans. Every 5xx
reply is a flight-recorder trigger (observability/flightrec.py, with
FLAGS_flightrec_dir set).
"""

import io as _stdio
import json
import threading
import time

import numpy as np

from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..observability import flightrec as _flightrec
from ..observability import tracing as _tracing
from ..observability.tracing import NULL_SPAN, TRACE_HEADER
from ..resilience import faults as _faults
from .batcher import ContinuousBatcher, QueueFullError, RequestTimeout
from .engine import ServingEngine

__all__ = ["ModelServer"]

PREDICT_PREFIX = "/v1/models/"


class _Hosted:
    __slots__ = ("engine", "batcher", "kind", "warmed")

    def __init__(self, engine, batcher, kind="predict", warmed=False):
        self.engine = engine
        self.batcher = batcher
        self.kind = kind
        # readiness, not liveness: True once warmup prepared (and on the
        # card captured) every bucket, i.e. this model serves without either
        self.warmed = warmed


class ModelServer:
    """Host N models behind one threaded HTTP listener."""

    def __init__(self, host="127.0.0.1", port=0, request_timeout_ms=5000.0):
        self.host = host
        self._port = port
        self.request_timeout = float(request_timeout_ms) / 1e3
        self._models = {}
        self._httpd = None
        self._thread = None
        from ..observability import registry as _registry

        self._registry = _registry.default_registry()
        self._m_http = self._registry.counter(
            "serving/http/requests", "HTTP requests by code label"
        )

    # ---- model hosting ----------------------------------------------------
    def add_model(self, name, model_dir=None, engine=None, warmup=True,
                  warmup_feed=None, batcher_opts=None, **engine_opts):
        """Register a model. Either pass a prebuilt `engine` or a
        `model_dir` (plus ServingEngine kwargs). Warmup prepares (and on the
        card captures) every bucket before the model is visible, so the
        serving hot path never does."""
        if engine is None:
            if model_dir is None:
                raise ValueError("add_model needs model_dir or engine")
            engine = ServingEngine(model_dir, name=name, **engine_opts)
        if warmup:
            engine.warmup(example_feed=warmup_feed)
        batcher = ContinuousBatcher(engine, **(batcher_opts or {}))
        self._models[name] = _Hosted(engine, batcher, warmed=bool(warmup))
        return engine

    def add_generation_model(self, name, model=None, engine=None, warmup=True,
                             scheduler_opts=None, **engine_opts):
        """Register an autoregressive model behind the `:generate` route.
        Either pass a prebuilt GenerationEngine or a decoder `model`
        (GPTDecoder protocol, plus GenerationEngine kwargs). Warmup
        prepares (and on the card captures) the decode step and every
        prefill bucket."""
        from .generation import GenerationEngine, GenerationScheduler

        if engine is None:
            if model is None:
                raise ValueError("add_generation_model needs model or engine")
            engine = GenerationEngine(model, name=name, **engine_opts)
        if warmup:
            engine.warmup()
        scheduler = GenerationScheduler(engine, **(scheduler_opts or {}))
        self._models[name] = _Hosted(
            engine, scheduler, kind="generate", warmed=bool(warmup)
        )
        return engine

    def models(self):
        return sorted(self._models)

    # ---- lifecycle --------------------------------------------------------
    def start(self):
        """Bind + serve on a daemon thread; returns the bound port (useful
        with port=0)."""
        server = self

        class Handler(BaseHTTPRequestHandler):
            # one handler class per ModelServer instance: the closure is the
            # routing table
            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _reply(self, code, body, content_type="application/json",
                       retry_after=None, trace=None):
                server._m_http.inc(code=str(code))
                if code >= 500:
                    # a replica-side 5xx is a flight-recorder trigger: the
                    # span ring at this instant holds the request's story
                    _flightrec.trigger(
                        "http_5xx", code=code, path=self.path, trace=trace
                    )
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                if retry_after is None and code == 503:
                    retry_after = 1
                if retry_after is not None:
                    self.send_header("Retry-After", str(int(retry_after)))
                if trace:
                    self.send_header(TRACE_HEADER, trace)
                self.end_headers()
                self.wfile.write(body)

            def _reply_json(self, code, obj):
                self._reply(code, json.dumps(obj).encode())

            def do_GET(self):
                try:
                    if self.path == "/healthz" or self.path.startswith(
                        "/healthz?"
                    ):
                        verbose = "verbose=0" not in self.path
                        self._reply_json(200, server._healthz(verbose))
                    elif self.path == "/v1/models":
                        self._reply_json(200, server._describe())
                    elif (self.path.startswith(PREDICT_PREFIX)
                          and ":" not in self.path):
                        code, obj = server._describe_one(
                            self.path[len(PREDICT_PREFIX):]
                        )
                        self._reply_json(code, obj)
                    elif self.path == "/metrics":
                        self._reply(
                            200,
                            server._registry.to_prometheus().encode(),
                            content_type="text/plain; version=0.0.4",
                        )
                    else:
                        self._reply_json(404, {"error": "no route %s" % self.path})
                except Exception as e:  # handler thread must answer, not die
                    self._reply_json(500, {"error": repr(e)})

            def do_POST(self):
                # the server span adopts the router's trace context before
                # the fault hooks run, so even a request that dies to an
                # injected fault leaves its span in this replica's shard
                span = _tracing.tracer().start_span(
                    "server.request",
                    parent=self.headers.get(TRACE_HEADER),
                    path=self.path,
                )
                try:
                    # serving-side fault hooks: a replica dying
                    # mid-request, a half-open connection, a browned-out
                    # reply
                    _faults.kill_self("replica_kill")
                    if _faults.fires("conn_reset"):
                        span.tag(fault="conn_reset").end("error")
                        self.close_connection = True
                        self.connection.close()
                        return
                    _faults.delay("slow_response")
                    code, body, ctype, retry_after = server._predict(
                        self.path,
                        self.headers.get("Content-Type", ""),
                        self.rfile.read(
                            int(self.headers.get("Content-Length", 0))
                        ),
                        parent=span,
                    )
                    span.tag(code=code)
                    self._reply(code, body, content_type=ctype,
                                retry_after=retry_after,
                                trace=span.header())
                    span.end("ok" if code < 500 else "error")
                except Exception as e:
                    span.error(e).end()
                    self._reply_json(500, {"error": repr(e)})

        self._httpd = ThreadingHTTPServer((self.host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="model-server", daemon=True
        )
        self._thread.start()
        return self._httpd.server_address[1]

    @property
    def port(self):
        return self._httpd.server_address[1] if self._httpd else self._port

    @property
    def url(self):
        return "http://%s:%d" % (self.host, self.port)

    def stop(self, drain=True):
        """Shut the listener, then drain (or fail out) every batcher."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(10.0)
            self._httpd = None
        ok = True
        for hosted in self._models.values():
            ok = hosted.batcher.close(drain=drain) and ok
        return ok

    # ---- request handling (thread-safe, called from handler threads) ------
    def _healthz(self, verbose=True):
        """Liveness + (verbose) per-model readiness. The old liveness-only
        shape survives under ``?verbose=0`` for liveness-only scrapers."""
        if not verbose:
            return {
                "status": "ok",
                "models": {
                    name: {"variants": h.engine.stats()["variants"]}
                    for name, h in self._models.items()
                },
            }
        models = {}
        ready = bool(self._models)
        for name, h in self._models.items():
            bstats = h.batcher.stats()
            models[name] = {
                "kind": h.kind,
                "ready": h.warmed,
                "model_version": getattr(h.engine, "model_version", 0),
                "queue_depth": len(h.batcher._queue),
                "queued_rows": bstats.get("queued_rows", 0),
                "variants": h.engine.stats()["variants"],
            }
            ready = ready and h.warmed
        return {
            "status": "ok",
            "ready": ready,
            # the max over models: a replica serving several reports the
            # newest
            "model_version": max(
                [m["model_version"] for m in models.values()] or [0]
            ),
            "models": models,
        }

    def _describe(self):
        return {name: self._describe_one(name)[1] for name in self._models}

    def _describe_one(self, name):
        """(status, body) for GET /v1/models/<name>: the model's metadata
        plus its live hot-swap state — model_version and the publisher's
        staleness stamp (train step + wall time of the serving version)."""
        h = self._models.get(name)
        if h is None:
            return 404, {
                "error": "unknown model %r (have %s)" % (name, self.models())
            }
        if h.kind == "generate":
            out = {
                "kind": "generate",
                "stats": h.engine.stats(),
                "scheduler": h.batcher.stats(),
            }
        else:
            out = {
                "feeds": h.engine.feed_names,
                "fetches": h.engine.fetch_names,
                "batch_buckets": list(h.engine.batch_buckets),
                "stats": h.engine.stats(),
                "batcher": h.batcher.stats(),
            }
        out["model_version"] = getattr(h.engine, "model_version", 0)
        stamp = getattr(h.engine, "version_stamp", None)
        if stamp:
            out["version_stamp"] = dict(stamp)
        return 200, out

    def _predict(self, path, content_type, body, parent=NULL_SPAN):
        """(status, reply bytes, content type, retry-after hint) for one
        predict/generate POST. retry_after is None except on 503/504, where
        it is derived from the batcher's measured queue drain rate."""
        if path.startswith(PREDICT_PREFIX) and path.endswith(":generate"):
            return self._generate(
                path[len(PREDICT_PREFIX):-len(":generate")], body,
                parent=parent,
            )
        if not (path.startswith(PREDICT_PREFIX) and path.endswith(":predict")):
            return 404, json.dumps({"error": "no route %s" % path}).encode(), \
                "application/json", None
        name = path[len(PREDICT_PREFIX):-len(":predict")]
        hosted = self._models.get(name)
        if hosted is None:
            return 404, json.dumps(
                {"error": "unknown model %r (have %s)" % (name, self.models())}
            ).encode(), "application/json", None
        if hosted.kind != "predict":
            return 400, json.dumps(
                {"error": "model %r serves :generate, not :predict" % name}
            ).encode(), "application/json", None

        as_npz = "npz" in content_type or content_type == "application/octet-stream"
        try:
            if as_npz:
                data = np.load(_stdio.BytesIO(body), allow_pickle=False)
                feed = {k: data[k] for k in data.files}
            else:
                doc = json.loads(body.decode() or "{}")
                inputs = doc.get("inputs")
                if not isinstance(inputs, dict):
                    raise ValueError('body needs {"inputs": {feed: array}}')
                feed = {
                    k: np.asarray(v, dtype=hosted.engine._feed_dtype(k))
                    if k in hosted.engine._feed_dtypes
                    else np.asarray(v)
                    for k, v in inputs.items()
                }
        except Exception as e:
            return 400, json.dumps({"error": "bad payload: %r" % e}).encode(), \
                "application/json", None

        t0 = time.perf_counter()
        try:
            future = hosted.batcher.submit(feed, parent=parent)
        except QueueFullError as e:
            return 503, json.dumps({"error": str(e)}).encode(), \
                "application/json", self._retry_after(hosted, e)
        except ValueError as e:
            return 400, json.dumps({"error": str(e)}).encode(), \
                "application/json", None
        try:
            outs = future.result(self.request_timeout)
        except RequestTimeout as e:
            return 504, json.dumps({"error": str(e)}).encode(), \
                "application/json", self._retry_after(hosted, e)
        except Exception as e:
            return 500, json.dumps({"error": repr(e)}).encode(), \
                "application/json", None
        latency_ms = (time.perf_counter() - t0) * 1e3
        version = getattr(future, "model_version", None)
        if version is None:
            version = getattr(hosted.engine, "model_version", 0)

        if as_npz:
            buf = _stdio.BytesIO()
            np.savez(
                buf,
                **{
                    n: np.asarray(o, dtype=np.float32)
                    if "bfloat16" in str(np.asarray(o).dtype)
                    else np.asarray(o)
                    for n, o in zip(hosted.engine.fetch_names, outs)
                },
            )
            return 200, buf.getvalue(), "application/x-npz", None
        return 200, json.dumps(
            {
                "outputs": {
                    n: np.asarray(o, dtype=np.float64).tolist()
                    if "bfloat16" in str(np.asarray(o).dtype)
                    else np.asarray(o).tolist()
                    for n, o in zip(hosted.engine.fetch_names, outs)
                },
                "model_version": version,
                "latency_ms": latency_ms,
            }
        ).encode(), "application/json", None

    @staticmethod
    def _retry_after(hosted, err):
        """Retry-After seconds for a 503/504: the exception's drain estimate
        when the batcher attached one, else its live hint."""
        est = getattr(err, "retry_after_s", None)
        if est is not None:
            return int(min(max(-(-est // 1), 1), 30))
        hint = getattr(hosted.batcher, "retry_after_hint", None)
        return hint() if callable(hint) else 1

    def _generate(self, name, body, parent=NULL_SPAN):
        """(status, reply bytes, content type, retry-after hint) for one
        :generate POST."""
        hosted = self._models.get(name)
        if hosted is None:
            return 404, json.dumps(
                {"error": "unknown model %r (have %s)" % (name, self.models())}
            ).encode(), "application/json", None
        if hosted.kind != "generate":
            return 400, json.dumps(
                {"error": "model %r serves :predict, not :generate" % name}
            ).encode(), "application/json", None
        try:
            doc = json.loads(body.decode() or "{}")
            prompt = doc.get("prompt")
            if not isinstance(prompt, (list, tuple)) or not prompt:
                raise ValueError('body needs {"prompt": [token ids...]}')
            kw = {
                k: doc[k]
                for k in ("max_new_tokens", "eos_id", "temperature",
                          "top_k", "seed")
                if doc.get(k) is not None
            }
        except (ValueError, json.JSONDecodeError) as e:
            return 400, json.dumps({"error": "bad payload: %r" % e}).encode(), \
                "application/json", None

        t0 = time.perf_counter()
        try:
            future = hosted.batcher.submit(prompt, parent=parent, **kw)
        except QueueFullError as e:
            return 503, json.dumps({"error": str(e)}).encode(), \
                "application/json", self._retry_after(hosted, e)
        except ValueError as e:
            return 400, json.dumps({"error": str(e)}).encode(), \
                "application/json", None
        try:
            res = future.result(self.request_timeout)
        except RequestTimeout as e:
            return 504, json.dumps({"error": str(e)}).encode(), \
                "application/json", self._retry_after(hosted, e)
        except Exception as e:
            return 500, json.dumps({"error": repr(e)}).encode(), \
                "application/json", None
        return 200, json.dumps(
            {
                "tokens": list(res.tokens),
                "finish_reason": res.finish_reason,
                "prompt_len": res.prompt_len,
                # the live version at completion time (token-level attribution
                # across a mid-request swap is meaningless for AR decode)
                "model_version": getattr(hosted.engine, "model_version", 0),
                "latency_ms": (time.perf_counter() - t0) * 1e3,
            }
        ).encode(), "application/json", None
