"""Continuous dynamic batcher: a background thread that packs concurrent
requests into engine buckets.

Request-handling model: Clipper's adaptive-batching frontend crossed with
Orca's continuous admission — the dispatcher does not wait for a full batch
boundary; it admits whatever is queued the moment either (a) enough rows are
waiting to fill the largest bucket, or (b) the oldest request has waited
`max_batch_delay_ms`. Padding to the power-of-two bucket is the engine's
job; admitted requests that disagree on dynamic trailing dims (mixed
sequence lengths) are packed and executed per same-trailing-shape group, so
mixed-length traffic costs extra engine calls, never failed requests. The
batcher's job is the time/row tradeoff and the failure modes:

- **backpressure**: the queue is bounded in ROWS (not requests — a single
  512-row request is 512 rows of device debt). A full queue fast-fails
  submit() with QueueFullError, the HTTP front end's 503.
- **deadline-aware admission**: beyond the row cap, submit() sheds work it
  cannot finish inside the per-request timeout — once the measured drain
  rate (EWMA rows/s over engine calls) says the rows already queued will
  take longer than `timeout_ms` to clear, accepting more would only
  manufacture future 504s, so the request is rejected NOW while the client
  can still fail over. Both rejection flavors carry `retry_after_s`
  (queued_rows / drain_rate) — the HTTP front end's Retry-After hint.
- **per-request timeout**: a request that ages past `timeout_ms` before its
  batch executes fails with RequestTimeout (HTTP 504) instead of occupying
  a bucket slot.
- **drain/shutdown**: close(drain=True) stops admission, lets the worker
  finish the queue, and joins it; close(drain=False) fails queued requests
  with ShutdownError.

Telemetry (observability registry, `serving/<model>/...`): queue_ms and latency_ms
histograms split queue wait from the engine's device_ms, queue-depth and
in-flight gauges, and a `requests` counter labelled by outcome
(ok/rejected/timeout/error/shutdown).
"""

import threading
import time

import numpy as np

from ..observability import tracing as _tracing
from ..observability.tracing import NULL_SPAN

__all__ = [
    "ContinuousBatcher",
    "ServingFuture",
    "QueueFullError",
    "RequestTimeout",
    "ShutdownError",
]


class QueueFullError(RuntimeError):
    """Bounded request queue is full, or the measured drain rate says the
    queue cannot clear inside the request deadline — fast-fail admission
    (HTTP 503). `retry_after_s` estimates when the queue will have drained
    (None when no drain rate is known yet)."""

    def __init__(self, msg, retry_after_s=None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class RequestTimeout(RuntimeError):
    """Request aged past its deadline before a batch executed (HTTP 504).
    `retry_after_s` carries the batcher's current drain estimate when the
    dispatcher raised it (None from a bare result() wait)."""

    def __init__(self, msg, retry_after_s=None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class ShutdownError(RuntimeError):
    """Batcher was closed without draining this request."""


class ServingFuture:
    """One request's result slot. result() blocks the CALLER's thread; the
    dispatcher thread only ever sets."""

    def __init__(self):
        self._done = threading.Event()
        self._outputs = None
        self._error = None
        # which hot-swapped parameter version served this request (set by
        # the dispatcher before _set_result; None until then / on error)
        self.model_version = None

    def _set_result(self, outputs):
        self._outputs = outputs
        self._done.set()

    def _set_error(self, err):
        self._error = err
        self._done.set()

    def done(self):
        return self._done.is_set()

    def result(self, timeout=None):
        if not self._done.wait(timeout):
            raise RequestTimeout("no result within %ss" % timeout)
        if self._error is not None:
            raise self._error
        return self._outputs


class _Request:
    __slots__ = ("feed", "rows", "future", "t_submit", "span")

    def __init__(self, feed, rows, span=NULL_SPAN):
        self.feed = feed
        self.rows = rows
        self.future = ServingFuture()
        self.t_submit = time.perf_counter()
        # the request's lifecycle span (queued -> admitted -> dispatched ->
        # completed events); NULL_SPAN when tracing is off — zero per-
        # request allocation on the disabled path
        self.span = span


class ContinuousBatcher:
    def __init__(self, engine, max_queue_rows=256, max_batch_delay_ms=5.0,
                 timeout_ms=2000.0):
        self.engine = engine
        self.max_queue_rows = int(max_queue_rows)
        self.max_batch_delay = float(max_batch_delay_ms) / 1e3
        self.timeout = float(timeout_ms) / 1e3
        self._cond = threading.Condition()
        self._queue = []  # FIFO of _Request
        self._queued_rows = 0
        self._alive = True
        self._draining = False
        # measured service rate (rows/s, EWMA over engine calls): admission's
        # can-this-finish-in-time estimate and the Retry-After hint's basis.
        # None until the first engine call completes — a cold batcher must
        # not shed load off a guess.
        self._drain_rate = None

        from ..observability import registry as _registry

        reg = _registry.default_registry()
        p = "serving/%s" % engine.name
        self._m_queue_ms = reg.histogram(
            p + "/queue_ms", "request wait in the batcher queue"
        )
        self._m_latency_ms = reg.histogram(
            p + "/latency_ms", "request submit->result latency"
        )
        self._m_depth = reg.gauge(p + "/queue_rows", "rows waiting in queue")
        self._m_inflight = reg.gauge(
            p + "/inflight_rows", "rows in the engine call in progress"
        )
        self._m_requests = reg.counter(
            p + "/requests", "requests by outcome label"
        )
        self._batches_dispatched = 0

        self._worker = threading.Thread(
            target=self._loop, name="batcher-%s" % engine.name, daemon=True
        )
        self._worker.start()

    # ---- client side ------------------------------------------------------
    def submit(self, feed, parent=None):
        """Enqueue one request (dict name->array or list zipped with the
        engine's feed_names); returns a ServingFuture. Raises QueueFullError
        when admission would exceed max_queue_rows, ShutdownError after
        close(). `parent` (a Span or trace header) parents the request's
        lifecycle span when tracing is on."""
        if isinstance(feed, (list, tuple)):
            feed = dict(zip(self.engine.feed_names, feed))
        feed = {k: np.asarray(v) for k, v in feed.items()}
        missing = [n for n in self.engine.feed_names if n not in feed]
        if missing:
            raise ValueError("missing feeds: %s" % missing)
        unknown = sorted(set(feed) - set(self.engine.feed_names))
        if unknown:
            raise ValueError(
                "unknown feeds: %s (model takes %s)"
                % (unknown, self.engine.feed_names)
            )
        rows = {np.shape(a)[0] if np.ndim(a) else 1 for a in feed.values()}
        if len(rows) != 1:
            raise ValueError(
                "feeds disagree on batch rows: %s"
                % {n: np.shape(a) for n, a in feed.items()}
            )
        n = rows.pop()
        if n < 1:
            raise ValueError("empty batch")
        if n > self.engine.max_batch:
            raise ValueError(
                "request rows %d exceed the largest bucket %d; split the "
                "request" % (n, self.engine.max_batch)
            )
        req = _Request(feed, n, span=_tracing.tracer().start_span(
            "serving.request", parent=parent, model=self.engine.name, rows=n,
        ))
        req.span.event("queued")
        with self._cond:
            if not self._alive or self._draining:
                self._m_requests.inc(outcome="shutdown")
                req.span.tag(outcome="shutdown").end("error")
                raise ShutdownError("batcher is shut down")
            if self._queued_rows + n > self.max_queue_rows:
                self._m_requests.inc(outcome="rejected")
                req.span.tag(outcome="rejected").end("error")
                raise QueueFullError(
                    "queue full (%d rows queued, limit %d)"
                    % (self._queued_rows, self.max_queue_rows),
                    retry_after_s=self._retry_after_locked(),
                )
            # deadline-aware admission: if the rows ahead of this request
            # will (by the measured drain rate) take longer than the request
            # timeout to clear, it is already doomed to a 504 — reject with
            # the honest wait estimate instead of accepting work we cannot
            # finish
            if self._drain_rate:
                est_wait = (self._queued_rows + n) / self._drain_rate
                if est_wait > self.timeout:
                    self._m_requests.inc(outcome="rejected")
                    req.span.tag(outcome="shed").end("error")
                    raise QueueFullError(
                        "queue drain estimate %.0f ms exceeds request "
                        "timeout %.0f ms (%d rows queued at %.0f rows/s)"
                        % (est_wait * 1e3, self.timeout * 1e3,
                           self._queued_rows, self._drain_rate),
                        retry_after_s=self._retry_after_locked(),
                    )
            self._queue.append(req)
            self._queued_rows += n
            self._m_depth.set(self._queued_rows)
            self._cond.notify_all()
        return req.future

    def run(self, feed, timeout=None):
        """Synchronous convenience: submit + result."""
        return self.submit(feed).result(
            self.timeout * 2 if timeout is None else timeout
        )

    def _retry_after_locked(self):
        """Seconds until the currently queued rows should have drained (the
        Retry-After hint); None before any drain rate is measured."""
        if not self._drain_rate:
            return None
        return max(self._queued_rows / self._drain_rate, 0.05)

    def retry_after_hint(self):
        """Thread-safe Retry-After estimate for the HTTP front end: how long
        a rejected/timed-out client should wait before retrying THIS
        replica. Clamped to [1, 30] whole seconds; 1 when unknown."""
        with self._cond:
            est = self._retry_after_locked()
        if est is None:
            return 1
        return int(min(max(-(-est // 1), 1), 30))

    # ---- dispatcher -------------------------------------------------------
    def _admit_locked(self):
        """Pop the next batch: FIFO requests up to the largest bucket's rows
        (requests are never split — each fits a bucket by submit's check)."""
        batch = []
        rows = 0
        while self._queue:
            nxt = self._queue[0]
            if batch and rows + nxt.rows > self.engine.max_batch:
                break
            batch.append(self._queue.pop(0))
            rows += nxt.rows
        self._queued_rows -= rows
        self._m_depth.set(self._queued_rows)
        return batch, rows

    def _loop(self):
        while True:
            with self._cond:
                # untimed: submit() and close() notify, so an empty queue
                # costs zero wakeups
                while self._alive and not self._queue:
                    self._cond.wait()
                if not self._queue:
                    if not self._alive:
                        return
                    continue
                # continuous admission: dispatch when the waiting rows can
                # fill the largest bucket OR the oldest request's batch-delay
                # deadline passes — never both idle and holding work
                deadline = self._queue[0].t_submit + self.max_batch_delay
                while (
                    self._alive
                    and self._queued_rows < self.engine.max_batch
                    and time.perf_counter() < deadline
                ):
                    self._cond.wait(
                        max(deadline - time.perf_counter(), 0.001)
                    )
                batch, rows = self._admit_locked()
            if batch:
                self._dispatch(batch, rows)

    def _dispatch(self, batch, rows):
        now = time.perf_counter()
        live = []
        for req in batch:
            if now - req.t_submit > self.timeout:
                self._m_requests.inc(outcome="timeout")
                req.span.tag(outcome="timeout").end("error")
                with self._cond:
                    hint = self._retry_after_locked()
                req.future._set_error(
                    RequestTimeout(
                        "queued %.0f ms > timeout %.0f ms"
                        % ((now - req.t_submit) * 1e3, self.timeout * 1e3),
                        retry_after_s=hint,
                    )
                )
            else:
                live.append(req)
        if not live:
            return
        for req in live:
            self._m_queue_ms.observe((now - req.t_submit) * 1e3)
            req.span.event(
                "admitted", queue_ms=round((now - req.t_submit) * 1e3, 3)
            )
        # requests may disagree on dynamic trailing dims (sequence lengths);
        # np.concatenate across mixed trailing shapes raises and would fail
        # the whole batch, so pack and execute one same-trailing-shape group
        # at a time (FIFO order preserved within and across groups)
        groups = {}
        for req in live:
            sig = tuple(
                tuple(np.shape(req.feed[n])[1:])
                for n in self.engine.feed_names
            )
            groups.setdefault(sig, []).append(req)
        self._m_inflight.set(sum(r.rows for r in live))
        try:
            for members in groups.values():
                self._run_group(members)
        finally:
            self._m_inflight.set(0)

    def _run_group(self, live):
        """Execute one same-trailing-shape group and answer its futures."""
        packed = {
            n: np.concatenate(
                [np.atleast_1d(np.asarray(r.feed[n])) for r in live]
            )
            for n in self.engine.feed_names
        }
        self._batches_dispatched += 1
        total_rows = sum(r.rows for r in live)
        # one batch span per engine call, parented on the first request of
        # the group (FIFO head); co-batched requests cross-link to it via a
        # "dispatched" event so the chrome-trace view shows the sharing
        bspan = live[0].span.child(
            "serving.batch", requests=len(live), rows=total_rows,
        )
        if bspan:
            for req in live[1:]:
                req.span.event("dispatched", batch_span=bspan.span_id)
        t_run = time.perf_counter()
        try:
            # activate: the engine opens its execute span under this parent
            # without the engine API taking a span argument
            with _tracing.tracer().activate(bspan):
                outs = self.engine.run(packed)
        except Exception as e:
            bspan.error(e).end()
            # a fresh exception per future: the same instance re-raised from
            # several caller threads would share (and mutate) one traceback
            for req in live:
                self._m_requests.inc(outcome="error")
                req.span.tag(outcome="error").end("error")
                err = RuntimeError("engine failed: %s" % (repr(e),))
                err.__cause__ = e
                req.future._set_error(err)
            return
        done = time.perf_counter()
        elapsed = max(done - t_run, 1e-6)
        rate = sum(r.rows for r in live) / elapsed
        with self._cond:
            self._drain_rate = (
                rate if self._drain_rate is None
                else 0.7 * self._drain_rate + 0.3 * rate
            )
        # which hot-swapped version the engine call above ran on: read on
        # THIS (dispatcher) thread, where the engine recorded it
        served = getattr(self.engine, "last_served_version", None)
        version = served() if callable(served) else None
        lo = 0
        total = sum(r.rows for r in live)
        for req in live:
            part = [
                o[lo:lo + req.rows]
                if np.ndim(o) and np.shape(o)[0] == total
                else o
                for o in outs
            ]
            lo += req.rows
            req.future.model_version = version
            req.future._set_result(part)
        # bookkeeping AFTER answering the futures: span ends (and the root
        # end's segment serialization) and metric updates stay off the
        # client's measured request latency
        bspan.tag(model_version=version).end()
        for req in live:
            self._m_latency_ms.observe((done - req.t_submit) * 1e3)
            self._m_requests.inc(outcome="ok")
            req.span.tag(outcome="ok", model_version=version).end()

    # ---- lifecycle --------------------------------------------------------
    def close(self, drain=True, timeout=30.0):
        """Stop admission; with drain, the worker finishes the queue before
        exiting, else queued requests fail with ShutdownError."""
        with self._cond:
            self._draining = True
            if not drain:
                for req in self._queue:
                    self._m_requests.inc(outcome="shutdown")
                    req.span.tag(outcome="shutdown").end("error")
                    req.future._set_error(ShutdownError("batcher closed"))
                self._queued_rows = 0
                self._queue = []
                self._m_depth.set(0)
            self._alive = False
            self._cond.notify_all()
        self._worker.join(timeout)
        return not self._worker.is_alive()

    def stats(self):
        with self._cond:
            return {
                "queued_rows": self._queued_rows,
                "batches_dispatched": self._batches_dispatched,
                "drain_rate_rows_per_s": self._drain_rate,
                "alive": self._alive,
            }
