"""Dapper-style distributed request tracing for the serving fleet.

One request crosses four queueing layers (router -> replica HTTP handler ->
batcher/scheduler -> engine), usually across processes. The aggregate
metrics (registry histograms) can say p99 regressed; this module says WHERE
one request's time went, by threading a TraceContext through every hop:

- **context**: (trace_id, span_id) propagates between processes in the
  ``X-Fleet-Trace: <trace_id>-<span_id>`` header (parse_header /
  Span.header()); within a process either explicitly (``span.child(...)``)
  or implicitly through the thread-local set by ``activate(span)`` — how the
  batcher's dispatcher thread hands the engine a parent without the engine
  API knowing about tracing.
- **spans**: Span.end() freezes one record {trace, span, parent, name, pid,
  host, tid, ts, dur_ms, status, tags, events}. Records land in a bounded
  per-process ring (the flight recorder's lookback — observability/
  flightrec.py) and, per the tail-sampling decision below, in per-process
  rotation-safe JSONL shards ``trace-host<h>-p<pid>.jsonl`` under
  FLAGS_trace_dir (append/rotate discipline: flush per drain, rotate at
  max_bytes; read them back with load_spans). Export is
  asynchronous: the request thread serializes its kept segment (a few us,
  paid evenly — batching serialization in the writer would burst the GIL
  onto in-flight requests) and appends the blob to a deque; an IO-only
  daemon writer drains and flushes every ~20ms, so shards survive SIGKILL
  with at most one drain interval of loss and tracing-on p99 stays inside
  the overhead budget.
- **tail sampling**: spans buffer in their local *segment* (all spans this
  process contributes to one trace) until the segment root ends, then the
  whole segment is kept or dropped at once. Error spans, spans slower than
  FLAGS_trace_slow_ms, and force_keep()'d spans (hedges, hot-swaps) always
  keep their segment; OK segments are kept when
  ``keep_trace(trace_id, FLAGS_trace_sample)`` says so — a DETERMINISTIC
  hash of the trace id, so every process in the fleet makes the same call
  for the same trace without coordination, and a sampled trace is never
  half-exported.
- **off path**: with tracing disabled (neither FLAGS_trace_dir nor
  FLAGS_flightrec_dir set), start_span returns the process-wide NULL_SPAN
  singleton whose methods are no-ops — the serving hot loop allocates
  NOTHING per request (tests assert object identity), and outputs are
  bit-identical to a build that never imported this module.

The shard format is the JAX package's (paddle_tpu/observability/tracing.py),
so its rendering tools read this package's shards unchanged.
"""

import atexit
import glob
import itertools as _itertools
import json
import os
import random as _random
import threading
import time
import zlib
from collections import deque

__all__ = [
    "NULL_SPAN",
    "Span",
    "Tracer",
    "tracer",
    "reset",
    "current",
    "activate",
    "parse_header",
    "keep_trace",
    "load_spans",
    "TRACE_HEADER",
    "SHARD_PATTERN",
]

TRACE_HEADER = "X-Fleet-Trace"
SHARD_PATTERN = "trace-*.jsonl*"


class _NullSpan:
    """The disabled tracer's span: ONE process-wide singleton whose methods
    are no-ops, so the tracing-off hot path allocates nothing per request.
    Falsy, so ``if span:`` gates optional work."""

    __slots__ = ()
    trace_id = None
    span_id = None
    parent_id = None
    status = "ok"

    def child(self, name, **tags):
        return self

    def tag(self, **tags):
        return self

    def event(self, name, **attrs):
        return self

    def error(self, err):
        return self

    def force_keep(self):
        return self

    def end(self, status=None):
        return self

    def header(self):
        return None

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        return False

    def __bool__(self):
        return False

    def __repr__(self):
        return "<NULL_SPAN>"


NULL_SPAN = _NullSpan()


# id generation avoids the per-span getrandom syscall: trace ids come from a
# process-seeded PRNG (uniqueness + a well-mixed sampling-hash input need
# unpredictability across processes, not crypto strength), span ids from a
# counter off a random start (uniqueness within one trace is enough).
# Random.getrandbits and itertools.count.__next__ are atomic under the GIL.
_id_rng = _random.Random(os.urandom(16))
_span_ctr = _itertools.count(int.from_bytes(os.urandom(4), "big"))


def _new_id(nbytes):
    return "%0*x" % (2 * nbytes, _id_rng.getrandbits(8 * nbytes))


def _next_span_id():
    return "%08x" % (next(_span_ctr) & 0xFFFFFFFF)


def parse_header(value):
    """``"<trace_id>-<span_id>"`` -> (trace_id, span_id), or None for
    anything malformed — tracing must never fail a request."""
    if not value or not isinstance(value, str):
        return None
    parts = value.strip().split("-")
    if len(parts) != 2 or not parts[0] or not parts[1]:
        return None
    try:
        int(parts[0], 16)
        int(parts[1], 16)
    except ValueError:
        return None
    return parts[0], parts[1]


def keep_trace(trace_id, sample):
    """The fleet-consistent OK-trace sampling decision: a deterministic hash
    of the trace id against `sample`, so every process keeps or drops the
    same traces without coordination (error/slow/hedged segments bypass
    this via _Segment.keep)."""
    if sample >= 1.0:
        return True
    if sample <= 0.0:
        return False
    h = zlib.crc32(trace_id.encode("ascii", "replace")) & 0xFFFFFFFF
    return h / 4294967296.0 < sample


class _Segment:
    """Every span one process contributes to one trace (its local subtree).
    The tail-sampling unit: records buffer here until the segment root ends,
    then the whole segment is exported or dropped in one decision."""

    __slots__ = ("records", "keep", "decided", "kept")

    def __init__(self):
        self.records = []
        self.keep = False  # forced by error / slow / force_keep'd spans
        self.decided = False
        self.kept = False


class Span:
    """One timed operation in a trace. Ends at most once; ending freezes the
    record into the tracer's ring + its segment. Usable as a context manager
    (an exception marks the span error before ending it)."""

    __slots__ = ("_tracer", "name", "trace_id", "span_id", "parent_id",
                 "tags", "events", "status", "_t0_wall", "_t0", "_tid",
                 "_segment", "_is_root", "_ended")

    def __init__(self, tracer_, name, trace_id, parent_id, segment, is_root,
                 tags):
        self._tracer = tracer_
        self.name = name
        self.trace_id = trace_id
        self.span_id = _next_span_id()
        self.parent_id = parent_id
        self.tags = tags
        self.events = None
        self.status = "ok"
        self._t0_wall = time.time()
        self._t0 = time.perf_counter()
        self._tid = threading.get_ident() & 0xFFFFFF
        self._segment = segment
        self._is_root = is_root
        self._ended = False

    # ---- annotation -------------------------------------------------------
    def child(self, name, **tags):
        return self._tracer.start_span(name, parent=self, **tags)

    def tag(self, **tags):
        self.tags.update(tags)
        return self

    def event(self, name, **attrs):
        """Timestamped point annotation (a Dapper log entry)."""
        e = {"name": name, "ts": time.time()}
        if attrs:
            e.update(attrs)
        if self.events is None:
            self.events = []
        self.events.append(e)
        return self

    def error(self, err):
        self.status = "error"
        self.tags.setdefault("error", repr(err))
        return self

    def force_keep(self):
        """Exempt this span's whole segment from OK-trace sampling (hedged
        requests, hot-swaps — rare events worth keeping every time)."""
        self._segment.keep = True
        return self

    # ---- lifecycle --------------------------------------------------------
    def end(self, status=None):
        if self._ended:
            return self
        self._ended = True
        if status is not None:
            self.status = status
        self._tracer._finish(self)
        return self

    def header(self):
        """The X-Fleet-Trace value carrying this span's context downstream."""
        return "%s-%s" % (self.trace_id, self.span_id)

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        if ev is not None:
            self.error(ev)
        self.end()
        return False

    def __bool__(self):
        return True

    def __repr__(self):
        return "<Span %s %s/%s>" % (self.name, self.trace_id, self.span_id)


class _NoopActivation:
    __slots__ = ()

    def __enter__(self):
        return NULL_SPAN

    def __exit__(self, et, ev, tb):
        return False


_NOOP_ACTIVATION = _NoopActivation()


class _Activation:
    __slots__ = ("_local", "_span", "_prev")

    def __init__(self, local, span):
        self._local = local
        self._span = span

    def __enter__(self):
        self._prev = getattr(self._local, "span", NULL_SPAN)
        self._local.span = self._span
        return self._span

    def __exit__(self, et, ev, tb):
        self._local.span = self._prev
        return False


class Tracer:
    """Per-process span factory, ring buffer, sampler and shard writer.
    Normally built from flags via the module-level tracer(); tests construct
    directly. A tracer with enabled=False is the zero-allocation stub."""

    def __init__(self, out_dir="", sample=1.0, slow_ms=500.0, ring=4096,
                 enabled=True, max_bytes=64 << 20):
        self.enabled = bool(enabled)
        self.out_dir = out_dir or None
        self.sample = float(sample)
        self.slow_ms = float(slow_ms)
        self.ring = deque(maxlen=max(int(ring), 16))
        self.max_bytes = int(max_bytes)
        from .export import _process_index

        self._host = _process_index()
        self._pid = os.getpid()
        self._lock = threading.Lock()
        self._fh = None
        self._shard_path = None
        self._q = deque()    # pending kept segments (append is the on-path cost)
        self._writer = None  # daemon thread draining the deque in batches
        self._stop = threading.Event()
        self._io_lock = threading.Lock()  # serializes _drain callers
        self._closed = False
        self._local = threading.local()
        self._m_spans = self._m_segments = None
        if self.enabled:
            from . import registry as _registry

            reg = _registry.default_registry()
            self._m_spans = reg.counter(
                "trace/spans", "spans ended, by status label"
            )
            self._m_segments = reg.counter(
                "trace/segments", "local trace segments by sampling decision"
            )

    # ---- span factory -----------------------------------------------------
    def start_span(self, name, parent=None, **tags):
        """Open a span. `parent` is a live Span (same-process child), an
        X-Fleet-Trace header string (cross-process child), or None (new
        trace). Returns NULL_SPAN when tracing is off."""
        if not self.enabled:
            return NULL_SPAN
        if isinstance(parent, Span):
            return Span(self, name, parent.trace_id, parent.span_id,
                        parent._segment, False, tags)
        trace_id = parent_id = None
        if isinstance(parent, str):
            ctx = parse_header(parent)
            if ctx is not None:
                trace_id, parent_id = ctx
        if trace_id is None:
            trace_id = _new_id(8)
        # a span entering from another process (or starting a trace) roots a
        # fresh local segment: the tail-sampling unit for THIS process
        return Span(self, name, trace_id, parent_id, _Segment(), True, tags)

    def current(self):
        """The thread's implicitly activated span (NULL_SPAN when none) —
        how tracing crosses an API that doesn't take a span parameter."""
        return getattr(self._local, "span", NULL_SPAN)

    def activate(self, span):
        """Context manager making `span` the thread's current() span."""
        if not self.enabled or span is NULL_SPAN:
            return _NOOP_ACTIVATION
        return _Activation(self._local, span)

    # ---- completion / sampling -------------------------------------------
    def _finish(self, span):
        dur_ms = (time.perf_counter() - span._t0) * 1e3
        rec = {
            "kind": "span",
            "trace": span.trace_id,
            "span": span.span_id,
            "parent": span.parent_id,
            "name": span.name,
            "pid": self._pid,
            "host": self._host,
            "tid": span._tid,
            "ts": span._t0_wall,
            "dur_ms": round(dur_ms, 3),
            "status": span.status,
        }
        if span.tags:
            rec["tags"] = span.tags
        if span.events:
            rec["events"] = span.events
        self.ring.append(rec)  # flight-recorder lookback: sampled or not
        self._m_spans.inc(status=span.status)
        seg = span._segment
        if span.status != "ok" or dur_ms >= self.slow_ms:
            seg.keep = True
        if seg.decided:
            # a child that outlived its segment root follows the decision
            if seg.kept:
                self._export((rec,))
            return
        seg.records.append(rec)
        if not span._is_root:
            return
        kept = seg.keep or keep_trace(span.trace_id, self.sample)
        seg.decided, seg.kept = True, kept
        records, seg.records = seg.records, []
        self._m_segments.inc(decision="kept" if kept else "dropped")
        if kept:
            self._export(records)

    _DRAIN_INTERVAL_S = 0.02

    def _export(self, records):
        """Hand a kept segment to the background writer. Serialization
        happens HERE: a few microseconds paid evenly on every request
        beats batching it in the writer, whose periodic GIL bursts would
        land on whichever request is in flight and spike the tail. The
        writer is IO-only."""
        if self.out_dir is None:
            return
        blob = "".join(json.dumps(rec) + "\n" for rec in records)
        self._q.append(blob)
        if self._writer is None:
            with self._lock:
                if self._writer is None and not self._closed:
                    self._writer = threading.Thread(
                        target=self._write_loop, name="trace-export",
                        daemon=True,
                    )
                    self._writer.start()

    def _write_loop(self):
        while not self._stop.wait(self._DRAIN_INTERVAL_S):
            self._drain()
        self._drain()  # final sweep after close() signals stop

    def _drain(self):
        """Write every pre-serialized blob queued so far, flush once.
        Thread-safe (writer thread, flush(), close() all call it)."""
        with self._io_lock:
            q = self._q
            if not q:
                return
            try:
                if self._fh is None:
                    os.makedirs(self.out_dir, exist_ok=True)
                    self._shard_path = os.path.join(
                        self.out_dir,
                        "trace-host%d-p%d.jsonl" % (self._host, self._pid),
                    )
                    self._fh = open(self._shard_path, "a")
                while q:
                    self._fh.write(q.popleft())
                # flush per drain batch so shards survive a SIGKILL'd
                # replica (loss window <= one drain interval)
                self._fh.flush()
                if self._fh.tell() >= self.max_bytes:
                    self._fh.close()
                    os.replace(self._shard_path, self._shard_path + ".1")
                    self._fh = open(self._shard_path, "a")
            except OSError:
                pass  # a full disk must not fail the request being traced

    def flush(self):
        """Put every segment enqueued so far on disk, synchronously."""
        if self.out_dir is not None:
            self._drain()

    # ---- introspection ----------------------------------------------------
    def recent(self, n=None):
        """Newest-last span records from the ring (all ended spans, sampled
        or not) — the flight recorder's lookback window."""
        out = list(self.ring)
        return out if n is None else out[-int(n):]

    def close(self):
        """Drain the writer and close the shard. Safe to call twice."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            w = self._writer
        self._stop.set()
        if w is not None:
            w.join(5.0)
        self._drain()  # anything the writer missed (or no writer at all)
        with self._io_lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


# ---- process singleton ----------------------------------------------------
_tracer = None
_tracer_lock = threading.Lock()


def _build():
    from .. import flags as _flags

    f = _flags.get_flags([
        "trace_dir", "trace_sample", "trace_slow_ms", "trace_ring",
        "flightrec_dir",
    ])
    # the ring must run for the flight recorder even when shard export is
    # off, so either flag enables span creation
    enabled = bool(f["trace_dir"]) or bool(f["flightrec_dir"])
    return Tracer(
        out_dir=f["trace_dir"],
        sample=f["trace_sample"],
        slow_ms=f["trace_slow_ms"],
        ring=f["trace_ring"],
        enabled=enabled,
    )


def tracer():
    """The process tracer, built from FLAGS_trace_* on first use. After
    set_flags, call reset() to rebuild."""
    global _tracer
    t = _tracer
    if t is None:
        with _tracer_lock:
            t = _tracer
            if t is None:
                t = _tracer = _build()
    return t


def current():
    return tracer().current()


def activate(span):
    return tracer().activate(span)


def reset():
    """Drop the process tracer so the next tracer() call re-reads flags
    (tests toggle FLAGS_trace_dir mid-process)."""
    global _tracer
    with _tracer_lock:
        t, _tracer = _tracer, None
    if t is not None:
        t.close()


def _atexit_drain():
    # the export writer is a daemon thread; drain it on clean interpreter
    # exit so a replica that simply returns from main loses no segments
    t = _tracer
    if t is not None:
        t.close()


atexit.register(_atexit_drain)


# ---- reading shards back --------------------------------------------------
def load_spans(path):
    """Span records from one JSONL shard file, or every ``trace-*.jsonl*``
    shard under a directory, ts-sorted. Torn trailing lines are skipped
    (export.read_records)."""
    from .export import read_records

    if os.path.isdir(path):
        paths = sorted(glob.glob(os.path.join(path, SHARD_PATTERN)))
    else:
        paths = [path]
    records = []
    for p in paths:
        records.extend(
            r for r in read_records(p) if r.get("kind") == "span"
        )
    records.sort(key=lambda r: (r.get("ts", 0), r.get("pid", 0)))
    return records
