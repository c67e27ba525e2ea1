"""HotReloader — applies published versions to live serving engines (the
torch port of paddle_tpu/online/reloader.py).

The reader half of the publish/reload protocol (docs/online.md): a daemon
poll loop (or an explicit ``check_once()`` — the testable face) watches the
model repository's LATEST.json pointer and, when it advances, lands the new
version in every registered engine WITHOUT recompiling or dropping requests:

- **incremental**: when the pointer stays on the engines' current base and
  the delta chain links cleanly past the applied version, each pending delta
  is replayed directly — dense params swap wholesale, touched table rows
  scatter into the live table in place, under the engine's swap lock (an
  in-flight request finishes on the version it started with) — one
  ``engine.set_params`` per version, so the ``model_version`` served with
  each response is a real published version, never a half-applied blend;
- **full**: a base change (compaction), a chain gap, or a cold start falls
  back to ``load_with_deltas`` — the same arrays an offline Predictor would
  restore, which is exactly what an offline engine rebuilt at that
  version serves;
- after catching up the reloader ACKs the version into the repository
  (online.staleness.write_ack) — the trainer's throttle input — and updates
  the ``online/serving_version`` + ``online/serving_staleness_steps`` /
  ``_seconds`` gauges (scraped via the ModelServer's /metrics).

Engines are anything with ``scope.vars``, ``set_params(updates, version=,
stamp=, rows=)`` and a ``name`` — ServingEngine and GenerationEngine both
qualify.
A torn read (the publisher GC'ing underfoot) is counted, logged, and retried
at the next poll; the engines keep serving the version they have.

On torch a delta's table rows go to `set_params(rows=...)`, which scatters
them (index_copy_ of unique ids: apply_delta's row assignment, bit for bit)
into the tensor the engine serves, on whatever device it lives: only the
delta's rows cross to a card, and nothing comes back. A table the engine
lacks raises KeyError and one of another shape ValueError, as apply_delta
raises them; either is counted like a torn read. `history` records every
applied version: its kind, its wall ms and the part of it spent reading
the files, and the bytes it copied host to device (nothing is copied back). A swap does not flush an engine's prefix cache,
as in the JAX package.
"""

import threading
import time
import warnings

import torch

from ..observability import tracing as _tracing
from ..resilience import async_ckpt
from . import publisher as _publisher
from . import staleness as _staleness

__all__ = ["HotReloader"]


def _h2d_bytes(engine, updates, rows=None):
    """Bytes a set_params of `updates` (and of `rows`' ids and values)
    copies from the host onto the engine's card (0 on the CPU, or for
    values already on the card)."""
    dev = getattr(getattr(engine, "scope", None), "device", None)
    if dev is None or dev.type != "cuda":
        return 0
    served = set(engine.param_names()) if hasattr(engine, "param_names") else None
    values = list(updates.items()) + [(n, v) for n, pair in (rows or {}).items() for v in pair]
    n = 0
    for name, v in values:
        if served is not None and name not in served:
            continue
        if isinstance(v, torch.Tensor):
            if v.device.type != "cuda":
                n += v.numel() * v.element_size()
        else:
            n += getattr(v, "nbytes", 0)
    return n


def _registry():
    from ..observability.registry import default_registry

    return default_registry()


class HotReloader:
    """Keep live engines at the model repository's newest version."""

    def __init__(self, repo, engines, consumer="server", poll_interval_s=0.5,
                 contract=None):
        self.repo = repo
        if isinstance(engines, dict):
            self.engines = dict(engines)
        else:
            engines = list(engines)
            self.engines = {e.name: e for e in engines}
        if not self.engines:
            raise ValueError("HotReloader needs at least one engine")
        self.consumer = str(consumer)
        self.poll_interval = float(poll_interval_s)
        self.contract = contract or _staleness.StalenessContract()
        self.applied_version = None
        self.applied_base = None
        self.applied_stamp = {}
        self.reloads = 0
        self.errors = 0
        # one record a version applied: version, kind, ms (read_ms of it
        # reading the files), bytes copied host to device
        self.history = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None

        reg = _registry()
        self._m_reloads = reg.counter(
            "online/reloads", "published versions applied to live engines"
        )
        self._m_errors = reg.counter(
            "online/reload_errors", "reload attempts that failed (retried)"
        )
        self._m_version = reg.gauge(
            "online/serving_version", "version live in the engines, by model"
        )
        self._m_lag_steps = reg.gauge(
            "online/serving_staleness_steps",
            "training steps the served version trails the newest published",
        )
        self._m_lag_secs = reg.gauge(
            "online/serving_staleness_seconds",
            "publisher-stamp seconds the served version trails the newest",
        )
        reg.gauge(
            "online/max_staleness_seconds",
            "the staleness contract's serving budget",
        ).set(self.contract.max_staleness_seconds)

    # ------------------------------------------------------------ lifecycle
    def start(self):
        """Begin the daemon poll loop (idempotent)."""
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="hot-reloader", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout=10.0):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout)

    def _loop(self):
        while not self._stop.wait(self.poll_interval):
            try:
                self.check_once()
            except Exception:
                # the poll loop must survive anything; check_once already
                # counted what it could
                self.errors += 1

    # -------------------------------------------------------------- polling
    def check_once(self):
        """One poll: read the pointer, apply anything new, ack, update the
        staleness gauges. Returns the number of versions applied (0 when
        already current or the repository is unreadable)."""
        with self._lock:
            return self._check_locked()

    def _check_locked(self):
        pointer = _publisher.read_latest(self.repo)
        if pointer is None:
            return 0
        latest = int(pointer["version"])
        stamp = dict(pointer.get("stamp") or {})
        if self.applied_version is not None and latest <= self.applied_version:
            self._set_gauges(stamp)
            return 0
        try:
            applied = self._apply_upto(pointer)
        except (IOError, OSError, KeyError, ValueError) as e:
            # publisher GC / a torn read underfoot: keep serving, retry
            self.errors += 1
            self._m_errors.inc()
            warnings.warn("hot reload of version %d failed (%r); retrying"
                          % (latest, e))
            return 0
        if applied:
            self.reloads += applied
            _staleness.write_ack(
                self.repo, self.consumer, self.applied_version,
                self.applied_stamp,
            )
            from ..observability import stepstats as _stepstats

            _stepstats.maybe_flush()
        self._set_gauges(stamp)
        return applied

    def _apply_upto(self, pointer):
        latest = int(pointer["version"])
        base_step = pointer.get("base_step")
        chain = async_ckpt.resolve_delta_chain(self.repo, upto_step=latest)
        if chain is None:
            raise IOError("no recoverable base in %s" % self.repo)
        rbase, _rdir, links = chain
        incremental = (
            self.applied_version is not None
            and self.applied_base == rbase
            and base_step == rbase
            and (self.applied_version == rbase
                 or any(s == self.applied_version for s, _ in links))
        )
        if incremental:
            pending = [(s, d) for s, d in links if s > self.applied_version]
            applied = 0
            for step, delta_dir in pending:
                self._apply_delta_live(step, delta_dir)
                applied += 1
            return applied
        # cold start / base changed / gap: full restore, one swap per engine
        t0 = time.perf_counter()
        loaded = async_ckpt.load_with_deltas(self.repo, upto_step=latest)
        if loaded is None:
            raise IOError("no loadable version in %s" % self.repo)
        t_read = time.perf_counter()
        step, arrays, info = loaded
        st = dict(info.get("stamp") or pointer.get("stamp") or {})
        h2d = 0
        for name, engine in self.engines.items():
            h2d += _h2d_bytes(engine, arrays)
            # force-kept root span: hot swaps are rare, operator-relevant
            # events — every one lands in the trace shards regardless of
            # the sampling rate, so a latency blip can be lined up with
            # the param swap that caused it
            with _tracing.tracer().start_span(
                "reloader.swap", kind="base", engine=name, version=step,
                arrays=len(arrays),
            ).force_keep():
                engine.set_params(arrays, version=step, stamp=st)
        self.applied_version = int(step)
        self.applied_base = info["base_step"]
        self.applied_stamp = st
        self._m_reloads.inc()
        self._record(int(step), "base", t0, t_read, h2d)
        return 1

    def _apply_delta_live(self, step, delta_dir):
        """Replay one delta onto each engine's live tensors: dense params
        swap wholesale and touched table rows scatter into the table the
        engine serves (set_params' `rows`), one set_params per engine."""
        t0 = time.perf_counter()
        h2d = 0
        manifest, dense, rows = async_ckpt.read_delta(delta_dir)
        t_read = time.perf_counter()
        st = dict(manifest.get("stamp") or {})
        for name, engine in self.engines.items():
            for n in rows:
                cur = engine.scope.vars.get(n)
                if cur is None:
                    raise KeyError("delta %s updates rows of %r, absent from engine %r"
                                   % (delta_dir, n, name))
                if list(cur.shape) != list(manifest["arrays"][n]["shape"]):
                    raise ValueError("delta %s: table %r is %s on disk but %s live"
                                     % (delta_dir, n, manifest["arrays"][n]["shape"],
                                        list(cur.shape)))
            h2d += _h2d_bytes(engine, dense, rows)
            with _tracing.tracer().start_span(
                "reloader.swap", kind="delta", engine=name, version=step,
                arrays=len(dense) + len(rows),
            ).force_keep():
                engine.set_params(dense, version=step, stamp=st, rows=rows)
            self.applied_stamp = st
        self.applied_version = int(step)
        self.applied_base = manifest["base_step"]
        self._m_reloads.inc()
        self._record(int(step), "delta", t0, t_read, h2d)

    def _record(self, version, kind, t0, t_read, h2d):
        self.history.append({
            "version": version, "kind": kind,
            "ms": (time.perf_counter() - t0) * 1e3, "read_ms": (t_read - t0) * 1e3,
            "h2d_bytes": int(h2d),
        })

    # -------------------------------------------------------------- gauges
    def _set_gauges(self, latest_stamp):
        served = dict(self.applied_stamp or {})
        lag_steps = max(
            0,
            int(latest_stamp.get("train_step", 0))
            - int(served.get("train_step", 0)),
        ) if served else 0
        lag_secs = max(
            0.0,
            float(latest_stamp.get("wall_time", 0.0))
            - float(served.get("wall_time", 0.0)),
        ) if served else 0.0
        for name, engine in self.engines.items():
            self._m_version.set(
                float(getattr(engine, "model_version", 0) or 0), model=name
            )
            self._m_lag_steps.set(float(lag_steps), model=name)
            self._m_lag_secs.set(lag_secs, model=name)

    def stats(self):
        return {
            "applied_version": self.applied_version,
            "applied_base": self.applied_base,
            "reloads": self.reloads,
            "errors": self.errors,
            "consumer": self.consumer,
        }
