"""Serving engine: one saved model, a bounded set of batch-bucketed
variants, no preparation or capture on the hot path (the torch counterpart
of paddle_tpu/serving/engine.py).

The engine:

- loads a `save_inference_model` directory (io.py; the JAX package's
  format) into a private Scope on its device, the card unless the caller
  passes CPUPlace(); with FLAGS_static_verify on, the loaded program is
  linted in serving mode first, so a mis-exported model names its defect
  at load (analysis/verify.py);
- pads every request's batch dim to a small set of bucket sizes and slices
  outputs back to the true rows, so the number of variants is bounded by
  the bucket grid, never by traffic. Every op of a forward program is
  row-independent along the batch dim, so padded rows never touch real
  rows;
- prepares one variant per padded feed signature: the program pruned to
  the fetches and the shape facts the meta-tensor analysis derives at
  that signature (`traces` counts these preparations), loaded instead
  from the persistent compile cache when `cache_dir` (or
  FLAGS_serving_cache_dir) holds it (`cache_hits`; serving/compile_cache.py);
- serves each variant through executor.aot_serve_lowering, parameters
  passed as arguments. On the card a variant is a CUDA graph in the
  engine's own graph pool: run op by op at its first call, captured at its
  second, replayed after (`stats()["captures"]`), so warmup(), which calls
  every bucket twice on zero feeds, leaves every bucket captured;
  `run_op_by_op` serves the same variant op by op for comparisons, never
  as a fallback;
- with precision="int8", runs the inference_int8 pass pipeline
  (passes/quant.py) over the loaded program first: calibration on the
  given representative feeds, int8 weights frozen into the private scope,
  static activation scales, and the int8 chains tagged for the quant GEMM
  kernel (ops/fused.py gemm_int8), which runs them on the card.

Hot swap: set_params copies each new value into the served tensor itself,
once, under the lock every call holds over its replay and its fetch's copy
to the host. The graphs read those tensors, so no later call copies a
parameter, and an in-flight call finishes on the parameters it started
with: its reply's version (last_served_version) names them. Its `rows`
scatters a table's changed rows into the served table in place (an
online delta), so only those rows cross to the card.

Declared-dynamic TRAILING dims (-1 in a feed's var shape, such as sequence
lengths) follow the `trailing_pad` policy: "exact" (default) never pads
them, so each distinct trailing shape gets its own variant; "pow2" pads
them to the next power of two with zeros, which is sound ONLY for models
proven padding-invariant along those dims (the caller asserts that proof;
the engine cannot check it).
"""

import json
import threading
import time

import numpy as np
import torch

from .. import flags as _flags
from .. import framework
from .. import io as _io
from ..executor import Executor, Scope, aot_serve_lowering, scope_guard
from ..observability import tracing as _tracing
from . import compile_cache as _cc

__all__ = ["ServingEngine", "DEFAULT_BATCH_BUCKETS"]

DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32)

# batch-fill ratio buckets: 0..1 in tenths
_FILL_BUCKETS = tuple(i / 10.0 for i in range(1, 11))


def _next_pow2(n):
    n = max(int(n), 1)
    p = 1
    while p < n:
        p *= 2
    return p


def prepare_variant(program, feed_avals, fetch_names, scope, state_names=()):
    """The artifact of one serving variant: `program` pruned to the ops the
    fetches (and the written `state_names`) need, as io.py's program dict,
    and {name: [shape, dtype]} of every variable the meta-tensor analysis
    (analysis/dataflow.py) pins at the feed shapes `feed_avals` ({name:
    (shape, dtype str)}). JSON-normal, so a cache hit and a fresh
    preparation serve the same program."""
    from ..analysis import VarFact, analyze_program

    pruned = program._prune(list(fetch_names) + list(state_names))
    facts = analyze_program(
        pruned, list(feed_avals), list(fetch_names), scope=scope, mode="serving",
        feed_facts={n: VarFact(shape=tuple(s), dtype=str(d)) for n, (s, d) in feed_avals.items()},
    ).facts
    doc = {
        "program": pruned.to_dict(),
        "facts": {n: [list(f.concrete_shape()), f.dtype] for n, f in sorted(facts.items())
                  if f.known and -1 not in f.concrete_shape()},
    }
    return json.loads(json.dumps(doc, default=_cc._jsonable))


class _Variant:
    """One prepared bucket: its serve callable and the fetch facts its
    first call is held to."""

    __slots__ = ("fn", "fetch_facts", "checked")

    def __init__(self, fn, fetch_facts):
        self.fn = fn
        self.fetch_facts = fetch_facts
        self.checked = False


class ServingEngine:
    """Batch-bucketed forward executor for one saved model."""

    def __init__(self, model_dir, name=None, place=None, params_filename=None,
                 batch_buckets=None, cache_dir=None, trailing_pad="exact",
                 precision="native", calibration_feeds=None):
        if trailing_pad not in ("exact", "pow2"):
            raise ValueError("trailing_pad must be 'exact' or 'pow2', got %r" % (trailing_pad,))
        self.trailing_pad = trailing_pad
        if precision not in ("native", "int8"):
            raise ValueError("precision must be 'native' or 'int8', got %r" % (precision,))
        if precision == "int8" and not calibration_feeds:
            raise ValueError(
                "precision='int8' needs calibration_feeds (a list of representative "
                "feed dicts) to set activation scales"
            )
        self.precision = precision
        self.name = name or model_dir.rstrip("/").rsplit("/", 1)[-1]
        self.scope = Scope(place=place)
        with scope_guard(self.scope):
            program, feed_names, fetch_vars = _io.load_inference_model(
                model_dir, Executor(place), params_filename=params_filename
            )
        self.program = program
        self.feed_names = list(feed_names)
        self.fetch_names = [v.name for v in fetch_vars]
        self.fingerprint = _io.inference_model_fingerprint(model_dir)

        block = program.global_block()
        self._var_shapes = {}
        self._feed_dtypes = {}
        for n in self.feed_names:
            v = block.vars.get(n)
            if v is None:
                continue
            self._var_shapes[n] = tuple(v.shape) if v.shape is not None else None
            if v.dtype is not None:
                self._feed_dtypes[n] = v.dtype

        # FLAGS_static_verify: lint the loaded artifact as read (the
        # aot_serve_lowering gate re-verifies what is served), so a corrupt
        # or mis-exported model names its defect at load
        from ..analysis import maybe_static_verify

        maybe_static_verify(
            program, self.feed_names, self.fetch_names, scope=self.scope,
            mode="serving", where="serving:%s" % self.name,
        )
        self.quant_results = None
        if precision == "int8":
            # the pipeline runs here, with the feeds calibration needs; the
            # rewritten program is then lowered verbatim ("off")
            from ..passes.manager import PassManager

            program = PassManager("inference_int8").apply(
                program, scope=self.scope, feed_names=self.feed_names,
                fetch_names=self.fetch_names,
                attrs={"calibrate": {"feeds": list(calibration_feeds)}},
            )
            self.program = program
            self.quant_results = {
                k: program._pass_results.get(k)
                for k in ("calibrate", "quantize_serving", "fuse_quant_gemm")
            }
            if not (self.quant_results["quantize_serving"] or {}).get("quantized"):
                raise ValueError(
                    "precision='int8': no mul op quantized — the model has no fc/mul "
                    "layers with scope weights and calibrated inputs (ranges recorded: %d)"
                    % len((self.quant_results["calibrate"] or {}).get("ranges", {}))
                )
        self._pipeline = "off" if precision == "int8" else "inference"

        # hot swap: set_params copies into the tensors of _ro / _mut under
        # _swap_lock, which every call holds over its replay and fetch copy
        self.model_version = 0
        self.version_stamp = {}
        self._swap_lock = threading.Lock()
        self._served_tls = threading.local()
        with scope_guard(self.scope):
            _, self._ro, self._mut = aot_serve_lowering(
                program, self.feed_names, self.fetch_names, self.scope,
                pass_pipeline=self._pipeline,
            )
        # the memory pool every variant's graph captures into (one call at a
        # time under _swap_lock, so one pool holds one call's intermediates);
        # no other engine shares it
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.scope.device.type == "cuda" else None)

        buckets = batch_buckets or DEFAULT_BATCH_BUCKETS
        self.batch_buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.batch_buckets or self.batch_buckets[0] < 1:
            raise ValueError("batch_buckets must be positive: %r" % (buckets,))
        self.max_batch = self.batch_buckets[-1]

        if cache_dir is None:
            cache_dir = _flags.get_flags("serving_cache_dir")["serving_cache_dir"]
        self.cache = _cc.CompileCache(cache_dir) if cache_dir else None

        self._variants = {}
        self._build_lock = threading.Lock()
        self.traces = 0  # variants prepared (compile-cache misses)
        self.cache_hits = 0  # variants loaded from the compile cache

        from ..observability import registry as _registry

        reg = _registry.default_registry()
        p = "serving/%s" % self.name
        self._m_device_ms = reg.histogram(
            p + "/device_ms", "per-engine-call wall ms, ending in the fetch copy"
        )
        self._m_fill = reg.histogram(
            p + "/batch_fill", "real rows / bucket rows per engine call", buckets=_FILL_BUCKETS,
        )
        self._m_rows = reg.counter(p + "/rows", "real request rows executed")
        self._m_padded = reg.counter(p + "/padded_rows", "padding rows added to fill buckets")
        self._m_traces = reg.counter(p + "/traces", "serving variants prepared (cache misses)")
        self._m_variants = reg.gauge(p + "/variants", "serving variants resident")
        self._m_version = reg.gauge(p + "/model_version", "live hot-swapped parameter version")
        self._m_swaps = reg.counter(p + "/hot_swaps", "set_params hot swaps applied")
        self._m_version.set(0.0)
        self._m_precision = reg.gauge(
            p + "/precision", "serving numeric tier (0 = native float, 1 = calibrated int8)",
        )
        self._m_precision.set(1.0 if self.precision == "int8" else 0.0)

    # ---- bucketing --------------------------------------------------------
    def bucket_batch(self, n):
        """Smallest configured bucket >= n (n > max_batch is chunked by
        run())."""
        for b in self.batch_buckets:
            if n <= b:
                return b
        return self.max_batch

    def _bucket_shape(self, name, shape):
        """Padded shape for one feed: batch dim -> bucket; trailing dims pass
        through exactly unless trailing_pad='pow2', in which case dims the
        program declares dynamic (-1) pad to the next power of two (sound
        only for padding-invariant models, see the module docstring)."""
        out = [self.bucket_batch(shape[0])]
        if self.trailing_pad == "pow2":
            declared = self._var_shapes.get(name)
            for i, d in enumerate(shape[1:], start=1):
                dd = declared[i] if declared is not None and len(declared) == len(shape) else None
                out.append(_next_pow2(d) if dd in (-1, None) else int(d))
        else:
            out.extend(int(d) for d in shape[1:])
        return tuple(out)

    def _feed_dtype(self, name, default=None):
        """numpy dtype the program declares for a feed (bfloat16 feeds travel
        as f32 and are cast on the device), or `default`."""
        dt = self._feed_dtypes.get(name)
        if dt is None:
            return default
        return np.dtype("float32") if dt == "bfloat16" else np.dtype(dt)

    # ---- variants ---------------------------------------------------------
    def _variant(self, sig):
        """The variant of one padded feed signature ((name, shape, dtype) per
        feed), prepared (or loaded from the compile cache) on first sight."""
        v = self._variants.get(sig)
        if v is not None:
            return v
        with self._build_lock:
            v = self._variants.get(sig)
            if v is not None:
                return v
            avals = {n: (shape, dt) for n, shape, dt in sig}

            def build():
                self.traces += 1
                self._m_traces.inc()
                return prepare_variant(self.program, avals, self.fetch_names, self.scope,
                                       state_names=sorted(self._mut))

            if self.cache is not None:
                # an int8 variant keys on its precision: the rewritten
                # program shares the model dir's fingerprint
                ck = _cc.variant_key(
                    self.fingerprint, avals, self.fetch_names,
                    geometry={"precision": self.precision} if self.precision != "native"
                    else None,
                )
                artifact, hit = self.cache.get_or_build(ck, build, meta={
                    "model": self.name,
                    "feeds": {n: [list(s), d] for n, (s, d) in avals.items()},
                    "fetches": self.fetch_names,
                })
                if hit:
                    self.cache_hits += 1
            else:
                artifact = build()
            served = framework.Program.from_dict(artifact["program"])
            with scope_guard(self.scope):
                fn, _, _ = aot_serve_lowering(
                    served, self.feed_names, self.fetch_names, self.scope,
                    pass_pipeline="off", graph_pool=self._graph_pool,
                )
            v = _Variant(fn, [artifact["facts"].get(n) for n in self.fetch_names])
            self._variants[sig] = v
            self._m_variants.set(len(self._variants))
            return v

    def _signature(self, padded):
        return tuple(sorted((n, tuple(a.shape), str(a.dtype)) for n, a in padded.items()))

    def warmup(self, example_feed=None):
        """Prepare every batch bucket's variant and, on the card, run it
        twice on zero feeds (op by op, then captured), so the hot path never
        prepares or captures. Trailing dims come from the declared var
        shapes; models with dynamic (-1) trailing dims need `example_feed`
        to pin them. Returns the number of variants."""
        shapes, dtypes = {}, {}
        for n in self.feed_names:
            if example_feed is not None and n in example_feed:
                ex = np.asarray(example_feed[n])
                shapes[n] = tuple(ex.shape[1:])
                dtypes[n] = self._feed_dtype(n, default=ex.dtype)
                continue
            declared = self._var_shapes.get(n)
            if declared is None or any(d in (-1, None) for d in declared[1:]):
                raise ValueError(
                    "feed %r has dynamic non-batch dims %r: warmup needs an example_feed "
                    "to pin them" % (n, declared)
                )
            shapes[n] = tuple(int(d) for d in declared[1:])
            dtypes[n] = self._feed_dtype(n, default=np.dtype("float32"))
        for b in self.batch_buckets:
            zeros = {n: np.zeros(self._bucket_shape(n, (b,) + shapes[n]), dtypes[n])
                     for n in self.feed_names}
            v = self._variant(self._signature(zeros))
            if self.scope.device.type == "cuda" and v.fn.captures() == 0:
                with self._swap_lock:
                    for _ in range(2):
                        v.fn(zeros, self._ro, self._mut)
                    torch.cuda.synchronize(self.scope.device)
        return len(self._variants)

    # ---- hot swap ---------------------------------------------------------
    def param_names(self):
        """Every live parameter/state name a hot swap may target."""
        with self._swap_lock:
            return sorted(set(self._ro) | set(self._mut))

    def set_params(self, updates, version=None, stamp=None, rows=None):
        """Hot-swap parameter values without preparing or capturing again,
        and without dropping requests. `updates` maps name -> new full
        array; `rows` maps a table's name -> (row ids, their new values),
        scattered into the served table in place; names the served block
        does not read are ignored. Values are cast to the served dtype on
        the engine's device; a shape mismatch, or row ids that repeat or
        fall outside the table, raise before anything is copied (a
        geometry change is a new model). Each distinct tensor is written
        once, under the call lock, so no call straddles two versions and no
        later replay copies state. Returns the number of arrays applied."""
        scatter = []
        for name, (ids, vals) in (rows or {}).items():
            held = self._ro.get(name, self._mut.get(name))
            if held is not None:
                scatter.append(_row_update(name, held, ids, vals))
        conv = {}
        for name, val in updates.items():
            held = self._ro.get(name, self._mut.get(name))
            if held is None:
                continue
            if isinstance(val, torch.Tensor):
                arr = val.detach().to(device=held.device, dtype=held.dtype)
            else:
                arr = torch.from_numpy(np.array(val)).to(device=held.device, dtype=held.dtype)
            if tuple(arr.shape) != tuple(held.shape):
                raise ValueError(
                    "set_params(%r): shape %s != served shape %s — geometry changes need "
                    "a model reload, not a hot swap"
                    % (name, tuple(arr.shape), tuple(held.shape))
                )
            conv[name] = (held, arr)
        with self._swap_lock:
            _copy_once(conv.values())
            _scatter_once(scatter)
            self.model_version = int(version) if version is not None else self.model_version + 1
            self.version_stamp = dict(stamp or {})
            ver = self.model_version
        self._m_version.set(float(ver))
        self._m_swaps.inc()
        return len(conv) + len(scatter)

    def last_served_version(self):
        """The model_version the CALLING thread's most recent engine call
        ran on (the batcher's dispatcher reads it right after run() to
        stamp each response)."""
        return getattr(self._served_tls, "version", self.model_version)

    # ---- serving ----------------------------------------------------------
    def run(self, feed):
        """Serve one feed dict (or a list zipped with feed_names): pad to the
        bucket, run its variant (a graph replay on the card), slice outputs
        back to the true row count. Returns numpy arrays for the model's
        fetch targets."""
        return self._serve(feed, eager=False)

    def run_op_by_op(self, feed):
        """run() through the same variants op by op: the comparison form of
        the card's graphs (and their reference in tests)."""
        return self._serve(feed, eager=True)

    def _serve(self, feed, eager):
        if isinstance(feed, (list, tuple)):
            feed = dict(zip(self.feed_names, feed))
        missing = [n for n in self.feed_names if n not in feed]
        if missing:
            raise ValueError("missing feeds: %s" % missing)
        unknown = sorted(set(feed) - set(self.feed_names))
        if unknown:
            raise ValueError("unknown feeds: %s (model takes %s)" % (unknown, self.feed_names))
        arrays = {n: np.asarray(feed[n]) for n in self.feed_names}
        rows = {np.shape(a)[0] if np.ndim(a) else 1 for a in arrays.values()}
        if len(rows) != 1:
            raise ValueError("feeds disagree on batch rows: %s"
                             % {n: np.shape(a) for n, a in arrays.items()})
        n = rows.pop()
        if n == 0:
            raise ValueError("empty batch")
        if n > self.max_batch:
            # oversize request: chunks of the largest bucket; batch-major
            # outputs concatenate, others keep the last chunk's value
            outs = None
            for lo in range(0, n, self.max_batch):
                part = self._run_bucket(
                    {k: a[lo:lo + self.max_batch] for k, a in arrays.items()}, eager)
                if outs is None:
                    outs = [[o] for o in part]
                else:
                    for acc, o in zip(outs, part):
                        acc.append(o)
            return [np.concatenate(acc) if np.ndim(acc[0]) else acc[-1] for acc in outs]
        return self._run_bucket(arrays, eager)

    def _run_bucket(self, arrays, eager):
        n = next(iter(arrays.values())).shape[0]
        padded = {}
        for name, a in arrays.items():
            dt = self._feed_dtype(name)
            a = np.ascontiguousarray(a) if dt is None else np.ascontiguousarray(a, dtype=dt)
            shape = self._bucket_shape(name, a.shape)
            if tuple(a.shape) != shape:
                buf = np.zeros(shape, dtype=a.dtype)
                buf[tuple(slice(0, d) for d in a.shape)] = a
                a = buf
            padded[name] = a
        bucket = next(iter(padded.values())).shape[0]
        outs = self._call(self._variant(self._signature(padded)), padded, n, bucket, eager)
        return [o[:n] if np.ndim(o) and o.shape[0] == bucket else o for o in outs]

    def _call(self, v, padded, n, bucket, eager):
        span = _tracing.current()
        t0 = time.perf_counter()
        with self._swap_lock:
            ver = self.model_version
            if span:
                span = span.child("engine.execute", bucket=bucket, rows=n,
                                  precision=self.precision, model_version=ver)
            outs = (v.fn.eager if eager else v.fn)(padded, self._ro, self._mut)
            # the copy back is the call's device sync, and ends before the
            # next replay of the pool (or a swap) can touch what it read
            outs = [o.detach().to("cpu").numpy() for o in outs]
            self._served_tls.version = ver
        device_ms = (time.perf_counter() - t0) * 1e3
        if not v.checked:
            # the prepared facts hold: a stale or foreign artifact would not
            got = [list(o.shape) for o in outs]
            want = [f[0] if f else list(o.shape) for f, o in zip(v.fetch_facts, outs)]
            if got != want:
                raise RuntimeError("serving variant of %s: fetch shapes %s, its prepared "
                                   "facts say %s" % (self.name, got, want))
            v.checked = True
        span.tag(device_ms=round(device_ms, 3)).end()
        self._m_device_ms.observe(device_ms)
        self._m_rows.inc(n)
        self._m_padded.inc(bucket - n)
        self._m_fill.observe(n / float(bucket))
        return outs

    def stats(self):
        """Variant, cache, capture and quantization accounting for benches
        and smoke runs: `captures` are the variants' CUDA graphs (0 on the
        CPU), `state_copies` the state tensors their replays had to copy
        into the captured ones."""
        out = {
            "variants": len(self._variants),
            "traces": self.traces,
            "cache_hits": self.cache_hits,
            "captures": sum(v.fn.captures() for v in self._variants.values()),
            "state_copies": sum(v.fn.state_copies() for v in self._variants.values()),
            "trailing_pad": self.trailing_pad,
            "model_version": self.model_version,
            "precision": self.precision,
        }
        if self.quant_results is not None:
            qs = self.quant_results.get("quantize_serving") or {}
            fq = self.quant_results.get("fuse_quant_gemm") or {}
            out["quant"] = {
                "quantized_muls": qs.get("quantized", 0),
                "weights_frozen": len(qs.get("weights_frozen", ())),
                "fused_groups": fq.get("groups", 0),
                "calibrated_ranges": len(
                    (self.quant_results.get("calibrate") or {}).get("ranges", {})
                ),
            }
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        return out


def _copy_once(pairs):
    """Copy each (held, new) pair's value into `held`, each distinct storage
    once (names of one engine, or variants of one pool, may share one)."""
    seen = set()
    with torch.no_grad():
        for held, arr in pairs:
            key = (held.device, held.data_ptr())
            if key in seen:
                continue
            seen.add(key)
            held.copy_(arr)


def _row_update(name, held, ids, vals):
    """(held, ids, rows) of one table's row scatter, on held's device and
    in its dtype; raises ValueError on ids that repeat or fall outside the
    table, and on rows of another width, before anything is copied."""
    ids = torch.as_tensor(ids, dtype=torch.int64).reshape(-1)
    vals = torch.as_tensor(vals)
    want = (ids.numel(),) + tuple(held.shape[1:])
    if tuple(vals.shape) != want:
        raise ValueError("set_params(rows=%r): rows of shape %s, want %s"
                         % (name, tuple(vals.shape), want))
    if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= held.shape[0]
                        or torch.unique(ids).numel() != ids.numel()):
        raise ValueError("set_params(rows=%r): row ids repeat or fall outside "
                         "the table's %d rows" % (name, held.shape[0]))
    return held, ids.to(held.device), vals.to(device=held.device, dtype=held.dtype)


def _scatter_once(triples):
    """index_copy_ each (held, ids, rows) triple's rows into `held`, each
    distinct storage once (unique ids: numpy's row assignment, bit for
    bit)."""
    seen = set()
    with torch.no_grad():
        for held, ids, vals in triples:
            key = (held.device, held.data_ptr())
            if key in seen:
                continue
            seen.add(key)
            held.index_copy_(0, ids, vals)
