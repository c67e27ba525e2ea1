"""Serving engine: one saved model, a bounded set of batch-bucketed
variants, no build on the hot path (the torch counterpart of
paddle_tpu/serving/engine.py).

The engine:

- loads a `save_inference_model` directory (io.py; the JAX package's
  format) into a private Scope on its device, the card unless the caller
  passes CPUPlace();
- pads every request's batch dim to a small set of bucket sizes and slices
  outputs back to the true rows, so the number of variants is bounded by the
  bucket grid, never by traffic. Every op of a forward program is
  row-independent along the batch dim, so padded rows never touch real rows;
- builds one variant per padded feed signature through
  executor.aot_serve_lowering (parameters passed as arguments, so a hot swap
  never rebuilds); warmup() builds every bucket's variant up front;
- with precision="int8", runs the inference_int8 pass pipeline
  (passes/quant.py) over the loaded program first: calibration on the
  given representative feeds, int8 weights frozen into the private scope,
  static activation scales, and the int8 chains tagged for the quant GEMM
  kernel (ops/fused.py gemm_int8), which runs them on the card.

Declared-dynamic TRAILING dims (-1 in a feed's var shape, such as sequence
lengths) are never padded: each distinct trailing shape gets its own
variant (the JAX engine's default "exact" policy).

Not ported yet: the JAX engine's "pow2" trailing_pad policy, the
persistent compile cache (`cache_dir` raises, as in the GenerationEngine)
and the FLAGS_static_verify gate, which waits for the analysis checkers.
"""

import threading
import time

import numpy as np
import torch

from .. import flags as _flags
from .. import io as _io
from ..executor import Executor, Scope, aot_serve_lowering, scope_guard
from ..observability import tracing as _tracing

__all__ = ["ServingEngine", "DEFAULT_BATCH_BUCKETS"]

DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32)

# batch-fill ratio buckets: 0..1 in tenths
_FILL_BUCKETS = tuple(i / 10.0 for i in range(1, 11))


class ServingEngine:
    """Batch-bucketed forward executor for one saved model."""

    def __init__(self, model_dir, name=None, place=None, params_filename=None,
                 batch_buckets=None, cache_dir=None, precision="native",
                 calibration_feeds=None):
        if precision not in ("native", "int8"):
            raise ValueError("precision must be 'native' or 'int8', got %r" % (precision,))
        if precision == "int8" and not calibration_feeds:
            raise ValueError(
                "precision='int8' needs calibration_feeds (a list of representative "
                "feed dicts) to set activation scales"
            )
        if cache_dir is None:
            cache_dir = _flags.get_flags("serving_cache_dir")["serving_cache_dir"]
        if cache_dir:
            raise NotImplementedError(
                "cache_dir: the persistent compile cache is not ported; variants "
                "are built in-process at warmup()"
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

        # hot swap: set_params replaces the _ro/_mut dict OBJECTS under
        # _swap_lock and a call snapshots them under the same lock, so an
        # in-flight call finishes on the parameters it started with
        self.model_version = 0
        self.version_stamp = {}
        self._swap_lock = threading.Lock()
        with scope_guard(self.scope):
            _, self._ro, self._mut = aot_serve_lowering(
                program, self.feed_names, self.fetch_names, self.scope,
                pass_pipeline=self._pipeline,
            )

        buckets = batch_buckets or DEFAULT_BATCH_BUCKETS
        self.batch_buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.batch_buckets or self.batch_buckets[0] < 1:
            raise ValueError("batch_buckets must be positive: %r" % (buckets,))
        self.max_batch = self.batch_buckets[-1]

        self._variants = {}
        self._build_lock = threading.Lock()
        self.traces = 0  # variants built
        self.cache_hits = 0  # no compile cache: always 0

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
        self._m_traces = reg.counter(p + "/traces", "serving variants built")
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

    def _bucket_shape(self, shape):
        """Padded shape for one feed: batch dim -> bucket, trailing dims as
        they are."""
        return (self.bucket_batch(shape[0]),) + tuple(int(d) for d in shape[1:])

    def _feed_dtype(self, name, default=None):
        """numpy dtype the program declares for a feed (bfloat16 feeds travel
        as f32 and are cast on the device), or `default`."""
        dt = self._feed_dtypes.get(name)
        if dt is None:
            return default
        return np.dtype("float32") if dt == "bfloat16" else np.dtype(dt)

    # ---- variants ---------------------------------------------------------
    def _variant(self, sig):
        """The serve callable for one padded feed signature ((name, shape,
        dtype) per feed), built on first sight."""
        fn = self._variants.get(sig)
        if fn is not None:
            return fn
        with self._build_lock:
            fn = self._variants.get(sig)
            if fn is None:
                with scope_guard(self.scope):
                    fn, _, _ = aot_serve_lowering(
                        self.program, self.feed_names, self.fetch_names, self.scope,
                        pass_pipeline=self._pipeline,
                    )
                self.traces += 1
                self._m_traces.inc()
                self._variants[sig] = fn
                self._m_variants.set(len(self._variants))
            return fn

    def warmup(self, example_feed=None):
        """Build every batch bucket's variant, so the hot path never builds.
        Trailing dims come from the declared var shapes; models with dynamic
        (-1) trailing dims need `example_feed` to pin them. Returns the
        number of variants."""
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
            self._variant(tuple(sorted(
                (n, self._bucket_shape((b,) + shapes[n]), str(dtypes[n]))
                for n in self.feed_names
            )))
        return len(self._variants)

    # ---- hot swap ---------------------------------------------------------
    def set_params(self, updates, version=None, stamp=None):
        """Hot-swap parameter values without rebuilding or dropping requests.
        `updates` maps name -> new full array; names the lowering does not
        read are ignored. Values are cast to the stored dtype on the
        engine's device; a shape mismatch raises (a geometry change is a new
        model). Returns the number of arrays applied."""
        new_ro, new_mut = dict(self._ro), dict(self._mut)
        applied = 0
        for name, val in updates.items():
            tgt = new_ro if name in new_ro else (new_mut if name in new_mut else None)
            if tgt is None:
                continue
            old = tgt[name]
            if isinstance(val, torch.Tensor):
                arr = val.detach().to(device=old.device, dtype=old.dtype)
            else:
                arr = torch.from_numpy(np.array(val)).to(device=old.device, dtype=old.dtype)
            if tuple(arr.shape) != tuple(old.shape):
                raise ValueError(
                    "set_params(%r): shape %s != served shape %s — geometry changes need "
                    "a model reload, not a hot swap"
                    % (name, tuple(arr.shape), tuple(old.shape))
                )
            tgt[name] = arr
            self.scope.vars[name] = arr
            applied += 1
        with self._swap_lock:
            self._ro, self._mut = new_ro, new_mut
            self.model_version = int(version) if version is not None else self.model_version + 1
            self.version_stamp = dict(stamp or {})
            ver = self.model_version
        self._m_version.set(float(ver))
        self._m_swaps.inc()
        return applied

    # ---- serving ----------------------------------------------------------
    def run(self, feed):
        """Serve one feed dict (or a list zipped with feed_names): pad to the
        bucket, run its variant, slice outputs back to the true row count.
        Returns numpy arrays for the model's fetch targets."""
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
                part = self._run_bucket({k: a[lo:lo + self.max_batch] for k, a in arrays.items()})
                if outs is None:
                    outs = [[o] for o in part]
                else:
                    for acc, o in zip(outs, part):
                        acc.append(o)
            return [np.concatenate(acc) if np.ndim(acc[0]) else acc[-1] for acc in outs]
        return self._run_bucket(arrays)

    def _run_bucket(self, arrays):
        n = next(iter(arrays.values())).shape[0]
        padded = {}
        for name, a in arrays.items():
            dt = self._feed_dtype(name)
            a = np.ascontiguousarray(a) if dt is None else np.ascontiguousarray(a, dtype=dt)
            shape = self._bucket_shape(a.shape)
            if tuple(a.shape) != shape:
                buf = np.zeros(shape, dtype=a.dtype)
                buf[tuple(slice(0, d) for d in a.shape)] = a
                a = buf
            padded[name] = a
        bucket = next(iter(padded.values())).shape[0]
        fn = self._variant(tuple(sorted((nm, a.shape, str(a.dtype)) for nm, a in padded.items())))
        with self._swap_lock:
            ro, mut, ver = self._ro, self._mut, self.model_version
        span = _tracing.current()
        if span:
            span = span.child("engine.execute", bucket=bucket, rows=n,
                              precision=self.precision, model_version=ver)
        t0 = time.perf_counter()
        outs = fn(padded, ro, mut)
        outs = [o.detach().to("cpu").numpy() for o in outs]  # the call's device sync
        device_ms = (time.perf_counter() - t0) * 1e3
        span.tag(device_ms=round(device_ms, 3)).end()
        self._m_device_ms.observe(device_ms)
        self._m_rows.inc(n)
        self._m_padded.inc(bucket - n)
        self._m_fill.observe(n / float(bucket))
        return [o[:n] if np.ndim(o) and o.shape[0] == bucket else o for o in outs]

    def stats(self):
        """Variant and quantization accounting for benches and smoke runs."""
        out = {
            "variants": len(self._variants),
            "traces": self.traces,
            "cache_hits": self.cache_hits,
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
        return out
