"""PyReader: decoupled async input pipeline with device-side prefetch.

Reference analog: layers/io.py:633 py_reader + operators/reader/
lod_tensor_blocking_queue.h + buffered_reader (double-buffer prefetch to
device on a CUDA stream of its own). A feeder thread pulls numpy batches
from the user's reader and stages them on the device AHEAD of compute
(data.runtime.Stager: a copy into pinned host memory, then a copy to the
card queued on the reader's copy stream, an event recorded behind it), and
the executor pops the staged batch at each run, its stream made to wait on
that event — the host-to-device copy of batch k+1 overlaps step k's
compute, which is what the reference's double_buffer reader did. EOF
surfaces as EOFException caught by the train loop (reference
fluid_benchmark.py:244-246 pattern).

Batches are staged on `place` (CUDAPlace(0) when None; CPUPlace() for the
CPU), resolved when the reader starts.
"""

import queue as Queue
import threading
import time

import numpy as np

__all__ = ["PyReader", "EOFException", "bf16_wire"]


class EOFException(Exception):
    """reference core.EOFException"""


class _EndOfEpoch:
    pass


class _FeederError:
    """Feeder-thread exception carrier: re-raised in the consumer so a
    crashing reader/assembly/device_put surfaces instead of reading as a
    clean EOF (which would silently truncate an epoch)."""

    def __init__(self, exc):
        self.exc = exc


def bf16_wire(value):
    """float values as the bf16 wire field: uint16, the upper half of each
    f32 after round-to-nearest-even (NaN kept quiet), as ml_dtypes rounds;
    staged, it is viewed as torch.bfloat16."""
    bits = np.ascontiguousarray(np.asarray(value, dtype=np.float32)).view(np.uint32)
    rounded = (bits + (np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1)))) >> 16
    nan = np.isnan(bits.view(np.float32))
    rounded = np.where(nan, (bits >> 16) | np.uint32(0x40), rounded)
    return rounded.astype(np.uint16)


def _convert_item(item, feed_names, batched_tuples, feeder):
    """One reader item -> {name: ndarray} feed dict. Module-level so the
    data-runtime decode workers run the SAME assembly the feeder thread
    would (and so it pickles under spawn)."""
    if isinstance(item, dict):
        return item
    if feeder is not None:
        return feeder.feed(item)
    if batched_tuples:
        # list of sample tuples (paddle.batch output) → column-stacked
        cols = list(zip(*item))
        return {
            name: np.stack([np.asarray(v) for v in col])
            for name, col in zip(feed_names, cols)
        }
    return dict(zip(feed_names, item))


def _apply_wire(feed, wire_dtypes):
    if not wire_dtypes:
        return feed
    out = {}
    for k, v in feed.items():
        want = wire_dtypes.get(k)
        if want is None:
            out[k] = v
        elif want == "bfloat16":
            out[k] = bf16_wire(v)
        else:
            out[k] = np.asarray(v).astype(want)
    return out


class _ShardedDecode:
    """decode_fn adapter handed to data.DataRuntime (num_workers mode).

    Two shapes of user reader:
    - shard factory ``reader(shard_id, num_shards)``: the reader opens only
      its slice of the dataset — true decode parallelism, the shape to use.
    - plain ``reader()`` (classic paddle reader): worker ``s`` iterates the
      full reader and keeps batches with ``index % num_shards == s``.
      Decode work is duplicated per worker, but batch assembly, wire-dtype
      conversion, shm packing, and device staging still parallelize, and
      the pipeline overlaps training — the reader must be deterministic
      (same batches in the same order every call), which the crash-replay
      contract requires anyway.

    Conversion (column stacking, DataFeeder, wire dtypes) runs HERE, in the
    worker process — the single-threaded feeder's biggest CPU costs move
    off the trainer. Nothing on this path touches CUDA.
    """

    def __init__(self, reader, factory, num_shards, feed_names,
                 batched_tuples, feeder, wire_dtypes):
        self.reader = reader
        self.factory = bool(factory)
        self.num_shards = int(num_shards)
        self.feed_names = list(feed_names)
        self.batched_tuples = bool(batched_tuples)
        self.feeder = feeder
        self.wire_dtypes = dict(wire_dtypes or {})

    def __call__(self, shard_id):
        if self.factory:
            items = self.reader(shard_id, self.num_shards)
        else:
            items = (
                item for i, item in enumerate(self.reader())
                if i % self.num_shards == shard_id
            )
        for item in items:
            yield _apply_wire(
                _convert_item(
                    item, self.feed_names, self.batched_tuples, self.feeder
                ),
                self.wire_dtypes,
            )


def _reader_is_shard_factory(reader):
    """True when ``reader`` accepts two positional args (shard_id,
    num_shards) — the shard-aware factory shape."""
    import inspect

    try:
        sig = inspect.signature(reader)
    except (TypeError, ValueError):
        return False
    pos = [
        p for p in sig.parameters.values()
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
    ]
    return len(pos) >= 2


class PyReader:
    def __init__(self, feed_names, capacity=4, return_device_arrays=True,
                 wire_dtypes=None, cache_epoch=False, place=None):
        """wire_dtypes: optional {feed_name: dtype} COMPACT WIRE FORMAT —
        batches are converted to this dtype on the host before staging, so
        the host->device transfer carries e.g. uint8 pixels (4x fewer bytes
        than f32) or bf16 activations (2x: the field travels as bf16_wire's
        uint16 and is staged as torch.bfloat16); the executor's feed buffer
        in the program's declared var dtype (executor._FeedStage) then makes
        the cast ON DEVICE.
        Reference analog: the double-buffer reader moves whatever dtype the
        LoDTensor holds (operators/reader/buffered_reader.h:48) — uint8
        image feeds + an in-graph cast were the reference's own trick for
        byte-bound input pipelines.

        cache_epoch: DEVICE-RESIDENT EPOCH CACHE. The first epoch runs the
        normal path (reader → host assembly → wire → device staging) and
        additionally retains every staged batch; once the epoch completes
        cleanly, later start() calls replay the cached device arrays through
        the same queue/feeder machinery with the reader, host assembly, and
        the host->device wire all out of the loop. For an image set that
        fits on the card this removes the wire-bound stage entirely.
        Caching keys off the staged arrays, so a new decorate_* call, a
        mid-epoch reset(), or a new place or placement invalidates it.

        place: the device batches are staged on (return_device_arrays),
        CUDAPlace(0) when None; resolved here, so a box without CUDA needs
        CPUPlace()."""
        from .place import to_device

        self.feed_names = list(feed_names)
        self.capacity = capacity
        self._cache_epoch = bool(cache_epoch)
        self._cache = None  # completed-epoch staged batches, serve order
        self._cache_staging = None  # the (device, placement) they were staged by
        self._cache_building = None
        self._staging_key = None  # the running epoch's (device, placement)
        self._wire_dtypes = {
            k: ("bfloat16" if str(v) in ("bfloat16", "torch.bfloat16") else v)
            for k, v in (wire_dtypes or {}).items()
        }
        self._bf16 = frozenset(k for k, v in self._wire_dtypes.items() if v == "bfloat16")
        self.device = to_device(place)
        self._queue = None
        self._thread = None
        self._stop = None
        self._paddle_reader = None
        self._feeder = None
        self._batched_tuples = False
        self._return_device = return_device_arrays
        self._started = False
        self._eof_deferred = False
        # epoch-generation tag: bumped by start()/reset()/decorate_*; any
        # state write-back from a feeder thread or the data runtime must
        # carry the CURRENT gen or be discarded (a stale thread finishing
        # its last batch after a reset+redecorate must not install its
        # epoch cache over the new dataset's)
        self._gen = 0
        # native data runtime (docs/data.md): decorate_*(num_workers=N)
        self._num_workers = None
        self._num_shards = None
        self._runtime = None
        self._runtime_active = False
        self._runtime_building = None
        self._device_sharding = None
        self._stager = None

    # --- decoration (reference py_reader.decorate_paddle_reader) ---
    def _decorate(self, reader, batched_tuples, num_workers, num_shards):
        self._gen += 1
        self._paddle_reader = reader
        self._batched_tuples = batched_tuples
        self._cache = None  # new dataset: cached epoch no longer valid
        self._num_workers = num_workers
        self._num_shards = num_shards
        if self._runtime is not None:  # new dataset: new worker pool
            self._runtime.close()
            self._runtime = None
            self._runtime_active = False
        return self

    def decorate_paddle_reader(self, reader, places=None, num_workers=None,
                               num_shards=None):
        """reader yields batches as lists of sample tuples (paddle.batch
        output). Without an attached DataFeeder the columns are stacked
        dense; ragged (LoD) fields need a DataFeeder (set_feeder).

        num_workers > 0 (or FLAGS_data_num_workers) routes decode through
        the native data runtime (paddle_tpu/data/, docs/data.md): reader
        batches decode in worker PROCESSES, cross into the trainer through
        a shared-memory ring, and device-stage ahead of compute. Pass a
        shard-aware factory ``reader(shard_id, num_shards)`` for true
        decode parallelism (num_shards defaults to 4x workers); a plain
        ``reader()`` falls back to round-robin batch mode (must be
        deterministic)."""
        return self._decorate(reader, True, num_workers, num_shards)

    def decorate_tensor_provider(self, reader, num_workers=None,
                                 num_shards=None):
        """reader yields dicts name->numpy directly (num_workers: as in
        decorate_paddle_reader)"""
        return self._decorate(reader, False, num_workers, num_shards)

    def decorate_batch_generator(self, reader, places=None, num_workers=None,
                                 num_shards=None):
        return self.decorate_tensor_provider(
            reader, num_workers=num_workers, num_shards=num_shards
        )

    def set_device_sharding(self, sharding):
        """The placement callable for staged batches — the ParallelExecutor
        installs its own here so a rank stages only its rows of the global
        batch. ``sharding(array) -> rows | None`` is evaluated per field
        (None: the whole field). A reader keeps the placement it started an
        epoch with until the next start() (staged_on)."""
        if sharding != self._device_sharding:
            self._device_sharding = sharding
            self._stager = None
            self._cache = None  # staged by the old placement
        return self

    def set_place(self, place):
        """Stage the epochs that start from now on `place` (the executor
        that runs a program reader's program sets it)."""
        from .place import to_device

        device = to_device(place)
        if device != self.device:
            self.device = device
            self._stager = None
            self._cache = None  # staged on the old device
        return self

    @property
    def staged_on(self):
        """(device, placement) the running epoch's batches are staged by
        ((None, None): host batches, whole), or None when the reader is not
        started. A puller holds it against its own device and placement
        (executor._reader_adapters)."""
        return self._staging_key if self._started else None

    def set_feeder(self, feeder):
        self._feeder = feeder
        return self

    @property
    def started(self):
        """Same contract as the program-registered reader handles
        (layers/io.py) so Executor.run can pull from either kind."""
        return self._started

    # --- lifecycle ---
    def _resolved_workers(self):
        if self._num_workers is not None:
            return int(self._num_workers)
        from .flags import get_flags

        return int(get_flags()["data_num_workers"])

    def _ensure_runtime(self, num_workers):
        if self._runtime is not None:
            return self._runtime
        from .data import DataRuntime

        factory = _reader_is_shard_factory(self._paddle_reader)
        if self._num_shards:
            num_shards = int(self._num_shards)
        else:
            # round-robin mode re-decodes the full reader per shard, so
            # exactly one shard per worker; a shard factory gets 4x for
            # work-stealing balance across uneven shards
            num_shards = 4 * num_workers if factory else num_workers
        decode = _ShardedDecode(
            self._paddle_reader, factory, num_shards, self.feed_names,
            self._batched_tuples, self._feeder, self._wire_dtypes,
        )
        self._runtime = DataRuntime(
            decode, num_shards=num_shards, num_workers=num_workers,
            stage_device=self._return_device,
            device_sharding=self._device_sharding,
            device_prefetch=max(2, int(self.capacity) // 2),
            name="pyreader", place=self.device,
        )
        self._runtime.bf16_fields = self._bf16
        return self._runtime

    def _staging(self):
        """The Stager of the thread path (one copy stream a reader)."""
        if self._stager is None:
            from .data.runtime import Stager

            self._stager = Stager(self.device, self._device_sharding, self._bf16)
        return self._stager

    def start(self):
        if self._started:
            raise RuntimeError("PyReader already started; call reset() first")
        if self._paddle_reader is None:
            raise RuntimeError("PyReader has no decorated reader")
        self._gen += 1
        self._started = True
        # a previous partial multi-step pull may have deferred its epoch-end
        # signal (executor._pull_reader_steps); a restart begins a new epoch
        self._eof_deferred = False
        # host batches (return_device_arrays=False) are whole and on no device
        staging = self._staging_key = ((self.device, self._device_sharding)
                                       if self._return_device else (None, None))
        if self._cache_staging != staging:
            self._cache = None  # installed by an epoch staged otherwise

        serve_cached = self._cache_epoch and self._cache is not None
        num_workers = self._resolved_workers()
        if num_workers > 0 and not serve_cached:
            # native data runtime path: no feeder thread in this process
            rt = self._ensure_runtime(num_workers)
            if rt.started:
                rt.reset()
            rt.device, rt.device_sharding = staging
            rt.start()
            self._runtime_active = True
            self._runtime_building = (
                [] if (self._cache_epoch and self._cache is None) else None
            )
            return
        self._runtime_active = False

        self._queue = Queue.Queue(maxsize=self.capacity)
        self._stop = threading.Event()

        # local refs: reset() swaps these out mid-epoch
        q = self._queue
        stop = self._stop
        gen = self._gen
        stage = self._staging() if self._return_device else None

        def _put(value):
            while not stop.is_set():
                try:
                    q.put(value, timeout=0.1)
                    return True
                except Queue.Full:
                    continue
            return False

        building = [] if (self._cache_epoch and self._cache is None) else None

        def fill():
            try:
                for item in self._paddle_reader():
                    if stop.is_set():
                        return
                    feed = _apply_wire(
                        _convert_item(
                            item, self.feed_names, self._batched_tuples,
                            self._feeder,
                        ),
                        self._wire_dtypes,
                    )
                    if stage is not None:
                        # stage on device ahead of compute (double buffering)
                        feed = stage(feed)
                    if building is not None:
                        building.append(feed)
                    if not _put(feed):
                        return
                # clean epoch end: the staged batches ARE the epoch — keep
                # them on device for wire-free replay next epoch. Gen guard:
                # a stale thread (reset()/decorate_* raced its final batch)
                # must not install its cache over the new dataset's.
                if building is not None and gen == self._gen and not stop.is_set():
                    self._cache, self._cache_staging = building, staging
            except BaseException as e:  # noqa: B036 — carried to the consumer
                _put(_FeederError(e))
                return
            finally:
                _put(_EndOfEpoch)

        def replay():
            # cached-epoch path: same queue/consumer machinery, but the
            # reader, host assembly, and host->device wire are not involved
            for feed in self._cache:
                if stop.is_set():
                    return
                if not _put(feed):
                    return
            _put(_EndOfEpoch)

        self._thread = threading.Thread(
            target=replay if serve_cached else fill, daemon=True
        )
        self._thread.start()

    def reset(self):
        """Stop the feeder thread / abort the runtime epoch (reference
        reader ResetAll); safe to call mid-epoch — staged batches are
        dropped, and the generation bump disowns any feeder thread that
        outlives the join (its late cache install / queue puts are
        discarded by the gen guard instead of leaking into the next
        epoch)."""
        self._gen += 1
        if self._runtime is not None and self._runtime_active:
            self._runtime.reset()
        self._runtime_active = False
        self._runtime_building = None
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5)
        self._started = False
        self._queue = None
        # pushed-back batches are staged state too: a batch returned by the
        # executor's mid-step-EOF pushback must not leak into the next
        # epoch (or a new decorated dataset)
        if getattr(self, "_pushed_back", None):
            self._pushed_back.clear()
        self._thread = None
        self._stop = None
        self._eof_deferred = False

    def _runtime_next(self):
        """num_workers mode: pull from the data runtime (which records its
        own feed-stall — no double counting with the thread path below)."""
        try:
            feed = self._runtime.next_batch()
        except EOFException:
            self._started = False
            if (
                self._runtime_building is not None
                and self._cache_epoch
                and self._cache is None
            ):
                self._cache = self._runtime_building
                self._cache_staging = self._staging_key
            self._runtime_building = None
            self._runtime_active = False
            raise
        if self._runtime_building is not None:
            self._runtime_building.append(feed)
        return feed

    def next_batch(self):
        if not self._started:
            raise RuntimeError("PyReader not started")
        pushed = getattr(self, "_pushed_back", None)
        if pushed:
            return pushed.popleft()
        if self._runtime_active:
            return self._runtime_next()
        # telemetry: time blocked on the staging queue is the input pipeline
        # failing to keep up (the device would idle exactly this long),
        # recorded as feed-stall on the next step (observability.stepstats;
        # only while telemetry is active)
        from .observability import stepstats

        if stepstats.active():
            t0 = time.perf_counter()
            item = self._queue.get()
            stepstats.collector().add_feed_stall((time.perf_counter() - t0) * 1e3)
        else:
            item = self._queue.get()
        if isinstance(item, _FeederError):
            self._started = False
            raise item.exc
        if item is _EndOfEpoch:
            self._started = False
            raise EOFException("reader exhausted")
        from .data.runtime import take

        return take(item)

    def push_back(self, batch):
        """Return a consumed batch to the FRONT of the queue. Used by the
        executor's multi-reader step assembly: when a sibling reader hits
        EOF mid-step, batches already pulled from the other readers for
        that incomplete step are pushed back rather than dropped."""
        import collections

        if not hasattr(self, "_pushed_back"):
            self._pushed_back = collections.deque()
        self._pushed_back.appendleft(batch)

    def drain(self):
        """Preemption half-close (the elastic Supervisor's): stop
        producers and discard every staged/in-flight batch, counting what
        was dropped so the exit is observable. The reader stays decorated —
        a resumed incarnation re-decorates and starts fresh; exactly-once
        delivery is the data CURSOR's job (epoch + batch index in the
        checkpoint manifest), not the queue's."""
        dropped = 0
        pushed = getattr(self, "_pushed_back", None)
        if pushed:
            dropped += len(pushed)
        q = self._queue
        if q is not None:
            try:
                dropped += q.qsize()
            except (NotImplementedError, OSError):
                pass
        self.reset()
        if dropped:
            from .resilience import health as _health

            _health.incr("drain_batches_dropped", dropped)
        return dropped

    def close(self):
        """Release the worker pool / shared-memory ring of num_workers
        mode (idempotent; the thread path has nothing to release)."""
        self.reset()
        if self._runtime is not None:
            self._runtime.close()
            self._runtime = None

    def __call__(self):  # iterate batches
        try:
            while True:
                yield self.next_batch()
        except EOFException:
            return
