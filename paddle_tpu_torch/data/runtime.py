"""DataRuntime: the trainer-side orchestrator of the native data runtime.

Paper/reference analog: the L2 AsyncExecutor/DataFeed layer — N parser
threads filling a native blocking queue the trainer pops. The composition
here (the JAX package's, with its device staging on a CUDA copy stream):

    decode workers (processes, workers.py)
        -> shared-memory ring slabs (ring.py; payload never pickled)
        -> drain thread: seqlock-validate, copy out, dedupe, release slot,
           stage: a copy into pinned host memory, then a copy to the card
           queued on the runtime's own copy stream (batch k+1 crosses while
           step k runs), an event recorded behind it
        -> bounded staged queue of device-resident batches
        -> next_batch() (Executor / ParallelExecutor / PyReader pull here):
           the caller's current stream waits on the batch's event, and each
           tensor is marked used on that stream (record_stream), so the
           caching allocator never hands out a buffer still in flight

Exactly-once contract: every (shard, batch index) is delivered at most once
(consumer-side dedupe) and at least once (authoritative parent-side shard
assignment: a dead worker's outstanding shards are re-queued with
``skip`` = batches already received, and decode is deterministic per
shard). SIGKILLing a worker mid-epoch therefore loses nothing and
duplicates nothing — tests/test_torch_data_runtime.py proves this with a
real kill.

Observability: the runtime feeds the metric registry
(observability/registry.py) — data/ring_occupancy, data/bytes_per_sec,
per-worker data/worker_busy_frac and data/batches_total,
data/worker_restarts. The JAX package also records the time next_batch
blocks as feed-stall in observability.stepstats, which the port has not
ported yet (ROADMAP A item 4).
"""

import collections
import queue as _queue
import threading
import time

import numpy as np
import torch

from ..place import to_device
from .ring import RingBuffer, TornSlotError
from .sharding import epoch_shard_order, host_shards
from .workers import WorkerPool

__all__ = ["DataRuntime"]

_OUTSTANDING_PER_WORKER = 2  # active shard + one prefetched assignment


def _flags():
    from ..flags import get_flags

    return get_flags()


def _registry():
    from ..observability.registry import default_registry

    return default_registry()


class _Eof:
    def __init__(self, gen):
        self.gen = gen


class _Error:
    def __init__(self, gen, exc):
        self.gen = gen
        self.exc = exc


def spec_bytes(batch_spec):
    """Packed slab bytes for a {name: (shape, dtype)} batch spec."""
    total = 0
    for shape, dtype in batch_spec.values():
        total += int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
    return total


class _Staged:
    """A batch on the card: its tensors and the event recorded on the copy
    stream behind their copies."""

    __slots__ = ("tensors", "event")

    def __init__(self, tensors, event):
        self.tensors = tensors
        self.event = event


def host_tensor(value, bf16=False):
    """A host value as a CPU tensor sharing its memory: a bf16 wire field
    (uint16, see py_reader.bf16_wire) viewed as torch.bfloat16."""
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
    return t.view(torch.bfloat16) if bf16 else t


class Stager:
    """Stages host batches ({name: ndarray}) on one device, from a producer
    thread. On the card each field is copied into pinned host memory and
    from there to the card by a copy queued on the stager's own stream; an
    event recorded behind the copies travels with the batch (take() makes
    the consumer's stream wait on it). Each field has a ring of RING pinned
    buffers of its own, made at its first batch (or a new shape) and
    refilled once the copy that last read the buffer has run: after its
    first batches the stager makes no pinned allocation, whose growth of
    the host allocator's pool (a 256 MB cudaHostAlloc for a 154 MB batch)
    stalls the steps it lands in. On the CPU the batch becomes CPU tensors.

    `placement(array)`: the rows of a field this process stages (the
    ParallelExecutor's: this rank's rows of the global batch), or None for
    the whole field; a ValueError it raises names the field and reaches the
    consumer in the batch's place. `bf16`: the names of the fields that
    travel as bf16 wire (uint16)."""

    RING = 2  # pinned buffers a field: one filled while the last one's copy runs

    def __init__(self, device, placement=None, bf16=()):
        self.device = torch.device(device)
        self.placement = placement
        self.bf16 = frozenset(bf16)
        self._stream = None
        self._pinned = {}  # name -> RING slots of (buffer, event of its last copy)
        self._turn = 0

    def _pinned_copy(self, name, t):
        """`t` copied into the field's next pinned buffer."""
        ring = self._pinned.setdefault(name, [None] * self.RING)
        held = ring[self._turn % self.RING]
        if held is not None and held[0].shape == t.shape and held[0].dtype == t.dtype:
            buf, copied = held
            copied.synchronize()
        else:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return buf.copy_(t)

    @property
    def key(self):
        """What the stager stages by: (device, placement, bf16 fields)."""
        return self.device, self.placement, self.bf16

    def __call__(self, feed):
        host = {}
        for k, v in feed.items():
            v = np.asarray(v)
            if self.placement is not None:
                try:
                    rows = self.placement(v)
                except ValueError as e:
                    raise ValueError("feed %r: %s" % (k, e)) from e
                if rows is not None:
                    v = rows
            host[k] = host_tensor(v, k in self.bf16)
        if self.device.type != "cuda":
            return host
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        out, pinned = {}, {}
        with torch.cuda.stream(self._stream):
            for k, t in host.items():
                pinned[k] = self._pinned_copy(k, t)
                out[k] = pinned[k].to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        for k, buf in pinned.items():
            self._pinned[k][self._turn % self.RING] = (buf, event)
        self._turn += 1
        return _Staged(out, event)


def take(batch):
    """What a consumer gets of a staged batch: on the card, the tensors,
    after the consumer's current stream was made to wait for their copies
    and each tensor was marked used on it; anything else as it is."""
    if not isinstance(batch, _Staged):
        return batch
    tensors = batch.tensors
    stream = torch.cuda.current_stream(next(iter(tensors.values())).device) if tensors else None
    if stream is not None:
        stream.wait_event(batch.event)
        for t in tensors.values():
            t.record_stream(stream)
    return dict(tensors)


class DataRuntime:
    def __init__(self, decode_fn, num_shards, num_workers=None,
                 ring_slots=None, slot_bytes=None, batch_spec=None,
                 num_hosts=1, host_id=0, seed=0, shuffle=True,
                 start_method=None, device_prefetch=None, stage_device=True,
                 device_sharding=None, max_worker_restarts=None, name="data",
                 place=None):
        """decode_fn(shard_id) -> iterable of {name: ndarray} batches; MUST
        be deterministic per shard_id (the crash-replay contract) and must
        not touch CUDA (it runs in worker processes). Under
        FLAGS_data_start_method=spawn it must also be picklable.

        place: where batches are staged (stage_device=True), CUDAPlace(0)
        when None. device_sharding: the placement callable
        `fn(array) -> rows | None` (Stager): the rows of each field this
        process stages. bf16_fields (an attribute): the fields that travel
        as bf16 wire (uint16) and are staged as torch.bfloat16. An epoch
        stages by the device, placement and bf16 fields it started with."""
        flags = _flags()
        self.decode_fn = decode_fn
        self.num_shards = int(num_shards)
        self.num_workers = int(num_workers or flags["data_num_workers"] or 2)
        self.ring_slots = int(
            ring_slots or flags["data_ring_slots"]
            or max(4, 2 * self.num_workers)
        )
        self.ring_slots = max(self.ring_slots, self.num_workers + 1)
        self._slot_bytes = slot_bytes
        self._batch_spec = batch_spec
        self.num_hosts = int(num_hosts)
        self.host_id = int(host_id)
        self.seed = int(seed)
        self.shuffle = bool(shuffle)
        self.prefetch = int(device_prefetch or flags["data_prefetch"] or 2)
        self.stage_device = bool(stage_device)
        self.device_sharding = device_sharding
        self.device = to_device(place)
        self.bf16_fields = ()
        self._stager = None
        self._start_method = start_method or flags["data_start_method"]
        self._max_restarts = (
            max_worker_restarts
            if max_worker_restarts is not None
            else flags["data_max_worker_restarts"]
        )
        self.name = name

        self._ctx = None
        self._ring = None
        self._pool = None
        self._drain = None
        self._lock = threading.RLock()
        self._gen = 0
        self._epoch = -1
        self._started = False
        self._closed = False
        self._staged = _queue.Queue(maxsize=max(1, self.prefetch))
        self._stats_t0 = time.perf_counter()
        self._stats_bytes = 0
        # per-epoch accounting (under _lock)
        self._pending = collections.deque()
        self._assigned = {}  # worker -> [shard ids outstanding, in order]
        self._received = {}  # shard -> contiguous received count
        self._remaining = set()

    # ------------------------------------------------------------------ setup
    def _ensure_pool(self):
        if self._pool is not None:
            return
        import multiprocessing as mp

        if self._slot_bytes is None:
            if self._batch_spec is not None:
                self._slot_bytes = spec_bytes(self._batch_spec)
            else:
                self._slot_bytes = self._probe_slot_bytes()
        # headroom: decode may bucket widths per batch; 25% + a page
        self._slot_bytes = int(self._slot_bytes * 1.25) + 4096
        self._ctx = mp.get_context(self._start_method)
        self._ring = RingBuffer(self.ring_slots, self._slot_bytes, create=True)
        self._pool = WorkerPool(
            self._ctx, self.num_workers, self._ring.name, self.decode_fn,
            max_restarts=self._max_restarts,
        )
        self._pool.start()
        self._drain = threading.Thread(
            target=self._drain_loop, daemon=True,
            name="ptdata-drain-%s" % self.name,
        )
        self._drain.start()

    def _probe_slot_bytes(self):
        """Decode ONE batch of the first shard in the parent to size the
        slabs. Costs one batch of decode; pass slot_bytes/batch_spec to
        skip (mandatory when batch sizes vary upward after the first)."""
        order = epoch_shard_order(self.num_shards, self.seed, 0, self.shuffle)
        mine = host_shards(order, self.num_hosts, self.host_id)
        if not mine:
            return 1 << 16
        for batch in self.decode_fn(mine[0]):
            total = sum(
                np.ascontiguousarray(v).nbytes for v in batch.values()
            )
            return max(total, 1 << 12)
        return 1 << 16

    # ------------------------------------------------------------- lifecycle
    @property
    def started(self):
        return self._started

    def start(self, epoch=None):
        """Begin an epoch: shuffle -> host shard -> assign to workers."""
        if self._closed:
            raise RuntimeError("DataRuntime is closed")
        if self._started:
            raise RuntimeError("epoch already running; call reset() first")
        self._ensure_pool()
        with self._lock:
            self._epoch = self._epoch + 1 if epoch is None else int(epoch)
            self._gen += 1
            self._pool.set_generation(self._gen)
            order = epoch_shard_order(
                self.num_shards, self.seed, self._epoch, self.shuffle
            )
            mine = host_shards(order, self.num_hosts, self.host_id)
            self._pending = collections.deque(mine)
            self._remaining = set(mine)
            self._received = {s: 0 for s in mine}
            self._assigned = {w: [] for w in range(self.num_workers)}
            self._started = True
            key = (self.device, self.device_sharding, frozenset(self.bf16_fields))
            if self.stage_device and (self._stager is None or self._stager.key != key):
                self._stager = Stager(*key)
            if not mine:
                self._staged.put(_Eof(self._gen))
            else:
                for w in range(self.num_workers):
                    self._top_up(w)
        try:
            _registry().counter(
                "data/epochs", "epochs started by the data runtime"
            ).inc()
        except Exception:  # noqa: BLE001 — telemetry must never break input
            pass

    def _top_up(self, worker):
        """Assign pending shards to ``worker`` until it has its outstanding
        quota. Caller holds _lock. Parent-side ``_assigned`` is the
        authoritative record — a dead worker's outstanding shards are
        recovered from here, never from worker acks."""
        q = self._pool.queue(worker)
        while self._pending and len(self._assigned[worker]) < _OUTSTANDING_PER_WORKER:
            shard = self._pending.popleft()
            self._assigned[worker].append(shard)
            q.put((shard, self._received.get(shard, 0), self._gen))

    def reset(self):
        """Abort the running epoch (PyReader.reset contract): stale
        generations drain harmlessly — workers abandon stale shards at the
        next batch, and the drain thread releases stale slots on sight."""
        with self._lock:
            self._gen += 1
            if self._pool is not None:
                self._pool.set_generation(self._gen)
            self._started = False
            self._pending.clear()
            self._remaining = set()
            self._assigned = {w: [] for w in range(self.num_workers)}
        while True:  # drop already-staged batches of the dead generation
            try:
                self._staged.get_nowait()
            except _queue.Empty:
                break

    def drain(self):
        """Preemption half-close (the elastic Supervisor's): abort
        the epoch, drop staged batches, and count the drop — then the
        caller close()s. Exactly-once across the preemption is carried by
        the checkpoint manifest's data cursor, not by preserving in-flight
        batches (a preempted host's ring is gone anyway)."""
        dropped = self._staged.qsize()
        self.reset()
        if dropped:
            from ..resilience import health as _health

            _health.incr("drain_batches_dropped", dropped)
        return dropped

    def close(self):
        if self._closed:
            return
        self.reset()
        self._closed = True
        if self._pool is not None:
            self._pool.stop()
        if self._drain is not None:
            self._drain.join(timeout=5)
        if self._ring is not None:
            self._ring.close()

    def __del__(self):  # best-effort: unlink shm segments
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass

    # -------------------------------------------------------------- consumer
    def next_batch(self):
        """Next staged batch; raises EOFException at epoch end."""
        from ..py_reader import EOFException

        if not self._started:
            raise RuntimeError("DataRuntime epoch not started")
        while True:
            try:
                item = self._staged.get(timeout=5.0)
            except _queue.Empty:
                if self._drain is not None and not self._drain.is_alive():
                    raise RuntimeError("data runtime drain thread died")
                continue
            if isinstance(item, (_Eof, _Error)) and item.gen != self._gen:
                continue  # stale epoch leftovers
            if isinstance(item, tuple) and item[0] != self._gen:
                continue
            break
        if isinstance(item, _Eof):
            self._started = False
            raise EOFException("data runtime epoch exhausted")
        if isinstance(item, _Error):
            self._started = False
            raise item.exc
        return take(item[1])

    def __call__(self):
        from ..py_reader import EOFException

        try:
            while True:
                yield self.next_batch()
        except EOFException:
            return

    # ----------------------------------------------------------- drain loop
    def _put_control(self, item):
        """Deliver an _Eof/_Error to the staged queue without deadlocking
        against a full queue: give up as soon as its generation is stale
        (next_batch drops stale control items anyway)."""
        while True:
            with self._lock:
                if item.gen != self._gen:
                    return
            try:
                self._staged.put(item, timeout=0.1)
                return
            except _queue.Full:
                continue

    def _stage(self, gen, feed):
        """Stage the batch on the device (Stager: on the card a copy on the
        runtime's copy stream, which overlaps the running step) and hand it
        to the bounded staged queue, staying responsive to generation bumps
        so an abort can't deadlock a full queue."""
        if self.stage_device:
            feed = self._stager(feed)
        while True:
            with self._lock:
                if gen != self._gen:
                    return
            try:
                self._staged.put((gen, feed), timeout=0.1)
                return
            except _queue.Full:
                continue

    def _drain_loop(self):
        """Round-robin over the per-worker ready queues. Each queue has one
        producer (its worker) and one consumer (this thread), so per-shard
        batch indices arrive in order by construction — and a message is
        always handled the moment it is fetched, BEFORE any supervisor
        work, so a recovery grace-drain can never leapfrog a held batch
        (the dedupe would drop it as a replay duplicate)."""
        last_liveness = 0.0
        while not self._closed:
            did_work = False
            for w in range(self.num_workers):
                try:
                    msg = self._pool.ready_queue(w).get_nowait()
                except _queue.Empty:
                    continue
                except Exception:  # noqa: BLE001 — poisoned/dead queue:
                    continue  # recovery will replace it
                did_work = True
                try:
                    self._handle(msg)
                except Exception as e:  # noqa: BLE001 — surface to trainer
                    with self._lock:
                        gen = self._gen
                    self._staged.put(_Error(gen, e))
            now = time.perf_counter()
            if now - last_liveness > 0.25:
                last_liveness = now
                try:
                    self._check_workers()
                    self._update_gauges()
                except Exception:  # noqa: BLE001 — supervisor must survive
                    pass
            if not did_work:
                time.sleep(0.005)

    def _handle(self, msg):
        kind = msg.get("kind")
        if kind == "batch":
            self._handle_batch(msg)
        elif kind == "shard_done":
            eof_gen = None
            with self._lock:
                if msg["gen"] != self._gen:
                    return
                shard, worker = msg["shard"], msg["worker"]
                if shard in self._remaining:
                    self._remaining.discard(shard)
                if shard in self._assigned.get(worker, []):
                    self._assigned[worker].remove(shard)
                self._top_up(worker)
                if self._started and not self._remaining and not self._pending:
                    eof_gen = self._gen
            if eof_gen is not None:
                self._put_control(_Eof(eof_gen))
        elif kind == "error":
            exc = RuntimeError(
                "data worker %s failed decoding shard %s: %s\n%s"
                % (msg["worker"], msg["shard"], msg["error"],
                   msg.get("trace", ""))
            )
            with self._lock:
                gen = self._gen
            if msg["gen"] == gen:
                self._put_control(_Error(gen, exc))
        # shard_start is informational (workers ack assignments); the
        # authoritative assignment record is parent-side _assigned

    def _handle_batch(self, msg):
        slot, seq = msg["slot"], msg["seq"]
        with self._lock:
            current = msg["gen"] == self._gen
            # per-shard indices arrive in order from a single live worker;
            # a crash-replay re-emits a contiguous prefix
            dup = current and msg["index"] < self._received.get(msg["shard"], 0)
        if not current or dup:
            self._ring.release(slot)
            if dup:
                try:
                    _registry().counter(
                        "data/batches_dropped_dup",
                        "crash-replay duplicates dropped by dedupe",
                    ).inc()
                except Exception:  # noqa: BLE001
                    pass
            return
        try:
            feed = self._ring.read(slot, msg["meta"], seq)
        except TornSlotError:
            # protocol kept us honest: never serve a torn slab. Do NOT
            # release — a torn seq means the slot was already reclaimed
            # and some writer may hold it now.
            return
        self._ring.release(slot)
        # count the batch as received only once it is safely copied out —
        # a torn read above must leave it claimable by the crash-replay
        with self._lock:
            if msg["gen"] != self._gen:
                return
            got = self._received.get(msg["shard"], 0)
            self._received[msg["shard"]] = max(got, msg["index"] + 1)
        self._account(msg)
        self._stage(msg["gen"], feed)

    def _account(self, msg):
        try:
            reg = _registry()
            w = str(msg["worker"])
            reg.counter(
                "data/batches_total", "batches delivered by decode workers"
            ).inc(1, worker=w)
            reg.counter(
                "data/bytes_total", "payload bytes through the shm ring"
            ).inc(msg["bytes"])
            busy, wait = msg.get("busy_ms", 0.0), msg.get("wait_ms", 0.0)
            if busy + wait > 0:
                reg.gauge(
                    "data/worker_busy_frac",
                    "decode time / (decode + ring-wait) per worker",
                ).set(busy / (busy + wait), worker=w)
            self._stats_bytes += msg["bytes"]
        except Exception:  # noqa: BLE001
            pass

    def _update_gauges(self):
        reg = _registry()
        reg.gauge(
            "data/ring_occupancy",
            "fraction of ring slots claimed (mid-write or undelivered)",
        ).set(len(self._ring.owned_slots()) / float(self.ring_slots))
        dt = time.perf_counter() - self._stats_t0
        if dt >= 1.0:
            reg.gauge(
                "data/bytes_per_sec", "shm ring payload throughput"
            ).set(self._stats_bytes / dt)
            self._stats_t0 = time.perf_counter()
            self._stats_bytes = 0

    def _check_workers(self):
        if self._pool is None:
            return
        for w in self._pool.dead_workers():
            self._recover_worker(w)

    def _recover_worker(self, w):
        """A worker died. Recover in this order: (1) drain its straggler
        messages, (2) re-queue its outstanding shards with skip=received,
        (3) reclaim/scavenge its ring slots, (4) respawn under the retry
        policy. docs/data.md#crash-isolation walks through why this is
        exactly-once."""
        try:
            from ..resilience import health

            health.incr("data_worker_death")
        except Exception:  # noqa: BLE001
            pass
        try:
            _registry().counter(
                "data/worker_restarts", "decode worker respawns"
            ).inc()
        except Exception:  # noqa: BLE001
            pass
        # (1) grace-drain: messages the dead worker flushed before dying.
        # Only ITS ready queue is read (per-worker queues), so the live
        # workers' streams cannot be reordered by this drain; the queue is
        # discarded on respawn, so nothing can straggle in later.
        rq = self._pool.ready_queue(w)
        while True:
            try:
                msg = rq.get(timeout=0.1)
            except _queue.Empty:
                break
            except Exception:  # noqa: BLE001 — truncated pickle etc.
                break
            try:
                self._handle(msg)
            except Exception:  # noqa: BLE001
                break
        with self._lock:
            # (2) outstanding shards back to pending, front of the line
            for shard in reversed(self._assigned.get(w, [])):
                if shard in self._remaining:
                    self._pending.appendleft(shard)
            self._assigned[w] = []
            # (3) the dead worker's ring slots — mid-write (seq forced
            # even; no descriptor carries the new seq) and committed-but-
            # undelivered alike — go back to claimable
            self._ring.reclaim_dead([w])
            # (4) respawn with fresh queues (the old ones may hold a
            # poisoned lock or a half-written pickle)
            ok = self._pool.respawn(w)
            if ok:
                for ww in range(self.num_workers):
                    self._top_up(ww)
            exhausted = not ok and self._started
            gen = self._gen
        if exhausted:
            self._put_control(_Error(gen, RuntimeError(
                "data worker %d exceeded its restart budget (%s)"
                % (w, self._pool.restart_policy.max_attempts)
            )))
