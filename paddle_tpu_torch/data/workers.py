"""Multiprocess decode workers for the native data runtime.

Reference analog: executor_thread_worker.cc — the AsyncExecutor's N parser
threads, each consuming a slice of the file list into the native blocking
queue. Python decode code (JPEG decode, augmentation, tokenization) cannot
scale across threads under the GIL, so the port (as the JAX package) uses
PROCESSES: each worker pulls shard ids from its assignment queue, runs the
user's ``decode_fn(shard_id)`` (an iterable of ``{name: ndarray}`` batches),
and writes every batch straight into a shared-memory ring slab (ring.py) —
the trainer process never unpickles an array payload.

SIGKILL-safe plumbing: every queue here has exactly ONE producer and ONE
consumer, and free-slot handoff uses no queue at all. A multiprocessing
queue shared by several workers is a kill hazard — its reader lock is held
for the whole duration of a blocking ``get`` and its pipe write lock for
each feeder flush, so killing the holder starves every surviving worker
forever. Instead each worker has its own assignment queue and its own
ready (descriptor) queue, both discarded and rebuilt on respawn, and ring
slots are statically partitioned per worker: worker ``w`` owns slots
``w, w+N, w+2N, ...`` and claims a free one with a plain aligned store in
the ring's shared control block (ring.try_claim), the consumer releasing
with the mirror store. No cross-process lock exists on the hot path.

Crash isolation: a worker is expendable. The parent (runtime.py) polls
liveness; when a worker dies it drains the stragglers from the dead ready
queue, reclaims the worker's ring slots, respawns the process under the
resilience retry policy (resilience/retry.py) with fresh queues, and re-queues the in-flight
shards with ``skip`` = number of batches already received — decode is
required to be deterministic per shard, so the replay regenerates exactly
the batches that were lost, and the consumer's (shard, index) dedupe drops
any that survived in flight. Net effect: SIGKILL at any point loses zero
samples and duplicates none (tests/test_data_runtime.py).

fork vs spawn: both work (``FLAGS_data_start_method``). Workers never touch
CUDA: a decode function yields numpy arrays, and the trainer process stages
them on the card. Fork is the default and safe after the trainer has
initialised CUDA, since a forked worker makes no CUDA call (one that does
fails, as torch refuses CUDA in a process forked after its
initialisation, and the error reaches the consumer as the worker's decode
error); spawn re-imports and requires ``decode_fn`` to be picklable (a
module-level callable).
"""

import queue as _queue
import time
import traceback

__all__ = ["WorkerPool", "home_slots", "shutdown_sentinel"]


def shutdown_sentinel():
    return None  # the assignment-queue item that tells a worker to exit


def home_slots(worker_id, num_workers, ring_slots):
    """The ring slots worker ``worker_id`` owns (static partition)."""
    return list(range(worker_id, ring_slots, num_workers))


class _Stop(Exception):
    pass


def _claim_slot(ring, slots, worker_id, stop_ev):
    """Spin over the worker's home slots until one is free. Lock-free: the
    consumer's release (owner := -1) is the only thing being waited on."""
    while True:
        for slot in slots:
            if ring.try_claim(slot, worker_id):
                return slot
        if stop_ev.is_set():
            raise _Stop()
        time.sleep(0.001)


def _worker_main(worker_id, num_workers, ring_name, decode_fn, shard_q,
                 ready_q, stop_ev, gen_cell):
    """Child-process entry point (module-level: picklable under spawn)."""
    from .ring import RingBuffer, SlabOverflowError

    ring = RingBuffer(0, 0, name=ring_name, create=False)
    slots = home_slots(worker_id, num_workers, ring.slots)
    try:
        while not stop_ev.is_set():
            try:
                item = shard_q.get(timeout=0.1)
            except _queue.Empty:
                continue
            if item is None:
                return
            shard_id, skip, gen = item
            ready_q.put(
                {"kind": "shard_start", "worker": worker_id, "shard": shard_id,
                 "gen": gen}
            )
            index = 0
            busy_ms = wait_ms = 0.0
            try:
                t0 = time.perf_counter()
                for batch in decode_fn(shard_id):
                    busy_ms += (time.perf_counter() - t0) * 1e3
                    if gen_cell.value != gen:
                        raise _Stop()  # epoch aborted: abandon the shard
                    if index >= skip:
                        tw = time.perf_counter()
                        slot = _claim_slot(ring, slots, worker_id, stop_ev)
                        wait_ms += (time.perf_counter() - tw) * 1e3
                        ring.begin_write(slot, worker_id)
                        try:
                            meta, nbytes = ring.pack(slot, batch)
                            seq = ring.commit(slot)
                        except BaseException:
                            # an aborted write may not leak the slot: make
                            # the seq even again and hand the slot back
                            ring.commit(slot)
                            ring.release(slot)
                            raise
                        ready_q.put(
                            {"kind": "batch", "worker": worker_id,
                             "shard": shard_id, "index": index, "slot": slot,
                             "seq": seq, "meta": meta, "bytes": nbytes,
                             "gen": gen, "busy_ms": busy_ms, "wait_ms": wait_ms}
                        )
                        busy_ms = wait_ms = 0.0
                    index += 1
                    t0 = time.perf_counter()
                ready_q.put(
                    {"kind": "shard_done", "worker": worker_id,
                     "shard": shard_id, "batches": index, "gen": gen}
                )
            except _Stop:
                continue
            except SlabOverflowError as e:
                ready_q.put(
                    {"kind": "error", "worker": worker_id, "shard": shard_id,
                     "gen": gen, "error": repr(e), "fatal": True,
                     "trace": traceback.format_exc()}
                )
            except BaseException as e:  # noqa: B036 — carried to the trainer
                ready_q.put(
                    {"kind": "error", "worker": worker_id, "shard": shard_id,
                     "gen": gen, "error": repr(e), "fatal": False,
                     "trace": traceback.format_exc()}
                )
    finally:
        ring.close()


class WorkerPool:
    """Owns the worker processes and their per-worker queues; the runtime
    owns all bookkeeping (shard accounting lives where the ready queues are
    drained). ``queue(w)`` / ``ready_queue(w)`` return the CURRENT queues —
    a respawn replaces both (the dead worker's queues may hold poisoned
    locks or truncated pickles, and anything still inside them was already
    re-queued or superseded by the parent's authoritative records)."""

    def __init__(self, ctx, num_workers, ring_name, decode_fn,
                 max_restarts=4):
        from ..resilience.retry import RetryPolicy

        self.ctx = ctx
        self.num_workers = int(num_workers)
        self.ring_name = ring_name
        self.decode_fn = decode_fn
        self.stop_ev = ctx.Event()
        self.gen_cell = ctx.Value("l", 0, lock=False)
        # respawn cadence rides the unified resilience policy: bounded
        # attempts with jittered exponential backoff per worker slot
        self.restart_policy = RetryPolicy(
            max_attempts=max(1, int(max_restarts)), base_delay=0.05,
            max_delay=2.0, deadline=None,
        )
        self.restarts = [0] * self.num_workers
        self.procs = [None] * self.num_workers
        self._shard_qs = [ctx.Queue() for _ in range(self.num_workers)]
        self._ready_qs = [ctx.Queue() for _ in range(self.num_workers)]

    def queue(self, worker_id):
        return self._shard_qs[worker_id]

    def ready_queue(self, worker_id):
        return self._ready_qs[worker_id]

    def _spawn(self, worker_id):
        p = self.ctx.Process(
            target=_worker_main,
            args=(worker_id, self.num_workers, self.ring_name, self.decode_fn,
                  self._shard_qs[worker_id], self._ready_qs[worker_id],
                  self.stop_ev, self.gen_cell),
            daemon=True,
            name="ptdata-worker-%d" % worker_id,
        )
        p.start()
        self.procs[worker_id] = p
        return p

    def start(self):
        for w in range(self.num_workers):
            self._spawn(w)

    def dead_workers(self):
        return [
            w for w, p in enumerate(self.procs)
            if p is not None and not p.is_alive()
        ]

    def respawn(self, worker_id):
        """Respawn a dead worker with FRESH queues, under the retry policy.
        Returns False when the slot has exhausted its restart budget (the
        runtime then surfaces a fatal error instead of spinning on a crash
        loop)."""
        self.restarts[worker_id] += 1
        attempt = self.restarts[worker_id]
        if attempt > self.restart_policy.max_attempts:
            return False
        old = self.procs[worker_id]
        if old is not None:
            old.join(timeout=1.0)
        self._shard_qs[worker_id] = self.ctx.Queue()
        self._ready_qs[worker_id] = self.ctx.Queue()
        time.sleep(self.restart_policy.backoff(attempt - 1))
        self._spawn(worker_id)
        return True

    def set_generation(self, gen):
        self.gen_cell.value = int(gen)

    def stop(self, join_timeout=5.0):
        self.stop_ev.set()
        for q in self._shard_qs:
            try:
                q.put_nowait(shutdown_sentinel())
            except Exception:  # noqa: BLE001 — queue may be full/closed
                pass
        deadline = time.time() + join_timeout
        for p in self.procs:
            if p is None:
                continue
            p.join(timeout=max(0.1, deadline - time.time()))
            if p.is_alive():
                p.terminate()
                p.join(timeout=1.0)
            if p.is_alive() and hasattr(p, "kill"):
                p.kill()
                p.join(timeout=1.0)
        self.procs = [None] * self.num_workers

    def pids(self):
        return [p.pid if p is not None else None for p in self.procs]
