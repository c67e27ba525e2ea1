"""Fault-tolerant dataset task master + client (the JAX package's
distributed/master.py: host-only, over the port's native.chunk_offsets).

Reference analog: go/master/service.go — partitions RecordIO chunks into
tasks (:69-106), dispatches them to trainers, re-dispatches tasks whose
owner times out (:311-341), discards tasks that failed `failure_max` times
(:368+), and snapshots state to etcd for recovery (:166-207); trainers use
python/paddle/v2/master/client.py (get_task / task_finished / task_failed).

Redesign: same task state machine, JSON-line protocol over TCP (the cluster
fabric here is plain sockets, like distributed/rpc.py), and the etcd snapshot
becomes an atomic local-file snapshot (the coordination service of a job is
per-job, not a shared etcd) — restart the master with
the same snapshot_path and pending/todo state is recovered.

Tasks are (path, begin, end) RecordIO byte ranges produced from
native.chunk_offsets, so a trainer reads its shard with
reader.creator.recordio(path, begin, end).
"""

import json
import os
import socket
import threading
import time
import warnings

from .. import native
from ..resilience import faults as _faults
from ..resilience import health as _health
from ..resilience.retry import DeadlineExceeded, RetryPolicy

__all__ = ["Master", "MasterClient"]


class _Task:
    def __init__(self, task_id, path, begin, end):
        self.id = task_id
        self.path = path
        self.begin = begin
        self.end = end
        self.failures = 0
        self.deadline = None  # set while dispatched

    def spec(self):
        return {"id": self.id, "path": self.path, "begin": self.begin, "end": self.end}


class Master:
    def __init__(
        self,
        endpoint="127.0.0.1:0",
        chunks_per_task=8,
        timeout_s=30.0,
        failure_max=3,
        snapshot_path=None,
    ):
        self.chunks_per_task = chunks_per_task
        self.timeout_s = timeout_s
        self.failure_max = failure_max
        self.snapshot_path = snapshot_path
        self.todo = []
        self.pending = {}  # id -> _Task
        self.done = []
        self.discarded = []
        self._lock = threading.Lock()
        self._next_id = 0
        host, _, port = endpoint.rpartition(":")
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host or "127.0.0.1", int(port)))
        self._sock.listen(64)
        self.endpoint = "%s:%d" % (host or "127.0.0.1", self._sock.getsockname()[1])
        self._closed = False
        self._recovered = False
        if snapshot_path and os.path.exists(snapshot_path):
            self._recovered = self._recover()

    # ------------------------------ dataset -------------------------------

    def set_dataset(self, paths):
        """Partition files into chunk-range tasks (service.go partition()).
        A no-op after snapshot recovery — the restart script re-runs this, and
        appending fresh tasks would re-train every finished shard (the
        reference's SetDataset skips when state was recovered the same way)."""
        with self._lock:
            if self._recovered:
                return
            for path in paths:
                offsets = native.chunk_offsets(path) + [os.path.getsize(path)]
                for i in range(0, len(offsets) - 1, self.chunks_per_task):
                    begin = offsets[i]
                    end = offsets[min(i + self.chunks_per_task, len(offsets) - 1)]
                    self.todo.append(_Task(self._next_id, path, begin, end))
                    self._next_id += 1
            self._snapshot_locked()

    # ----------------------------- state I/O ------------------------------

    def _snapshot_locked(self):
        if not self.snapshot_path:
            return
        state = {
            "next_id": self._next_id,
            "todo": [t.spec() | {"failures": t.failures} for t in self.todo]
            + [t.spec() | {"failures": t.failures} for t in self.pending.values()],
            "done": self.done,
            "discarded": self.discarded,
        }
        tmp = self.snapshot_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        # crash point between write and rename (resilience fault injection):
        # a master dying here leaves only the .tmp — the committed snapshot
        # is still whole, which is what _recover depends on
        _faults.crash("snapshot_crash", self.snapshot_path)
        os.replace(tmp, self.snapshot_path)  # atomic, like etcd txn

    def _recover(self):
        """Rebuild state from the snapshot. A corrupt/truncated snapshot
        (torn disk, a crash that outran the atomic rename discipline of an
        older layout) must not kill the master: start fresh with a warning —
        re-partitioning the dataset re-trains some shards, losing the whole
        job loses all of them. Returns True iff state was recovered."""
        try:
            with open(self.snapshot_path) as f:
                state = json.load(f)
            next_id = state["next_id"]
            todo = []
            for spec in state["todo"]:
                t = _Task(spec["id"], spec["path"], spec["begin"], spec["end"])
                t.failures = spec.get("failures", 0)
                todo.append(t)
            done = state["done"]
            discarded = state["discarded"]
        except (OSError, ValueError, KeyError, TypeError) as e:
            _health.incr("master_snapshot_corrupt")
            warnings.warn(
                "master snapshot %s unreadable (%r); starting fresh"
                % (self.snapshot_path, e)
            )
            return False
        self._next_id = next_id
        self.todo = todo
        self.done = done
        self.discarded = discarded
        return True

    # ----------------------------- scheduling -----------------------------

    def _requeue_timed_out_locked(self):
        now = time.monotonic()
        for tid in [t for t, task in self.pending.items() if task.deadline < now]:
            task = self.pending.pop(tid)
            task.failures += 1
            if task.failures >= self.failure_max:
                self.discarded.append(task.id)  # service.go failure_max drop
            else:
                self.todo.append(task)

    def _handle(self, req):
        op = req.get("op")
        with self._lock:
            self._requeue_timed_out_locked()
            if op == "get_task":
                if not self.todo:
                    if self.pending:
                        return {"status": "wait"}
                    return {"status": "no_more"}
                task = self.todo.pop(0)
                task.deadline = time.monotonic() + self.timeout_s
                self.pending[task.id] = task
                self._snapshot_locked()
                return {"status": "ok", "task": task.spec()}
            if op == "task_finished":
                task = self.pending.pop(int(req["id"]), None)
                if task is not None:
                    self.done.append(task.id)
                    self._snapshot_locked()
                return {"status": "ok"}
            if op == "task_failed":
                task = self.pending.pop(int(req["id"]), None)
                if task is not None:
                    task.failures += 1
                    if task.failures >= self.failure_max:
                        self.discarded.append(task.id)
                    else:
                        self.todo.append(task)
                    self._snapshot_locked()
                return {"status": "ok"}
            if op == "stats":
                return {
                    "status": "ok",
                    "todo": len(self.todo),
                    "pending": len(self.pending),
                    "done": len(self.done),
                    "discarded": len(self.discarded),
                }
        return {"status": "bad_request"}

    # ------------------------------ serving -------------------------------

    def start(self):
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        return self

    def _serve(self):
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _serve_conn(self, conn):
        try:
            f = conn.makefile("rw")
            for line in f:
                resp = self._handle(json.loads(line))
                if _faults.fires("master_conn_drop"):
                    # injected worker-facing failure: the request WAS handled
                    # but the reply is lost (the realistic half-failure — a
                    # dropped get_task reply leaves the task pending until
                    # the timeout re-queues it); client reconnect-retries
                    return
                f.write(json.dumps(resp) + "\n")
                f.flush()
        except (OSError, ValueError):
            pass
        finally:
            conn.close()

    def close(self):
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass


class MasterClient:
    """Trainer-side client (reference python/paddle/v2/master/client.py).

    Calls run under the unified RetryPolicy with reconnect: a master restart
    or a dropped connection is retried with backoff instead of killing the
    trainer. `op_timeout` bounds each connect/read (a HUNG master surfaces
    as a typed DeadlineExceeded), while `timeout` is the OVERALL retry
    budget per call — the two deadlines are deliberately distinct.

    Retry safety: every master op is either read-only (stats), idempotent
    (task_finished/task_failed re-apply as no-ops once the task left
    pending), or self-healing (a get_task whose reply is lost re-queues via
    the task timeout) — so blanket retry is correct here, unlike the RPC
    variable-send path."""

    def __init__(self, endpoint, timeout=60.0, op_timeout=10.0, max_attempts=5):
        host, _, port = endpoint.rpartition(":")
        self._addr = (host, int(port))
        self._op_timeout = op_timeout
        self._conn = None
        self._f = None
        self._lock = threading.Lock()
        self._retry = RetryPolicy(
            max_attempts=max_attempts,
            base_delay=0.05,
            max_delay=1.0,
            deadline=timeout,
        )
        self._connect()  # fail fast on a wrong endpoint, like before

    def _connect(self):
        self._conn = socket.create_connection(self._addr, timeout=self._op_timeout)
        self._f = self._conn.makefile("rw")

    def _drop_conn(self):
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
        self._conn = None
        self._f = None

    def _call(self, req):
        line = json.dumps(req) + "\n"

        def attempt():
            with self._lock:
                if self._f is None:
                    self._connect()
                try:
                    self._f.write(line)
                    self._f.flush()
                    resp = self._f.readline()
                except socket.timeout as e:
                    self._drop_conn()
                    raise DeadlineExceeded(
                        "master %s:%d: no reply within %.1fs"
                        % (self._addr + (self._op_timeout,))
                    ) from e
                except OSError:
                    self._drop_conn()
                    raise
                if not resp:  # EOF: master closed/dropped the connection
                    self._drop_conn()
                    raise ConnectionError("master closed connection")
                return json.loads(resp)

        return self._retry.call(
            attempt, on_retry=lambda _a, _e: _health.incr("master_retries")
        )

    def get_task(self, wait_s=0.2):
        """Blocks until a task is available; returns None when the dataset is
        exhausted (every task done or discarded)."""
        while True:
            resp = self._call({"op": "get_task"})
            if resp["status"] == "ok":
                return resp["task"]
            if resp["status"] == "no_more":
                return None
            time.sleep(wait_s)

    def task_finished(self, task_id):
        self._call({"op": "task_finished", "id": task_id})

    def task_failed(self, task_id):
        self._call({"op": "task_failed", "id": task_id})

    def stats(self):
        return self._call({"op": "stats"})

    def close(self):
        with self._lock:
            self._drop_conn()
