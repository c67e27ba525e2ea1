"""Socket RPC for parameter-shard training: variable send/get + barriers
(the JAX package's distributed/rpc.py, on torch: the same frames, byte for
byte, so a trainer or a pserver of either package talks to the other's).

Reference analog: paddle/fluid/operators/distributed/ — RPCClient
(rpc_client.h:36-79: AsyncSendVar/AsyncGetVar/barriers/SendComplete), RPCServer
(rpc_server.h:48-105: registered handlers + barrier machinery), and the gRPC
wire format (send_recv.proto.in VariableMessage; zero-copy serialization in
grpc_serde.cc). Redesigned host-side: a length-prefixed
binary frame over TCP — varname, dtype, dims, raw tensor bytes — with no
protobuf/pickle dependency; tensors cross the wire as the host buffer exactly
once (the grpc_serde zero-extra-copy property). A tensor on the card is
copied to the host first (the send's device-to-host sync). A bf16 tensor
travels with dtype "bfloat16" and 2-byte elements (its bits as uint16; numpy
has no bfloat16) and is read back as a torch.bfloat16 tensor; every other
dtype is read back as a numpy array.

Frame layout (little-endian):
  u8   msg kind (SEND_VAR / GET_VAR / VAR_REPLY / SEND_BARRIER / FETCH_BARRIER
                 / COMPLETE / ACK)
  i32  trainer_id
  u16  len(varname), varname utf-8
  u16  len(dtype str), dtype utf-8      (SEND_VAR / VAR_REPLY only; 0 marks a
                                         var-less frame and ends it — the
                                         "unknown var" reply)
  u8   ndim, i64 × ndim dims            (SEND_VAR / VAR_REPLY, dtype len > 0)
  u64  payload byte length, payload     (SEND_VAR / VAR_REPLY, dtype len > 0)
"""

import socket
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..resilience import faults as _faults
from ..resilience import health as _health
from ..resilience.retry import DeadlineExceeded, FatalError, RetryPolicy

__all__ = ["RPCClient", "RPCServer", "CollectiveClient", "serialize_var", "read_frame"]

SEND_VAR = 1
GET_VAR = 2
VAR_REPLY = 3
SEND_BARRIER = 4
FETCH_BARRIER = 5
COMPLETE = 6
ACK = 7

_HEADER = struct.Struct("<Bi")
_U16 = struct.Struct("<H")
_U64 = struct.Struct("<Q")


def _pack_str(s):
    b = s.encode("utf-8")
    return _U16.pack(len(b)) + b


def _wire(array):
    """(contiguous host numpy array, dtype string) of a frame's payload."""
    if isinstance(array, torch.Tensor):
        t = array.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.ascontiguousarray(array)
    return arr, str(arr.dtype)


def serialize_var(kind, trainer_id, name, array=None):
    parts = [_HEADER.pack(kind, trainer_id), _pack_str(name)]
    if array is not None:
        arr, dtype = _wire(array)
        parts.append(_pack_str(dtype))
        parts.append(struct.pack("<B", arr.ndim))
        parts.append(struct.pack("<%dq" % arr.ndim, *arr.shape))
        payload = arr.tobytes()  # the single host copy
        parts.append(_U64.pack(len(payload)))
        parts.append(payload)
    elif kind in (SEND_VAR, VAR_REPLY):
        parts.append(_U16.pack(0))  # zero dtype length = var-less frame
    return b"".join(parts)


def _recv_exact(sock, n):
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed")
        got += r
    return buf  # writable: a payload read from it is a writable array


def read_frame(sock):
    """Returns (kind, trainer_id, varname, array-or-None): a numpy array, or
    a torch.bfloat16 tensor for a "bfloat16" payload."""
    kind, trainer_id = _HEADER.unpack(_recv_exact(sock, _HEADER.size))
    (nlen,) = _U16.unpack(_recv_exact(sock, 2))
    name = _recv_exact(sock, nlen).decode("utf-8")
    arr = None
    if kind in (SEND_VAR, VAR_REPLY):
        (dlen,) = _U16.unpack(_recv_exact(sock, 2))
        if dlen:
            dtype = _recv_exact(sock, dlen).decode("utf-8")
            (ndim,) = struct.unpack("<B", _recv_exact(sock, 1))
            dims = struct.unpack("<%dq" % ndim, _recv_exact(sock, 8 * ndim)) if ndim else ()
            (plen,) = _U64.unpack(_recv_exact(sock, 8))
            payload = _recv_exact(sock, plen)
            if dtype == "bfloat16":
                bits = np.frombuffer(payload, dtype=np.uint16).reshape(dims)
                arr = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
            else:
                arr = np.frombuffer(payload, dtype=dtype).reshape(dims)
    return kind, trainer_id, name, arr


class NonIdempotentError(FatalError):
    """A mutating frame failed after its bytes may have reached the server:
    resending could double-apply a gradient or double-count a barrier.
    Subclassed below with the concrete failure type mixed in, so callers
    keep catching ConnectionError/TimeoutError while RetryPolicy (for which
    FatalError is fatal) never resends."""


class _NonIdempotentConnError(NonIdempotentError, ConnectionError):
    pass


class _NonIdempotentDeadline(NonIdempotentError, DeadlineExceeded):
    pass


class RPCClient:
    """One per trainer process (reference rpc_client.h singleton GetInstance).
    Maintains one persistent connection per endpoint; async ops run on a
    thread pool, wait() joins them (AsyncSendVar/Wait semantics)."""

    _instance = None
    _lock = threading.Lock()

    @classmethod
    def instance(cls, trainer_id=0):
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls(trainer_id)
        return cls._instance

    def __init__(self, trainer_id=0, timeout=None):
        from .. import flags as _flags

        self.trainer_id = trainer_id
        # FLAGS_rpc_deadline governs connects and reply waits (reference
        # grpc_client.cc FLAGS_rpc_deadline)
        self.timeout = (
            float(_flags.get_flags("rpc_deadline")["rpc_deadline"])
            if timeout is None
            else timeout
        )
        self._socks = {}
        self._sock_locks = {}
        self._connect_lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=8)
        self._futures = []
        # frame bytes this client put on and took off the wire (tools read
        # them a step; the payloads dominate)
        self.bytes_sent = 0
        self.bytes_received = 0
        self._count_lock = threading.Lock()

    def _sock(self, endpoint):
        # pool workers race to first-connect an endpoint; a per-endpoint
        # connect lock serializes creation without letting one slow/dead
        # endpoint's connect stall RPCs to every other endpoint
        try:
            return self._socks[endpoint], self._sock_locks[endpoint]
        except KeyError:
            pass
        with self._connect_lock:
            ep_lock = self._sock_locks.setdefault(endpoint, threading.Lock())
        with ep_lock:
            if endpoint not in self._socks:
                host, port = endpoint.rsplit(":", 1)
                s = socket.create_connection((host, int(port)), timeout=self.timeout)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                self._socks[endpoint] = s
            return self._socks[endpoint], ep_lock

    def _drop_sock(self, endpoint, sock):
        # drop ONLY the socket this attempt used: a concurrent worker may
        # already have reconnected a healthy one under the same endpoint
        with self._connect_lock:
            if self._socks.get(endpoint) is sock:
                self._socks.pop(endpoint, None)
        try:
            sock.close()
        except OSError:
            pass

    def _retry_policy(self):
        """Unified retry policy (resilience.retry): attempts from
        FLAGS_rpc_max_retry, overall budget FLAGS_rpc_deadline (the reference
        grpc_client.cc pair), exponential backoff + jitter between attempts."""
        from .. import flags as _flags

        fl = _flags.get_flags(["rpc_max_retry", "rpc_deadline"])
        return RetryPolicy(
            max_attempts=int(fl["rpc_max_retry"]) + 1,
            base_delay=0.05,
            max_delay=2.0,
            deadline=float(fl["rpc_deadline"]),
        )

    def _rpc(self, endpoint, frame, want_reply):
        """One request/response under the unified RetryPolicy: reconnect and
        retry on connection failure (a pserver restarting mid-training must
        not kill the trainer).

        Idempotency contract (unchanged from the hand-rolled loop this
        replaces): GET-style calls (want_reply) are repeatable; mutating
        frames (SEND_VAR, barriers) are retried only while the failure is at
        the CONNECT stage — once bytes may have reached the server, a resend
        could double-apply a gradient, so a fatal NonIdempotentError
        surfaces instead. Within one attempt, FLAGS_rpc_op_deadline bounds
        the reply wait so a HUNG peer becomes a typed DeadlineExceeded
        rather than an indefinite block on _recv_exact."""
        from .. import flags as _flags

        op_deadline = float(_flags.get_flags("rpc_op_deadline")["rpc_op_deadline"])

        def attempt():
            # connect stage — nothing sent yet, every failure is retryable
            # (OSError from _sock propagates as-is); injected faults land
            # here too so they are survivable for every frame kind
            sock, lock = self._sock(endpoint)
            if _faults.fires("rpc_drop"):
                self._drop_sock(endpoint, sock)
                raise ConnectionResetError("injected rpc_drop to %s" % endpoint)
            _faults.delay("rpc_delay")
            try:
                with lock:
                    sock.settimeout(op_deadline)
                    sock.sendall(frame)
                    # GETs read the VAR_REPLY; sends read the ACK that keeps
                    # them flow-controlled
                    kind, _, _name, arr = read_frame(sock)
                with self._count_lock:
                    self.bytes_sent += len(frame)
                    if arr is not None:
                        self.bytes_received += arr.numel() * arr.element_size() \
                            if isinstance(arr, torch.Tensor) else arr.nbytes
                    if want_reply:
                        return arr if kind == VAR_REPLY else None
                    return None
            except socket.timeout as e:
                self._drop_sock(endpoint, sock)
                msg = "rpc to %s: no reply within %.1fs" % (endpoint, op_deadline)
                if not want_reply:
                    raise _NonIdempotentDeadline(msg) from e
                raise DeadlineExceeded(msg) from e
            except (OSError, EOFError) as e:
                self._drop_sock(endpoint, sock)
                if not want_reply:
                    raise _NonIdempotentConnError(
                        "rpc to %s failed after send may have been delivered "
                        "(not retried: non-idempotent): %r" % (endpoint, e)
                    ) from e
                raise

        return self._retry_policy().call(
            attempt, on_retry=lambda _a, _e: _health.incr("rpc_retries")
        )

    # --- async API (reference rpc_client.h:36-79) ---
    def async_send_var(self, endpoint, name, array):
        f = self._pool.submit(
            self._rpc, endpoint,
            serialize_var(SEND_VAR, self.trainer_id, name, array),
            False,
        )
        self._futures.append(f)
        return f

    def async_get_var(self, endpoint, name):
        f = self._pool.submit(
            self._rpc, endpoint, serialize_var(GET_VAR, self.trainer_id, name), True
        )
        self._futures.append(f)
        return f

    def send_barrier(self, endpoint):
        f = self._pool.submit(
            self._rpc, endpoint, serialize_var(SEND_BARRIER, self.trainer_id, ""), False
        )
        self._futures.append(f)
        return f

    def fetch_barrier(self, endpoint):
        f = self._pool.submit(
            self._rpc, endpoint, serialize_var(FETCH_BARRIER, self.trainer_id, ""), False
        )
        self._futures.append(f)
        return f

    def send_complete(self, endpoint):
        try:
            self._rpc(endpoint, serialize_var(COMPLETE, self.trainer_id, ""), False)
        except (ConnectionError, OSError):
            pass  # server may already be down

    def wait(self):
        fs, self._futures = self._futures, []
        for f in fs:
            f.result(timeout=self.timeout)

    def close(self):
        for s in self._socks.values():
            try:
                s.close()
            except OSError:
                pass
        self._socks.clear()
        self._pool.shutdown(wait=False)
        with RPCClient._lock:
            if RPCClient._instance is self:
                RPCClient._instance = None


class RPCServer:
    """Parameter-shard server transport (reference rpc_server.h:48 +
    grpc_server.cc). Owns the listening socket and per-connection threads;
    the training-loop semantics (sync barriers, grad merge, optimize) live in
    listen_and_serv.py, wired in via the three handler callbacks, mirroring
    the reference's RequestSend/RequestGet handler registration."""

    def __init__(self, endpoint, fanin):
        host, port = endpoint.rsplit(":", 1)
        self.fanin = fanin
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host or "0.0.0.0", int(port)))
        self._listener.listen(64)
        self.endpoint = "%s:%d" % (host, self._listener.getsockname()[1])
        self._threads = []
        self._stop = threading.Event()
        self.cond = threading.Condition()
        # trainer_id -> monotonically increasing barrier count (see
        # listen_and_serv.py: round r waits for count > r; monotonic counters
        # replace the reference's racy ResetBarrierCounter)
        self.barrier_counts = {SEND_BARRIER: {}, FETCH_BARRIER: {}}
        self.exited_trainers = set()
        # handlers set by the serving loop (RequestSendHandler etc.)
        self.on_send = None  # fn(name, array, trainer_id)
        self.on_get = None  # fn(name, trainer_id) -> array or tensor (may block)

    def start(self):
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def _accept_loop(self):
        self._listener.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._serve_conn, args=(conn,), daemon=True)
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn):
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while not self._stop.is_set():
                kind, trainer_id, name, arr = read_frame(conn)
                if kind == SEND_VAR:
                    self.on_send(name, arr, trainer_id)
                    conn.sendall(serialize_var(ACK, 0, ""))
                elif kind == GET_VAR:
                    out = self.on_get(name, trainer_id)
                    if out is None:
                        # unknown var: reply empty so the client raises
                        # instead of timing out (reference returns a gRPC
                        # error status)
                        conn.sendall(serialize_var(VAR_REPLY, 0, name, None))
                    else:
                        conn.sendall(serialize_var(VAR_REPLY, 0, name, out))
                elif kind in (SEND_BARRIER, FETCH_BARRIER):
                    with self.cond:
                        counts = self.barrier_counts[kind]
                        counts[trainer_id] = counts.get(trainer_id, 0) + 1
                        self.cond.notify_all()
                    conn.sendall(serialize_var(ACK, 0, ""))
                elif kind == COMPLETE:
                    with self.cond:
                        self.exited_trainers.add(trainer_id)
                        self.cond.notify_all()
                    conn.sendall(serialize_var(ACK, 0, ""))
        except (ConnectionError, OSError):
            pass
        except BaseException:
            import traceback

            traceback.print_exc()
        finally:
            conn.close()

    # --- barrier machinery (reference rpc_server.h WaitBarrier/ResetBarrier) ---
    def wait_barrier(self, kind, round_idx):
        """Wait until every live trainer passed barrier round `round_idx`
        (count > round_idx); returns False once every trainer exited instead
        (graceful shutdown, rpc_server.h:98 Complete)."""
        with self.cond:
            while True:
                if len(self.exited_trainers) >= self.fanin:
                    return False
                counts = self.barrier_counts[kind]
                passed = sum(
                    1
                    for t, c in counts.items()
                    if c > round_idx and t not in self.exited_trainers
                )
                if passed >= self.fanin - len(self.exited_trainers):
                    return True
                self.cond.wait(timeout=0.5)

    def wait_all_exited(self):
        with self.cond:
            while len(self.exited_trainers) < self.fanin:
                self.cond.wait(timeout=0.5)

    def all_exited(self):
        with self.cond:
            return len(self.exited_trainers) >= self.fanin

    def stop(self):
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass


class CollectiveClient:
    """Gather a named var from many servers at once (reference
    distributed/collective_client.h:62 CollectiveClient::Gather of remote
    SelectedRows slices — the cross-node sparse-allgather building block).
    Dense redesign: each pserver serves its slice; gather returns them in
    endpoint order for host-side concat."""

    def __init__(self, trainer_id=0):
        self._client = RPCClient.instance(trainer_id)

    def gather(self, endpoints, var_name, timeout=None):
        # one OVERALL deadline across all endpoints (the futures run
        # concurrently; per-future fresh budgets would multiply the wait)
        budget = self._client.timeout if timeout is None else timeout
        deadline = time.monotonic() + budget
        futures = [
            (ep, self._client.async_get_var(ep, var_name)) for ep in endpoints
        ]
        out = []
        for ep, f in futures:
            remaining = max(deadline - time.monotonic(), 0.001)
            arr = f.result(timeout=remaining)
            if arr is None:
                raise KeyError("gather: %s has no var %r" % (ep, var_name))
            out.append(arr)
        return out
