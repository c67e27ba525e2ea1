"""Distributed RPC ops: host ops run between device segments (the JAX
package's ops/dist_ops.py on torch).

Reference analog: operators/distributed_ops/ — send_op (async grad push),
recv_op (param pull), send_barrier_op, fetch_barrier_op, listen_and_serv_op,
checkpoint_notify_op, fake_init_op. They talk RPC, not CUDA, so they run on
the host between the block's device segments (executor._SegmentedBlock splits
the block at them; on the card each segment is a captured CUDA graph),
speaking the socket RPC of distributed/rpc.py. A `send` reads a segment's
output (its copy to the host waits for the segment); a `recv` rebinds the
received value in the scope as a tensor on its device, which a later
captured segment copies into its own tensor at its replay.
`ref_by_trainer_id` is an ordinary lowering.
"""

import threading
import time

import torch

from .registry import register, register_host

_stats = {}  # op type -> [calls, seconds]
_stats_lock = threading.Lock()


def stats():
    """{op type: (calls, seconds)} of the RPC host ops this process ran:
    a trainer's time in send, recv and the barriers."""
    with _stats_lock:
        return {k: tuple(v) for k, v in _stats.items()}


def reset_stats():
    with _stats_lock:
        _stats.clear()


def _timed(fn):
    def run(op, scope):
        t0 = time.perf_counter()
        try:
            return fn(op, scope)
        finally:
            with _stats_lock:
                s = _stats.setdefault(op.type, [0, 0.0])
                s[0] += 1
                s[1] += time.perf_counter() - t0

    run.__doc__ = fn.__doc__
    return run


def _client(op):
    from ..distributed.rpc import RPCClient

    return RPCClient.instance(int(op.attrs.get("trainer_id", 0)))


def _to_device(arr, scope):
    from ..executor import to_tensor

    return to_tensor(arr, scope.device)


@register_host("send")
@_timed
def _send(op, scope):
    """Push each X[i] to epmap[i] (reference send_op.cc: AsyncSendVar per var,
    then Wait)."""
    client = _client(op)
    names = op.input("X")
    epmap = op.attrs["epmap"]
    for name, ep in zip(names, epmap):
        client.async_send_var(ep, name, scope.find_var(name))
    client.wait()


@register_host("recv")
@_timed
def _recv(op, scope):
    """Pull each Out[i] from epmap[i] (reference recv_op.cc)."""
    client = _client(op)
    names = op.output("Out")
    epmap = op.attrs["epmap"]
    futures = [(name, client.async_get_var(ep, name)) for name, ep in zip(names, epmap)]
    for name, f in futures:
        arr = f.result(timeout=client.timeout)
        if arr is None:
            raise KeyError(
                "recv: pserver has no var %r (wrong endpoint map?)" % name
            )
        scope.set_var(name, _to_device(arr, scope))


@register_host("send_barrier")
@_timed
def _send_barrier(op, scope):
    client = _client(op)
    for ep in op.attrs["endpoints"]:
        client.send_barrier(ep)
    client.wait()


@register_host("fetch_barrier")
@_timed
def _fetch_barrier(op, scope):
    client = _client(op)
    for ep in op.attrs["endpoints"]:
        client.fetch_barrier(ep)
    client.wait()


@register_host("listen_and_serv")
def _listen_and_serv(op, scope):
    from ..distributed.listen_and_serv import run_pserver

    run_pserver(op, scope)


@register_host("checkpoint_notify")
@_timed
def _checkpoint_notify(op, scope):
    """Ask each pserver to checkpoint its shards (reference
    checkpoint_notify_op.cc + RequestCheckpointHandler), over the GET
    channel: each pserver writes its vars under `dir` with io.save_arrays."""
    ckpt_dir = op.attrs.get("dir", "")
    if not ckpt_dir:
        raise ValueError("checkpoint_notify requires a non-empty 'dir' attr")
    client = _client(op)
    futures = [
        (ep, client.async_get_var(ep, "__checkpoint__:%s" % ckpt_dir))
        for ep in op.attrs.get("epmap", op.attrs.get("endpoints", []))
    ]
    client.wait()
    for ep, f in futures:
        if f.result() is None:
            raise RuntimeError("pserver %s failed to checkpoint to %r" % (ep, ckpt_dir))


@register_host("fake_init")
def _fake_init(op, scope):
    """Declare-only init for vars whose values live on pservers (reference
    fake_init_op.cc): an empty placeholder so startup programs type-check;
    real values arrive via recv."""
    for name in op.output("Out"):
        if scope.find_var(name) is None:
            scope.set_var(name, torch.zeros((1,), dtype=torch.float32, device=scope.device))


@register("ref_by_trainer_id", no_grad=True)
def _ref_by_trainer_id(ctx, ins, attrs):
    """Out = X[TrainerId] (reference ref_by_trainer_id_op.cc): each trainer
    selects its own entry of a list of same-shaped candidates. The index
    stays on the device (clamped into range), so the op captures."""
    xs = ins["X"]
    (tid,) = ins["TrainerId"]
    idx = tid.reshape(1).to(device=xs[0].device, dtype=torch.long).clamp(0, len(xs) - 1)
    return {"Out": [torch.stack(xs).index_select(0, idx).squeeze(0)]}
