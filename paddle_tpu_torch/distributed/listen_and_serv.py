"""Parameter-shard serving loop (the pserver main op; the JAX package's
distributed/listen_and_serv.py on torch).

Reference analog: operators/distributed_ops/listen_and_serv_op.cc —
RunSyncLoop (:106-176: wait send-barrier → run optimize sub-blocks per grad →
serve gets until fetch-barrier) and RunAsyncLoop (:216: optimize immediately
per arriving grad, no barriers) — plus the request handlers
(distributed/request_handler_impl.cc: sync-mode scope merge of per-trainer
grads, get serves params). The optimizer sub-blocks execute through the same
block forms as regular programs (executor.py): on the card each is a
_CompiledBlock, captured as a CUDA graph at its second round and replayed
after, all of a pserver's graphs in one pool, so shard updates run on the
pserver's device. Gradients arrive on the host, are summed over trainers
there (the JAX package's order, in the grads' dtype) and are bound in the
scope as tensors on its device; a captured block copies them into its own
tensors at its replay. Served params and prefetched rows leave from the
device (the send copies them to the host). In async mode the blocks run on
the RPC handler threads, one at a time under the state lock; a capture
there runs on the device's capture stream like any other
(executor._on_capture_stream, capture mode "thread_local").

Synchronization redesign: the reference resets barrier counters each round
(rpc_server.h ResetBarrierCounter), which races with fast trainers; here each
trainer's barrier count is MONOTONIC and round r waits for count > r — no
reset, no race.
"""

import logging
import threading

import numpy as np
import torch

from .rpc import FETCH_BARRIER, SEND_BARRIER, RPCServer

__all__ = ["run_pserver"]


class _BlockRunner:
    """Prepare (at its first run, once its grads are in the scope) and run
    one sub-block against the pserver scope: a _CompiledBlock in `pool` on
    the card, op by op on the CPU."""

    def __init__(self, program, block, scope, pool):
        self.program = program
        self.block = block
        self.scope = scope
        self.pool = pool
        self._compiled = None

    def run(self):
        from ..executor import _CompiledBlock, _PerOpProfiledBlock

        if self._compiled is None:
            self._compiled = _PerOpProfiledBlock(self.block, [], [], self.scope)
            if self.pool is not None:
                self._compiled = _CompiledBlock(self._compiled, self.pool)
        self._compiled(self.scope, {})


def run_pserver(op, scope):
    """Blocks until every trainer sent COMPLETE (reference listen_and_serv
    blocks its executor thread the same way)."""
    attrs = op.attrs
    endpoint = attrs["endpoint"]
    sync_mode = bool(attrs.get("sync_mode", True))
    fanin = int(attrs.get("Fanin", 1))
    program = op.block.program
    opt_block_ids = list(attrs.get("optimize_blocks", []))
    grad_to_block_id = dict(
        kv.split(":") for kv in attrs.get("grad_to_block_id", [])
    )
    lr_block_id = int(attrs.get("lr_decay_block_id", -1))

    server = RPCServer(endpoint, fanin)
    device = scope.device
    pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
    runners = {
        bid: _BlockRunner(program, program.block(bid), scope, pool)
        for bid in opt_block_ids
    }
    lr_runner = (
        _BlockRunner(program, program.block(lr_block_id), scope, pool)
        if lr_block_id >= 0
        else None
    )
    grad_block = {g: int(b) for g, b in grad_to_block_id.items()}

    state_lock = threading.Lock()
    staged = {}  # grad name -> accumulated np array (sync mode round staging)
    prefetch_ids = {}  # (trainer_id, "<table>:<req>") -> staged __prefetch__ ids
    optimized_rounds = [0]
    ready = threading.Condition()
    # gradient-merge window state, shared with the checkpoint handler so a
    # mid-window checkpoint/restore resumes the exact trajectory: acc holds
    # the rounds accumulated so far, phase the count of rounds into the
    # current window. Restored values arrive via scope under the reserved
    # __gm_acc__:/__gm_rnd_phase__ names (written by a prior checkpoint).
    gm_state = {"acc": {}, "phase": 0}
    for vname in list(scope.vars):
        if vname == "__gm_rnd_phase__":
            gm_state["phase"] = int(_host(scope.vars.pop(vname)).reshape(()))
        elif vname.startswith("__gm_acc__:"):
            gm_state["acc"][vname[len("__gm_acc__:"):]] = _host(scope.vars.pop(vname))

    def on_send(name, arr, trainer_id):
        if arr is None:
            return
        if name.startswith("__prefetch_ids__:"):
            # RequestPrefetchHandler (request_handler_impl.h + parameter_
            # prefetch.cc): stage the id vector; the matching GET computes
            # and returns the table rows. Keyed per trainer so concurrent
            # prefetches of the same table don't collide.
            with state_lock:
                prefetch_ids[(trainer_id, name.split(":", 1)[1])] = _host(arr)
            return
        if sync_mode:
            with state_lock:
                cur = staged.get(name)
                if cur is not None:
                    staged[name] = cur + arr
                else:
                    staged[name] = arr.clone() if isinstance(arr, torch.Tensor) else arr.copy()
        else:
            # async: optimize immediately per arriving grad (RunAsyncLoop)
            with state_lock:
                scope.set_var(name, _to_device(arr, device))
                bid = grad_block.get(name)
                if bid is not None:
                    runners[bid].run()

    def on_get(name, trainer_id):
        if name.startswith("__prefetch_out__:"):
            # key layout: __prefetch_out__:<table>:<req> — rows of this
            # shard's table slice for the staged ids (masked slots, id<0,
            # return zero rows; merge_ids drops them by position)
            key = name.split(":", 1)[1]
            table_name, _, _req = key.partition(":")
            with state_lock:
                ids = prefetch_ids.pop((trainer_id, key), None)
                table = scope.find_var(table_name)
            if ids is None or table is None:
                return None
            ids64 = ids.astype(np.int64).reshape(-1)
            # ids here are GLOBAL row ids served against a full table; the
            # split_byref row-sharded layout is not served via prefetch (the
            # distribute transpiler keeps lookup tables whole on one pserver
            # — see distribute_transpiler lookup-table rewrite). Reject out-
            # of-range ids loudly instead of clamping to the last row.
            if np.any(ids64 >= table.shape[0]):
                # empty reply → the client raises (same contract as an
                # unknown var) instead of silently serving the last row
                logging.error(
                    "prefetch id %d out of range for table %r with %d rows",
                    int(ids64.max()), table_name, table.shape[0],
                )
                return None
            # masked slots (id<0) index row 0 then zero out below; the
            # gather runs on the table's device
            idx = torch.from_numpy(np.maximum(ids64, 0)).to(table.device)
            rows = table[idx]
            rows[torch.from_numpy(ids64 < 0).to(table.device)] = 0
            return rows
        if name.startswith("__checkpoint__:"):
            # RequestCheckpointHandler (request_handler_impl.h:103): persist
            # this shard's vars under the trainer-provided dir, outside the
            # barrier protocol so a notify can land mid-round
            ckpt_dir = name.split(":", 1)[1]
            if not ckpt_dir:
                return None  # var-less reply → client raises instead of
                # reporting a checkpoint that was never written
            from .. import io as fluid_io
            from ..resilience.checkpoint import host_copy

            # a replayed optimize block updates its tensors in place, so the
            # snapshot is taken as host copies under the lock (a consistent
            # checkpoint); the disk writes run outside it so concurrent
            # sends / optimize rounds don't stall on I/O. Grad staging vars
            # (`*@GRAD`) are transient — skip them, like save_persistables.
            with state_lock:
                snapshot = {
                    vname: host_copy(val)
                    for vname, val in scope.vars.items()
                    if val is not None and "@" not in vname
                }
                # gradient-merge window state rides in the checkpoint under
                # reserved names so a restored pserver resumes mid-window
                # (run_pserver pops them back out of the scope at start)
                if gm_state["acc"] or gm_state["phase"]:
                    snapshot["__gm_rnd_phase__"] = np.asarray(
                        [gm_state["phase"]], np.int64
                    )
                    for g, arr in gm_state["acc"].items():
                        snapshot["__gm_acc__:" + g] = arr
            fluid_io.save_arrays(ckpt_dir, snapshot)
            return np.ones((1,), np.int64)
        if sync_mode:
            # serve only after this trainer's current round was optimized
            want = server.barrier_counts[SEND_BARRIER].get(trainer_id, 0)
            with ready:
                while optimized_rounds[0] < want and not server.all_exited():
                    ready.wait(timeout=0.5)
        return scope.find_var(name)

    server.on_send = on_send
    server.on_get = on_get
    server.start()
    op.attrs["__bound_endpoint__"] = server.endpoint  # port 0 → real port

    try:
        if sync_mode:
            # pserver-side gradient merge (reference
            # ir/multi_batch_merge_pass.cc driven by
            # test_dist_mnist_batch_merge.py — there the TRAINER accumulates k
            # micro-batch grads before one optimizer step; summing on the
            # pserver across k sync rounds is numerically the same fold and
            # composes with sharding without conditional RPC): accumulate the
            # trainer-summed grads each round, run the optimize blocks every
            # k-th round on the (optionally k-averaged) accumulator. A
            # partial window at training end is discarded, like the
            # reference's trailing micro-batches.
            gm_k = int(attrs.get("gradient_merge_k", 0) or 0)
            gm_avg = bool(attrs.get("gradient_merge_avg", True))
            rnd = 0
            while True:
                if not server.wait_barrier(SEND_BARRIER, rnd):
                    break
                # state_lock covers the scope mutations too, so a concurrent
                # checkpoint snapshot never sees torn mid-update params
                with state_lock:
                    grads = dict(staged)
                    staged.clear()
                    if gm_k > 1:
                        gm_acc = gm_state["acc"]
                        for g, arr in grads.items():
                            gm_acc[g] = (
                                arr if g not in gm_acc else gm_acc[g] + arr
                            )
                        gm_state["phase"] += 1
                        if gm_state["phase"] % gm_k == 0:
                            for g, arr in gm_acc.items():
                                scope.set_var(
                                    g,
                                    _to_device(arr / gm_k if gm_avg else arr, device),
                                )
                            if lr_runner is not None:
                                lr_runner.run()
                            for g in gm_acc:
                                bid = grad_block.get(g)
                                if bid is not None:
                                    runners[bid].run()
                            gm_acc.clear()
                            gm_state["phase"] = 0
                    else:
                        for g, arr in grads.items():
                            # sync merge = sum over trainers, then the
                            # per-grad optimize block
                            # (request_handler_impl.cc scope merge)
                            scope.set_var(g, _to_device(arr, device))
                        if lr_runner is not None:
                            lr_runner.run()
                        for g in grads:
                            bid = grad_block.get(g)
                            if bid is not None:
                                runners[bid].run()
                with ready:
                    optimized_rounds[0] = rnd + 1
                    ready.notify_all()
                if not server.wait_barrier(FETCH_BARRIER, rnd):
                    break
                rnd += 1
        else:
            server.wait_all_exited()
    except BaseException:
        # serving-loop failures must be visible: they run on daemon threads
        # (reference pserver glog-fatals here)
        import traceback

        traceback.print_exc()
        raise
    finally:
        with ready:
            ready.notify_all()
        server.stop()


def _host(val):
    """A host copy of an arriving or stored value: numpy, or a CPU tensor
    for bf16 (numpy has no bfloat16)."""
    if isinstance(val, torch.Tensor):
        val = val.detach().cpu()
        return val if val.dtype == torch.bfloat16 else val.numpy()
    return np.asarray(val)


def _to_device(arr, device):
    """An arriving (summed) grad as a tensor on the pserver's device."""
    from ..executor import to_tensor

    return to_tensor(arr, device)
