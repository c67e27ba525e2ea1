"""Framework-level ops (a port of paddle_tpu/ops/frame_ops.py): the
graph-native checkpoint ops save / load / save_combine / load_combine, scope
management (delete_var, get_places, go), which run on the host between
device segments (executor.py _SegmentedBlock), and the device ops of the
IfElse row split and merge, tensor-array export, StaticRNN memory plumbing
and sharded-id plumbing.

The files the checkpoint ops write are the JAX package's: `np.save` of the
array with a `<path>.dtype` sidecar naming bfloat16 where a bf16 value was
widened to f32, and an `np.savez` archive with a `__dtypes__` entry for the
combined form, so either package loads what the other saved.

The reader ops (`read`, the `create_*_reader` ops, `open_files`) are
markers, as in the JAX package: batches enter through Executor.run's feeds,
so an imported reference program that holds them runs, and every block
form skips them (registry.register_no_lower).

`prefetch` (a parameter-server row fetch over distributed/rpc.py) and
`gen_nccl_id` (a collective rendezvous: a checked no-op, since the port's
rendezvous is torch.distributed's, parallel/multihost.py) are host ops too.
"""

import ast
import os
import threading

import numpy as np
import torch

from .registry import register, register_host, register_no_lower


def _save_path(op):
    path = op.attrs["file_path"]
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    return path


@register_host("save")
def _save(op, scope):
    from ..io import _to_numpy

    (name,) = op.input("X")
    val = scope.find_var(name)
    if val is None:
        raise RuntimeError("save: variable %r has no value in scope" % name)
    arr, orig = _to_numpy(val)
    path = _save_path(op)
    if op.attrs.get("save_as_fp16", False):
        arr = arr.astype(np.float16)
    np.save(path, arr)
    if orig:
        with open(path + ".dtype", "w") as f:
            f.write(orig)


@register_host("load")
def _load(op, scope):
    from ..io import _to_tensor

    path = op.attrs["file_path"]
    arr = np.load(path if path.endswith(".npy") else path + ".npy")
    (name,) = op.output("Out")
    orig = None
    if os.path.exists(path + ".dtype"):
        with open(path + ".dtype") as f:
            orig = f.read().strip()
    scope.set_var(name, _to_tensor(arr, orig, scope.device))


@register_host("save_combine")
def _save_combine(op, scope):
    from ..io import _to_numpy

    path = _save_path(op)
    arrays, dtypes = {}, {}
    for name in op.input("X"):
        val = scope.find_var(name)
        if val is None:
            raise RuntimeError("save_combine: variable %r has no value" % name)
        arrays[name], orig = _to_numpy(val)
        if orig:
            dtypes[name] = orig
    np.savez(path, __dtypes__=np.array([repr(dtypes)]), **arrays)


@register_host("load_combine")
def _load_combine(op, scope):
    from ..io import _to_tensor

    path = op.attrs["file_path"]
    data = np.load(path if path.endswith(".npz") else path + ".npz", allow_pickle=False)
    dtypes = {}
    if "__dtypes__" in data:
        dtypes = ast.literal_eval(str(data["__dtypes__"][0]))
    for name in op.output("Out"):
        scope.set_var(name, _to_tensor(data[name], dtypes.get(name), scope.device))


@register_host("delete_var")
def _delete_var(op, scope):
    """Scope cleanup (reference delete_var_op.cc)."""
    for name in op.input("X"):
        scope.vars.pop(name, None)


@register_host("get_places")
def _get_places(op, scope):
    """Device enumeration (reference controlflow/get_places_op.cc): the
    device count, as int32 ids 0..count-1; `device_count` 0 means every
    device of the scope's kind."""
    count = int(op.attrs.get("device_count", 0) or 0)
    if not count:
        count = torch.cuda.device_count() if scope.device.type == "cuda" else 1
    (out,) = op.output("Out")
    scope.set_var(out, torch.arange(count, dtype=torch.int32, device=scope.device))


@register_host("go")
def _go(op, scope):
    """Fire-and-forget block launch (reference csp/go_op.cc spawns a
    detached thread that runs the sub-block): the sub-block runs op by op
    on the same scope; the threads are kept under `__go_threads__` so a
    caller can join them."""
    from ..executor import _SegmentedBlock

    sub = op.attrs["sub_block"]

    def run():
        _SegmentedBlock(sub, [], [], None, capture=False)(scope, {})

    t = threading.Thread(target=run, daemon=True)
    t.start()
    threads = scope.find_var("__go_threads__")
    if not isinstance(threads, list):
        threads = []
        scope.vars["__go_threads__"] = threads
    threads.append(t)


# ---------------------------------------------------------------------------
# IfElse row scatter / gather, array export, StaticRNN memory plumbing
# ---------------------------------------------------------------------------


def _row_mask(mask, ndim):
    return mask.reshape((-1,) + (1,) * (ndim - 1)).to(torch.bool)


@register("split_lod_tensor")
def _split_lod_tensor(ctx, ins, attrs):
    """Both outputs keep the full batch with the rows not selected zeroed
    (static shapes; merge_lod_tensor composes exactly)."""
    (x,) = ins["X"]
    (mask,) = ins["Mask"]
    m = _row_mask(mask, x.dim())
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return {"OutTrue": [torch.where(m, x, zero)], "OutFalse": [torch.where(m, zero, x)]}


@register("merge_lod_tensor")
def _merge_lod_tensor(ctx, ins, attrs):
    (in_true,) = ins["InTrue"]
    (in_false,) = ins["InFalse"]
    (mask,) = ins["Mask"]
    return {"Out": [torch.where(_row_mask(mask, in_true.dim()), in_true, in_false)]}


@register("tensor_array_to_tensor", infer_shape=lambda op, block: None)
def _tensor_array_to_tensor(ctx, ins, attrs):
    """Concat or stack the (buffer, size) tensor array along `axis`
    (reference tensor_array_to_tensor_op.cc); every buffer slot takes part."""
    (arr,) = ins["X"]
    buf, _size = arr
    axis = int(attrs.get("axis", 0))
    if attrs.get("use_stack", False):
        out = torch.movedim(buf, 0, axis)
        per_slot = 1
    else:
        pieces = [buf[i] for i in range(buf.shape[0])]
        out = torch.cat(pieces, dim=axis)
        per_slot = pieces[0].shape[axis] if pieces[0].dim() else 1
    idx = torch.full((buf.shape[0],), per_slot, dtype=torch.int32, device=buf.device)
    return {"Out": [out], "OutIndex": [idx]}


@register("rnn_memory_helper")
def _rnn_memory_helper(ctx, ins, attrs):
    (x,) = ins["X"]
    return {"Out": [x]}


@register("rnn_memory_helper_grad", no_grad=True)
def _rnn_memory_helper_grad(ctx, ins, attrs):
    (g,) = ins["Out@GRAD"]
    return {"X@GRAD": [g]}


# ---------------------------------------------------------------------------
# sharded-id plumbing (reference distributed_ops/split_ids_op.cc: shard =
# id % n; merge_ids_op.cc restores the original order)
# ---------------------------------------------------------------------------


@register("split_ids", no_grad=True)
def _split_ids(ctx, ins, attrs):
    """Each of the N outputs keeps the full id vector with the other
    shards' slots set to -1 (static shapes)."""
    (ids,) = ins["Ids"]
    flat = ids.reshape(-1)
    n = int(attrs.get("num_shards") or attrs.get("n_parts") or 1)
    neg = torch.full_like(flat, -1)
    return {"Out": [torch.where(torch.remainder(flat, n) == shard, flat, neg)
                    for shard in range(n)]}


@register("merge_ids", no_grad=True)
def _merge_ids(ctx, ins, attrs):
    """Rows[i] holds shard i's lookup result aligned to the original id
    positions; merge selects per position."""
    (ids,) = ins["Ids"]
    rows = ins["X"]
    flat = ids.reshape(-1).to(torch.int32)
    n = len(rows)
    out = rows[0]
    for shard in range(1, n):
        sel = (torch.remainder(flat, n) == shard).reshape((-1,) + (1,) * (rows[0].dim() - 1))
        out = torch.where(sel, rows[shard], out)
    return {"Out": [out]}


@register("split_byref")
def _split_byref(ctx, ins, attrs):
    """Row-section split (reference split_byref_op.cc)."""
    (x,) = ins["X"]
    outs, start = [], 0
    for s in (int(s) for s in attrs["sections"]):
        outs.append(x[start:start + s])
        start += s
    return {"Out": outs}


@register_host("prefetch")
def _prefetch(op, scope):
    """Remote sparse-table row fetch (reference distributed_ops/prefetch_op.cc
    + parameter_prefetch.cc:26): send the id vector, receive the rows. Served
    by the pserver's __prefetch__ GET channel (distributed/listen_and_serv.py)."""
    from ..distributed.rpc import RPCClient
    from ..executor import to_tensor

    client = RPCClient.instance(int(op.attrs.get("trainer_id", 0)))
    in_names = op.input("X")
    out_names = op.output("Out")
    epmap = op.attrs["epmap"]
    table = op.attrs.get("table_name")
    if not table:
        names = op.attrs.get("table_names")
        table = names[0] if isinstance(names, (list, tuple)) and names else ""
    for ids_name, out_name, ep in zip(in_names, out_names, epmap):
        ids = scope.find_var(ids_name)
        ids = ids.reshape(-1) if isinstance(ids, torch.Tensor) else np.asarray(ids).reshape(-1)
        client.async_send_var(ep, "__prefetch_ids__:%s:%s" % (table, out_name), ids)
    client.wait()
    futures = [
        (out_name, ep, client.async_get_var(ep, "__prefetch_out__:%s:%s" % (table, out_name)))
        for out_name, ep in zip(out_names, epmap)
    ]
    for out_name, ep, f in futures:
        rows = f.result(timeout=client.timeout)
        if rows is None:
            raise RuntimeError("prefetch: pserver %s returned no rows" % ep)
        scope.set_var(out_name, to_tensor(rows, scope.device))


@register_host("gen_nccl_id")
def _gen_nccl_id(op, scope):
    """Collective rendezvous (reference gen_nccl_id_op.cc gossiped an
    ncclUniqueId over a temporary gRPC server). Here torch.distributed's
    process-group init owns rendezvous (parallel/multihost.py
    init_distributed, at process start), so this op is a checked no-op kept
    so transpiled NCCL2-mode startup programs execute."""
    slot = "NCCLID" if op.outputs.get("NCCLID") else "Out"
    for out in op.output(slot):
        scope.set_var(out, torch.zeros((1,), dtype=torch.int32, device=scope.device))


# program-compat markers for the reader ops (reference reader/read_op.cc):
# not compute, skipped by every block form
for _t in (
    "read",
    "create_custom_reader",
    "create_recordio_file_reader",
    "create_shuffle_reader",
    "create_batch_reader",
    "create_double_buffer_reader",
    "create_py_reader",
    "open_files",
):
    register_no_lower(_t)
