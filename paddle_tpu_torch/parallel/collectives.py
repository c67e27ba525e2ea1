"""Collectives over one mesh axis (the counterpart of
paddle_tpu/parallel/collectives.py; the reference's NCCL op handles,
all_reduce_op_handle.cc, reduce_op_handle.cc, broadcast_op_handle.cc).

Each wrapper takes the axis by name and a Mesh (parallel/mesh.py; default
the innermost `with mesh:` block's), runs over that axis's process group
(NCCL on the cards, gloo on the CPU), leaves its input as it was and
returns a new tensor. On an axis of extent 1 it is the identity.

The JAX module's `shard_map`, `constrain_sharded` and
`constrain_replicated` have no counterpart. The JAX package jits one
program over the whole mesh, and those calls tell its partitioner where a
value is split; the collectives follow. Here every rank runs its own
program on its own shard, so a value is only ever this rank's, and the
collectives are written out where they are needed: the ParallelExecutor's
gradient buckets, synchronized batch_norm, ring attention, the row-sharded
embedding and the ZeRO-1 tier.

The scope-state helpers at the end keep row-sharded state (ZeRO-1 moments,
an ep-sharded table and its moments): `Scope.row_shards` names each such
variable with its mesh and axis, `shard_state` cuts a whole value down to
this rank's rows, and `gathered_state` puts the whole value back together,
which save_persistables and EmbeddingEngine.save_sharded write.
"""

import torch
import torch.distributed as dist

from .mesh import current_mesh

__all__ = [
    "all_gather",
    "all_reduce",
    "axis_index",
    "axis_size",
    "broadcast",
    "gathered_state",
    "ppermute_shift",
    "reduce_scatter",
    "reshard_state",
    "shard_state",
    "zero1_shardable",
]

# the collectives' current names (the older ones warn in newer torch)
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _mesh(mesh):
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise RuntimeError("no mesh: pass mesh= or call inside `with mesh:`")
    return mesh


def axis_size(axis_name, mesh=None):
    return _mesh(mesh).axis_size(axis_name)


def axis_index(axis_name, mesh=None):
    return _mesh(mesh).index(axis_name)


def all_reduce(x, axis_name, op="sum", mesh=None):
    """Sum (or max, min, mean) of x over the axis, on every rank."""
    mesh = _mesh(mesh)
    if op not in ("sum", "max", "min", "mean"):
        raise ValueError("unknown reduce op %r" % op)
    n = mesh.axis_size(axis_name)
    if n == 1:
        return x.clone()
    y = x.contiguous().clone()
    rop = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}.get(op, dist.ReduceOp.SUM)
    dist.all_reduce(y, op=rop, group=mesh.group(axis_name))
    return y / n if op == "mean" else y


def all_gather(x, axis_name, axis=0, tiled=True, mesh=None):
    """The ranks' x in axis order, concatenated along `axis` (tiled) or
    stacked on a new leading axis."""
    mesh = _mesh(mesh)
    n = mesh.axis_size(axis_name)
    if n == 1:
        return x.clone() if tiled else x.unsqueeze(0).clone()
    src = (x.movedim(axis, 0) if tiled else x.unsqueeze(0)).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _all_gather(out, src, group=mesh.group(axis_name))
    return out.movedim(0, axis) if tiled else out


def reduce_scatter(x, axis_name, axis=0, mesh=None):
    """Sum over the axis of x, split along `axis`: this rank's 1/n block."""
    mesh = _mesh(mesh)
    n = mesh.axis_size(axis_name)
    if n == 1:
        return x.clone()
    src = x.movedim(axis, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError("reduce_scatter: dim %d of %s does not split over %d ranks"
                         % (axis, tuple(x.shape), n))
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _reduce_scatter(out, src, group=mesh.group(axis_name))
    return out.movedim(0, axis)


def ppermute_shift(x, axis_name, shift=1, mesh=None):
    """Rotate shards around the ring: each rank sends x to index + shift and
    returns what index - shift sent."""
    mesh = _mesh(mesh)
    n = mesh.axis_size(axis_name)
    if n == 1 or shift % n == 0:
        return x.clone()
    group = mesh.group(axis_name)
    me = mesh.index(axis_name)
    src = x.contiguous()
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, dist.get_global_rank(group, (me + shift) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (me - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def broadcast(x, axis_name, root=0, mesh=None):
    """The axis index `root`'s x, on every rank."""
    mesh = _mesh(mesh)
    if mesh.axis_size(axis_name) == 1:
        return x.clone()
    group = mesh.group(axis_name)
    y = x.contiguous().clone()
    dist.broadcast(y, src=dist.get_global_rank(group, root), group=group)
    return y


def zero1_shardable(shape, mesh, axis_name):
    """True iff an array of `shape` can hold a 1/axis shard per rank: the
    leading dim divides evenly over the axis extent. Scalars and the shape-[1]
    optimizer scalars (LearningRate, Beta*Pow) are excluded by construction —
    they stay replicated, which keeps their update math identical to the
    all-reduce path."""
    n = mesh.shape.get(axis_name, 1)
    return n > 1 and len(shape) >= 1 and shape[0] % n == 0


# ---------------------------------------------------------------------------
# row-sharded scope state
# ---------------------------------------------------------------------------


def shard_state(scope, name, mesh, axis_name):
    """Keep only this rank's rows of the scope's whole `name` (rows
    [i*R/n, (i+1)*R/n) at axis index i) and record it in scope.row_shards.
    A name already sharded is left as it is."""
    if name in scope.row_shards:
        return
    full = scope.vars[name]
    n = mesh.axis_size(axis_name)
    rows = full.shape[0] // n
    scope.vars[name] = full.narrow(0, mesh.index(axis_name) * rows, rows).clone()
    scope.row_shards[name] = (mesh, axis_name)


def gathered_state(scope, name):
    """The whole value of the scope's `name`: its shards all-gathered over
    their axis for a row-sharded name (every rank of the axis must call),
    else the value itself."""
    val = scope.vars[name]
    entry = scope.row_shards.get(name)
    if entry is None:
        return val
    mesh, axis_name = entry
    return all_gather(val, axis_name, 0, mesh=mesh)


def reshard_state(scope, name, full):
    """Set a row-sharded `name` from a whole value (a checkpoint's): this
    rank's rows of it, in the dtype and on the device of the shard it
    replaces."""
    mesh, axis_name = scope.row_shards[name]
    cur = scope.vars[name]
    rows = cur.shape[0]
    if full.shape[0] != rows * mesh.axis_size(axis_name):
        raise ValueError("%s: a whole value of %d rows for %d shards of %d"
                         % (name, full.shape[0], mesh.axis_size(axis_name), rows))
    part = full.narrow(0, mesh.index(axis_name) * rows, rows)
    scope.vars[name] = part.to(device=cur.device, dtype=cur.dtype).clone()
