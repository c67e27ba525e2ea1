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

Layouts (parallel/sharding_rules.py: tp and fsdp) take four more forms,
each differentiable by torch.autograd (a pipeline stage's backward runs
through them): `gather_dim` / `scatter_dim` put a tensor split along one
dimension over a set of axes together, or keep this rank's piece of it
(backward: reduce-scatter / all-gather); `copy_to_axes` and
`reduce_from_axes` are Megatron's pair, the identity forward with an
all-reduce backward and its mirror. `send_recv` is the pipeline's point
to point exchange between neighbours (one NCCL group call, so the two
directions of a pair never wait on each other). Each collective a layout
or a pipeline issues is counted in ops.fused.COLLECTIVES, by kind and
axes, and a CUDA graph counts what its capture issued at every replay.

The scope-state helpers at the end keep sharded state (ZeRO-1 moments, an
ep-sharded table and its moments, a parameter and its moments placed by a
sharding rule): `Scope.row_shards` names each such variable with its mesh
and its axis (rows) or spec (a layout), `shard_state` cuts a whole value
down to this rank's piece, `gathered_state` puts the whole value back
together, which save_persistables and EmbeddingEngine.save_sharded write,
and `reshard_state` sets a piece from a whole value.
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
    "copy_to_axes",
    "gather_dim",
    "gathered_state",
    "ppermute_shift",
    "reduce_from_axes",
    "reduce_scatter",
    "reshard_state",
    "scatter_dim",
    "send_recv",
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
# layouts: one dimension split over a set of axes
# ---------------------------------------------------------------------------


def note(kind, axes):
    """Count one collective of `kind` over `axes` (ops.fused.COLLECTIVES)."""
    from ..ops import fused

    key = "%s:%s" % (kind, "+".join((axes,) if isinstance(axes, str) else axes))
    fused.COLLECTIVES[key] = fused.COLLECTIVES.get(key, 0) + 1


def _gather(x, axes, dim, mesh):
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _all_gather(out, src, group=mesh.group(axes))
    note("all_gather", axes)
    order = mesh.group_order(axes)
    if order != list(range(n)):
        pieces = out.chunk(n, 0)
        placed = [None] * n
        for g, i in enumerate(order):
            placed[i] = pieces[g]
        out = torch.cat(placed, 0)
    return out.movedim(0, dim)


def _piece(x, axes, dim, mesh):
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError("dim %d of %s does not split over %s (%d)"
                         % (dim, tuple(x.shape), axes, n))
    rows = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axes) * rows, rows)


def _scatter_sum(x, axes, dim, mesh):
    """Sum over `axes` of x, this rank's piece along `dim`."""
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    order = mesh.group_order(axes)
    pieces = x.movedim(dim, 0).chunk(n, 0)
    if x.shape[dim] % n:
        raise ValueError("dim %d of %s does not split over %s (%d)"
                         % (dim, tuple(x.shape), axes, n))
    src = torch.cat([pieces[i] for i in order], 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _reduce_scatter(out, src, group=mesh.group(axes))
    note("reduce_scatter", axes)
    return out.movedim(0, dim)


def _sum(x, axes, mesh, kind="all_reduce"):
    if mesh.axis_size(axes) == 1:
        return x
    y = x.contiguous().clone()
    dist.all_reduce(y, group=mesh.group(axes))
    note(kind, axes)
    return y


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim, mesh):
        ctx.args = (axes, dim, mesh)
        return _gather(x, axes, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, *ctx.args), None, None, None


class _ScatterDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim, mesh):
        ctx.args = (axes, dim, mesh)
        return _piece(x, axes, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.args = (axes, mesh)
        return x

    @staticmethod
    def backward(ctx, g):
        return _sum(g, *ctx.args), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        return _sum(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def gather_dim(x, axes, dim, mesh=None):
    """x split along `dim` over `axes` (an axis or a tuple, the first
    outermost), put together on every rank; its gradient is reduce-scattered
    back to the pieces."""
    return _GatherDim.apply(x, axes, dim, _mesh(mesh))


def scatter_dim(x, axes, dim, mesh=None):
    """This rank's piece of a whole x along `dim` over `axes`; its gradient
    is all-gathered."""
    return _ScatterDim.apply(x, axes, dim, _mesh(mesh))


def copy_to_axes(x, axes, mesh=None):
    """Megatron's f: the identity forward, the gradient all-reduced over
    `axes` (a column-parallel product's replicated input)."""
    return _CopyTo.apply(x, axes, _mesh(mesh))


def reduce_from_axes(x, axes, mesh=None):
    """Megatron's g: x all-reduced over `axes` (a row-parallel product's
    partial sums), the gradient passed through."""
    return _ReduceFrom.apply(x, axes, _mesh(mesh))


def send_recv(sends=(), recvs=(), group=None):
    """One group call of point-to-point transfers: `sends` are (tensor,
    global rank) pairs, `recvs` (shape, dtype, device, global rank) tuples;
    returns the received tensors, in order. Every send is matched by a recv
    of the same shape posted by its peer in the same group call."""
    ops, outs = [], []
    for t, peer in sends:
        ops.append(dist.P2POp(dist.isend, t.contiguous(), peer, group))
    for shape, dtype, device, peer in recvs:
        out = torch.empty(shape, dtype=dtype, device=device)
        outs.append(out)
        ops.append(dist.P2POp(dist.irecv, out, peer, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        from ..ops import fused

        fused.COLLECTIVES["send"] = fused.COLLECTIVES.get("send", 0) + len(sends)
        fused.COLLECTIVES["recv"] = fused.COLLECTIVES.get("recv", 0) + len(recvs)
    return outs


def spec_of(entry, ndim):
    """The per-dimension layout of a Scope.row_shards entry's second half:
    an axis name (rows) or a spec tuple, padded with None to `ndim`."""
    spec = (entry,) if isinstance(entry, str) else tuple(entry)
    return spec + (None,) * (ndim - len(spec))


def slice_to(x, spec, mesh):
    """This rank's piece of a whole x under `spec` (one entry a dimension:
    None, an axis or a tuple of axes)."""
    for dim, entry in enumerate(spec):
        if entry is not None:
            x = _piece(x, entry, dim, mesh)
    return x


def gather_spec(x, spec, mesh):
    """The whole value of a piece x under `spec`."""
    for dim, entry in enumerate(spec):
        if entry is not None:
            x = _gather(x, entry, dim, mesh)
    return x


# ---------------------------------------------------------------------------
# sharded scope state
# ---------------------------------------------------------------------------


def shard_state(scope, name, mesh, axis_name):
    """Keep only this rank's piece of the scope's whole `name` and record
    it in scope.row_shards: `axis_name` an axis (rows [i*R/n, (i+1)*R/n) at
    axis index i) or a spec tuple (a rule's layout). A name already sharded
    is left as it is."""
    if name in scope.row_shards:
        return
    full = scope.vars[name]
    scope.vars[name] = slice_to(full, spec_of(axis_name, full.dim()), mesh).clone()
    scope.row_shards[name] = (mesh, axis_name)


def gathered_state(scope, name):
    """The whole value of the scope's `name`: its pieces all-gathered for a
    sharded name (every rank of its axes must call), else the value
    itself."""
    val = scope.vars[name]
    entry = scope.row_shards.get(name)
    if entry is None:
        return val
    mesh, axis_name = entry
    return gather_spec(val, spec_of(axis_name, val.dim()), mesh)


def reshard_state(scope, name, full):
    """Set a sharded `name` from a whole value (a checkpoint's): this
    rank's piece of it, in the dtype and on the device of the piece it
    replaces."""
    mesh, axis_name = scope.row_shards[name]
    cur = scope.vars[name]
    spec = spec_of(axis_name, cur.dim())
    want = tuple(d * (mesh.axis_size(e) if e is not None else 1)
                 for d, e in zip(cur.shape, spec))
    if tuple(full.shape) != want:
        raise ValueError("%s: a whole value of shape %s for pieces of %s under %s"
                         % (name, tuple(full.shape), tuple(cur.shape), spec))
    part = slice_to(full, spec, mesh)
    scope.vars[name] = part.to(device=cur.device, dtype=cur.dtype).clone()
