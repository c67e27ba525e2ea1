"""Sparse (SelectedRows) gradient and per-row optimizer ops (the torch
counterpart of paddle_tpu/ops/sparse_ops.py).

Reference analog: the is_sparse=True path of lookup_table_grad_op
(lookup_table_op.h LookupTableGradKernel's SelectedRows branch), the sparse
functors in operators/optimizers (sgd_op.h SparseSGDFunctor, adam_op.h
SparseAdamFunctor lazy_mode, adagrad_op.h SparseAdagradFunctor), and
merge_add (math/selected_rows_functor.cc). The dense path reads and writes
the whole (rows, dim) table and every moment each step; the sparse path
touches (ids a batch, dim) rows of each.

- `lookup_table_grad_sparse` emits the SelectedRows pair (embedding/
  selected_rows.py): values in the cotangent's dtype and int32 global row
  ids (ROW_SENTINEL for masked and padding slots). No table-shaped tensor
  exists in its lowering.
- `{sgd,adagrad,adam}_sparse` merge duplicate rows in f32, gather the
  touched param and moment rows, update them in f32 and scatter them back
  in their storage dtype, in place (the table and moments are the ops'
  ParamOut / MomentOut under the same names, as the optimizers emit them).
  Under a ParallelExecutor whose mesh gives the op's `axis_name` (ep) an
  extent above 1, the table and its moments are this rank's row shard:
  each rank updates the touched rows it holds (the JAX package's
  shard_map branch). The (rows, values) pair is the global batch's: the
  executor all-gathers it over dp before the optimizer runs, as GSPMD
  made it global in the JAX package.
- `selected_rows_to_dense` densifies for optimizers without a sparse
  kernel (momentum, rmsprop, ...), the reference's SelectedRows ->
  LoDTensor merge before a dense update.

Adam here is the reference's lazy_mode: untouched rows' moments do not
decay that step (their params do not move either). SGD and Adagrad sparse
updates are the dense math restricted to touched rows.

These are plain torch ops, as the JAX package computes them outside any
Pallas kernel. Each one keeps a static shape and syncs nothing with the
host, so a sparse step captures as one CUDA graph.

The grad maker for lookup_table lives here too: it chooses sparse or dense
per op instance (the is_sparse attr, and the table must have exactly ONE
differentiable consumer; a twice-used table falls back to the dense
scatter-add).
"""

import torch

from ..embedding.selected_rows import (
    ROW_SENTINEL,
    densify,
    mark_selected_rows,
    merge_rows,
    rows_var_name,
)
from ..framework import OpRole, grad_var_name
from .registry import OPS, mesh_over, register

__all__ = ["SPARSE_OPTIMIZER_TYPES"]

# optimizer op types with a per-row sparse lowering; everything else densifies
SPARSE_OPTIMIZER_TYPES = {
    "sgd": "sgd_sparse",
    "adagrad": "adagrad_sparse",
    "adam": "adam_sparse",
}


def _gauges(param, height, dim, cap, vbytes, tbytes):
    """Embedding gauges of the observability registry, set at each lowering
    (a captured graph sets them at its capture). `cap` is the step's id-slot
    capacity, the upper bound on rows touched (the exact unique count is
    data-dependent and would need a host sync)."""
    try:
        from ..observability.registry import default_registry

        reg = default_registry()
        lbl = {"table": str(param)}
        if cap is not None:
            reg.gauge(
                "embedding/rows_touched_per_step",
                help="id slots per step (upper bound on unique touched rows)",
            ).set(float(cap), **lbl)
            reg.gauge(
                "embedding/sparse_grad_bytes",
                help="bytes of the SelectedRows gradient per step",
            ).set(float(cap * dim * vbytes + cap * 4), **lbl)
            reg.gauge(
                "embedding/dense_grad_bytes",
                help="bytes a dense gradient of this table would be",
            ).set(float(height * dim * vbytes), **lbl)
        if tbytes is not None:
            reg.gauge(
                "embedding/table_bytes_per_shard",
                help="per-device bytes of the table",
            ).set(float(tbytes), **lbl)
    except Exception:
        pass  # observability must never break a step


# --------------------------------------------------------------------------
# sparse gradient op
# --------------------------------------------------------------------------


def _sparse_grad_infer(op, block):
    """(capacity, dim) values and (capacity,) rows; capacity is ids.size,
    -1 while the batch dim is dynamic."""
    w = block._var_recursive(op.inputs["W"][0])
    ids = block._var_recursive(op.inputs["Ids"][0])
    dim = int(w.shape[1])
    n, dyn = 1, False
    for d in ids.shape:
        if d == -1:
            dyn = True
        else:
            n *= int(d)
    n = -1 if dyn else n
    gv = block._var_recursive(op.outputs["W@GRAD"][0])
    gv.shape = (n, dim)
    rv = block._var_recursive(op.outputs["Rows"][0])
    rv.shape = (n,)
    rv.dtype = "int32"


@register("lookup_table_grad_sparse", no_grad=True, infer_shape=_sparse_grad_infer)
def _lookup_table_grad_sparse(ctx, ins, attrs):
    """d(loss)/d(W) as SelectedRows: every id slot becomes one (row, value)
    pair; masked slots (negative ids, padding_idx) get ROW_SENTINEL so the
    optimizer ignores them. W contributes its shape only."""
    (w,) = ins["W"]
    (ids,) = ins["Ids"]
    (dout,) = ins["Out@GRAD"]
    dim = w.shape[1]
    flat = ids.reshape(-1).to(torch.int32)
    vals = dout.reshape(-1, dim)
    invalid = flat < 0
    padding_idx = int(attrs.get("padding_idx", -1))
    if padding_idx != -1:
        pad = padding_idx if padding_idx >= 0 else padding_idx + w.shape[0]
        invalid = invalid | (flat == pad)
    rows = torch.where(invalid, torch.full_like(flat, ROW_SENTINEL), flat)
    if ctx.device.type != "meta":
        _gauges(attrs.get("param", "?"), int(w.shape[0]), int(dim), int(flat.shape[0]),
                vals.element_size(), None)
    return {"W@GRAD": [vals], "Rows": [rows]}


@register("selected_rows_to_dense", no_grad=True)
def _selected_rows_to_dense(ctx, ins, attrs):
    (vals,) = ins["X"]
    (rows,) = ins["Rows"]
    return {"Out": [densify(rows, vals, int(attrs["height"]))]}


# --------------------------------------------------------------------------
# per-row optimizer updates
# --------------------------------------------------------------------------


def _row_update(table, states, uniq, summed, height, compute, offset=0):
    """Gather the touched rows of the table and its states, apply `compute`
    in f32, and scatter the results back in their storage dtypes, in place.
    A row-shard table holds global rows [offset, offset + its rows); rows
    outside it are another rank's.

    The JAX lowering scatters with mode="drop", sending the invalid slots
    (sentinel -> height, the unused unique slots, another shard's rows) out
    of bounds. A torch scatter has no drop mode short of a host-synced
    boolean index, so here every invalid slot writes to one anchor row the
    same bits that the anchor's own slot writes: the first valid slot's row
    (slot 0 on a whole table, which holds the smallest row id, valid
    whenever any slot is), or, when no slot is valid, row 0 its own
    unchanged value. Duplicate writes of identical bits leave the result
    independent of their order."""
    local = uniq - offset
    valid = (uniq < height) & (local >= 0) & (local < table.shape[0])
    first = torch.argmax(valid.to(torch.int32)).reshape(1)
    anchor = torch.where(valid[first], local[first], torch.zeros_like(local[first]))
    gidx = torch.where(valid, local, anchor).long()
    rows_in = [torch.index_select(t, 0, gidx) for t in [table] + list(states)]
    p_rows = rows_in[0].float()
    s_rows = [r.float() for r in rows_in[1:]]
    new_p, new_s = compute(p_rows, s_rows, summed)
    vmask = valid[:, None]
    for t, old, new in zip([table] + list(states), rows_in, [new_p] + list(new_s)):
        new = new.to(t.dtype)
        # what the anchor's slot writes
        keep = torch.where(vmask[first], new[first], old[first])
        t.index_put_((gidx,), torch.where(vmask, new, keep))
    return (table, *states)


def _owned(ctx, ins, slots, out_slots):
    """The state tensors the op may update in place: an input whose output
    slot names the same var (as the optimizers always emit them) is updated
    in place; any other is cloned first."""
    op = ctx.op
    out = []
    for slot, oslot in zip(slots, out_slots):
        t = ins[slot][0]
        same = (op is not None and op.inputs.get(slot) and op.outputs.get(oslot)
                and op.inputs[slot][0] == op.outputs[oslot][0])
        out.append(t if same and t.is_contiguous() else t.clone(
            memory_format=torch.contiguous_format))
    return out


def _sparse_apply(ctx, ins, attrs, state_slots, out_slots, make_compute):
    """The shared body of the *_sparse optimizer ops. state_slots name the
    row-aligned moment inputs, out_slots the outputs (ParamOut first);
    make_compute(attrs, lr) returns the f32 per-row math. On a mesh whose
    `axis_name` extent is above 1 the table and states are this rank's row
    shard."""
    (vals,) = ins["Grad"]
    (rows,) = ins["GradRows"]
    lr = ins["LearningRate"][0].reshape(()).float()
    table, *states = _owned(ctx, ins, ("Param",) + tuple(state_slots), out_slots)
    axis = attrs.get("axis_name") or None
    mesh = mesh_over(ctx, axis) if axis else None
    shards = mesh.axis_size(axis) if mesh is not None else 1
    height = int(table.shape[0]) * shards
    if ctx.device.type == "meta":
        return (table, *states)
    # merge duplicate ids once, in f32: O(cap) work against the dense path's
    # table-wide scatter
    uniq, summed = merge_rows(rows, vals, height)
    _gauges(attrs.get("param", "?"), height, int(table.shape[1]), None, vals.element_size(),
            int(table.shape[0]) * int(table.shape[1]) * table.element_size())
    offset = mesh.index(axis) * int(table.shape[0]) if mesh is not None else 0
    return _row_update(table, states, uniq, summed, height, make_compute(attrs, lr), offset)


def _pack(outs, out_slots):
    return {slot: [v] for slot, v in zip(out_slots, outs)}


@register("sgd_sparse", no_grad=True, infer_shape=lambda op, block: None)
def _sgd_sparse(ctx, ins, attrs):
    """Per-row SGD: the dense sgd math restricted to touched rows (untouched
    rows are unchanged in both), so sparse and dense SGD training give the
    same bits on f32 tables."""

    def make(attrs, lr):
        def compute(p_rows, s_rows, g):
            return p_rows - lr * g, []

        return compute

    slots = ("ParamOut",)
    return _pack(_sparse_apply(ctx, ins, attrs, (), slots, make), slots)


@register("adagrad_sparse", no_grad=True, infer_shape=lambda op, block: None)
def _adagrad_sparse(ctx, ins, attrs):
    def make(attrs, lr):
        eps = attrs.get("epsilon", 1e-6)

        def compute(p_rows, s_rows, g):
            (mom,) = s_rows
            mom_out = mom + torch.square(g)
            return p_rows - lr * g / (torch.sqrt(mom_out) + eps), [mom_out]

        return compute

    slots = ("ParamOut", "MomentOut")
    return _pack(_sparse_apply(ctx, ins, attrs, ("Moment",), slots, make), slots)


@register("adam_sparse", no_grad=True, infer_shape=lambda op, block: None)
def _adam_sparse(ctx, ins, attrs):
    """Lazy Adam (reference adam_op.h SparseAdamFunctor, lazy_mode=True):
    moments of untouched rows are frozen, not decayed. The beta pows
    advance globally through the optimizer's _finish_update scale ops, as
    for dense Adam."""
    b1p = ins["Beta1Pow"][0].reshape(()).float()
    b2p = ins["Beta2Pow"][0].reshape(()).float()

    def make(attrs, lr):
        b1 = attrs.get("beta1", 0.9)
        b2 = attrs.get("beta2", 0.999)
        eps = attrs.get("epsilon", 1e-8)
        lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)

        def compute(p_rows, s_rows, g):
            m1, m2 = s_rows
            m1o = b1 * m1 + (1 - b1) * g
            m2o = b2 * m2 + (1 - b2) * torch.square(g)
            p_out = p_rows - lr_t * m1o / (torch.sqrt(m2o) + eps)
            return p_out, [m1o, m2o]

        return compute

    slots = ("ParamOut", "Moment1Out", "Moment2Out")
    return _pack(_sparse_apply(ctx, ins, attrs, ("Moment1", "Moment2"), slots, make), slots)


# --------------------------------------------------------------------------
# grad maker: sparse or dense per lookup instance
# --------------------------------------------------------------------------


def _forward_consumers(block, w_name):
    """Differentiable forward-role ops reading w_name (backward and optimize
    ops excluded by role bit: by maker time the block already holds the
    grad ops appended for later program positions)."""
    n = 0
    for o in block.ops:
        role = int(o.attrs.get(OpRole.OP_ROLE_KEY, 0) or 0)
        if role & (OpRole.Backward | OpRole.Optimize):
            continue
        if w_name in o.input_arg_names:
            n += 1
    return n


def _lookup_grad_maker(op, block, grad_map):
    """Grad of lookup_table (the JAX package's maker).

    is_sparse=True AND a single differentiable consumer of the table: the
    SelectedRows pair through lookup_table_grad_sparse. Otherwise the dense
    f32 scatter-add (lookup_table_grad): a table looked up twice needs its
    contributions summed, which backward.py does densely."""
    w_name = op.inputs["W"][0]
    ids_name = op.inputs["Ids"][0]
    out_name = op.outputs["Out"][0]
    g_out = grad_map.get(out_name)
    g_w = grad_map.get(w_name)
    if g_out is None or g_w is None:
        return []
    attrs = {
        "padding_idx": int(op.attrs.get("padding_idx", -1)),
        "param": w_name,
        OpRole.OP_ROLE_VAR_KEY: [w_name, g_w],
    }
    if op.type == "distributed_lookup_table":
        attrs["axis_name"] = op.attrs.get("axis_name", "ep")
    w_var = block._var_recursive(w_name)
    sparse_ok = (
        bool(op.attrs.get("is_sparse", False))
        and g_w == grad_var_name(w_name)
        and _forward_consumers(block, w_name) == 1
    )
    if not sparse_ok:
        return [
            {
                "type": "lookup_table_grad",
                "inputs": {
                    "W": [w_name],
                    "Ids": [ids_name],
                    "Out@GRAD": [g_out],
                },
                "outputs": {"W@GRAD": [g_w]},
                "attrs": attrs,
            }
        ]
    rows_name = rows_var_name(g_w)
    if not block.has_var(rows_name):
        rv = block.create_var(
            name=rows_name,
            shape=[-1],
            dtype="int32",
            persistable=False,
        )
        rv.stop_gradient = True
    g_var = block._var_recursive(g_w)
    mark_selected_rows(g_var, rows_name, int(w_var.shape[0]))
    return [
        {
            "type": "lookup_table_grad_sparse",
            "inputs": {"W": [w_name], "Ids": [ids_name], "Out@GRAD": [g_out]},
            "outputs": {"W@GRAD": [g_w], "Rows": [rows_name]},
            "attrs": attrs,
        }
    ]


# attach to the registered lookup ops (core_ops.py owns the forward
# lowering; the maker is the backward policy layer). The JAX package's
# `embedding` and `distributed_lookup_table` types are not registered here.
for _t in ("lookup_table", "embedding", "distributed_lookup_table"):
    if _t in OPS:
        OPS[_t].grad = _lookup_grad_maker
