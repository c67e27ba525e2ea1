"""Control-flow ops: while / conditional_block / recurrent / tensor arrays
and the rank-table ops (the torch counterparts of
paddle_tpu/ops/control_flow_ops.py).

The JAX package lowers a sub-block into the enclosing XLA computation with
lax.while_loop, lax.scan and lax.cond. torch has none of these, so here:

- ``while`` with ``maximum_iterations`` set is a Python loop of that fixed
  length; each iteration runs the body and selects every carried value with
  torch.where on the device-side condition, as the JAX package's masked
  lax.scan does. It reads nothing on the host, so its block captures as a
  CUDA graph, and the generic vjp grad differentiates through it.
- ``while`` without ``maximum_iterations`` (open-ended) reads its condition
  on the host after each iteration, as the reference's while_op did. A read
  on the host cannot be captured: the executor runs a block that holds such
  a loop op by op and counts it under "open_ended_while"
  (`Executor.stats()["op_by_op"]`).
- ``conditional_block`` always runs its branch, then selects each written
  value with torch.where(pred, branch value, prior value): lax.cond's
  outputs with no read on the host, so the block still captures. Unlike
  lax.cond, the untaken branch runs too, so its ops must not fault on the
  values they see when the predicate is false; the array ops below clamp
  their index for that reason (as lax.dynamic_update_slice and
  lax.dynamic_index_in_dim clamp theirs).
- ``recurrent`` (StaticRNN / DynamicRNN) is a Python loop over the static
  time axis, with the JAX package's per-row masks.
- A tensor array is a (buffer [capacity, ...], size) pair of device tensors,
  as in the JAX package. Writes and reads index the buffer with a device
  index (index_copy / index_select), never through a host read.

Every sub-block op lowers with the parent's LowerCtx, so its per-op cache
entry (LowerCtx.op_constant, seeded_generator) is keyed on the sub-block op
and shared by every iteration: a constant is uploaded once, and a random op
with a pinned seed draws the same numbers every iteration, as the JAX
package's key(seed) does; an unseeded one draws afresh each iteration from
the run's generator.
"""

import numpy as np
import torch

from .registry import EMPTY_VAR_NAME, lower_ops, register, set_var_meta, torch_dtype

# the framework's int64, canonicalized (int32), for lengths and indices
_I64 = torch_dtype("int64")


def _noop_infer(op, block):
    """No build-time inference: the output is a tensor array, whose buffer
    shape lives in its value (the JAX package's NOOP_INFER_REASONS)."""
    return None


def _copy_meta(block, src_name, dst_name):
    if EMPTY_VAR_NAME in (src_name, dst_name) or src_name == dst_name:
        return
    if not (block.has_var_recursive(src_name) and block.has_var_recursive(dst_name)):
        return
    src = block._var_recursive(src_name)
    dst = block._var_recursive(dst_name)
    if src.shape is not None:
        dst.shape = tuple(src.shape)
    if src.dtype is not None:
        dst.dtype = src.dtype
    dst.lod_level = getattr(src, "lod_level", 0)


def _pred(x):
    return x.reshape(()).to(torch.bool)


def _select(pred, new, old):
    """torch.where over a value or a tensor array's (buffer, size) pair,
    the new value cast to the old one's dtype."""
    if isinstance(old, tuple):
        return tuple(_select(pred, n, o) for n, o in zip(new, old))
    return torch.where(pred, new.to(old.dtype), old)


def _mask_rows(active, new, old):
    """Per batch row, new where active else old ([B, ...] tensors)."""
    return torch.where(active.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def walk_ops(ops):
    """The ops and, depth first, the ops of their sub-blocks."""
    for op in ops:
        yield op
        sub = op.attrs.get("sub_block")
        if sub is not None:
            yield from walk_ops(sub.ops)


def is_open_ended_while(op):
    return op.type == "while" and not (op.attrs.get("maximum_iterations") or 0)


def _while_infer(op, block):
    """`while` outputs alias their carried input names, whose metadata the
    sub-block's ops set as it was built; validate the contract instead."""
    attrs = op.attrs
    carried = list(attrs.get("carried_names", ()))
    x_names = set(attrs.get("x_names", ()))
    missing = [n for n in carried if n not in x_names]
    if missing:
        raise ValueError(
            "while op: carried names %s are not in x_names — the loop would "
            "have no initial value for them" % missing
        )
    if attrs.get("cond_name") not in carried:
        raise ValueError(
            "while op: condition %r is not loop-carried — the loop could "
            "never terminate" % attrs.get("cond_name")
        )


@register("while", infer_shape=_while_infer)
def _while(ctx, ins, attrs):
    sub = attrs["sub_block"]
    carried = list(attrs["carried_names"])
    cond_name = attrs["cond_name"]
    max_iters = int(attrs.get("maximum_iterations") or 0)

    env = dict(zip(attrs["x_names"], ins["X"]))
    closure = {n: v for n, v in env.items() if n not in carried}
    vals = tuple(env[n] for n in carried)
    cond_idx = carried.index(cond_name)

    def run_body(vals):
        e = dict(closure)
        e.update(zip(carried, vals))
        lower_ops(ctx, sub.ops, e)
        return tuple(e[n] for n in carried)

    if max_iters <= 0:
        # open-ended: the condition is read on the host after every
        # iteration (the executor never captures a block holding this)
        while bool(_pred(vals[cond_idx])):
            vals = run_body(vals)
    else:
        # bounded: a fixed number of iterations; once the condition is
        # false every carried value keeps its old value
        for _ in range(max_iters):
            active = _pred(vals[cond_idx])
            vals = tuple(_select(active, n, o) for n, o in zip(run_body(vals), vals))
    return {"Out": list(vals)}


def _cond_infer(op, block):
    """Validate that every written name also rides x_names: the branch's
    result is selected against its prior value."""
    written = list(op.attrs.get("written_names", ()))
    x_names = set(op.attrs.get("x_names", ()))
    missing = [n for n in written if n not in x_names]
    if missing:
        raise ValueError(
            "conditional_block op: written names %s are not in x_names — "
            "there would be no prior value to keep" % missing
        )


@register("conditional_block", infer_shape=_cond_infer)
def _conditional_block(ctx, ins, attrs):
    """The branch always runs (see the module docstring); each written name
    takes the branch's value where every condition holds, else its prior
    value."""
    sub = attrs["sub_block"]
    written = list(attrs["written_names"])
    env = dict(zip(attrs["x_names"], ins["X"]))
    pred = None
    for c in ins["Cond"]:
        pred = _pred(c) if pred is None else torch.logical_and(pred, _pred(c))
    prior = [env[n] for n in written]
    e = dict(env)
    lower_ops(ctx, sub.ops, e)
    return {"Out": [_select(pred, e[n], p) for n, p in zip(written, prior)]}


def _recurrent_infer(op, block):
    """Stacked output shapes from the sub-block's per-step outputs and the
    time extent of the stacked X input; FinalState from Boot."""
    attrs = op.attrs
    sub = attrs.get("sub_block")
    if sub is None:
        return
    tm = bool(attrs.get("time_major", False))
    taxis = 0 if tm else 1
    t = None
    xs = op.inputs.get("X", ())
    if xs and block.has_var_recursive(xs[0]):
        v = block._var_recursive(xs[0])
        if v.shape is not None and len(v.shape) > taxis:
            t = v.shape[taxis]
    if t is None:
        t = int(attrs.get("length", 0)) or -1
    for step_name, out_name in zip(attrs.get("out_names", ()), op.outputs.get("Out", ())):
        if not sub.has_var_recursive(step_name):
            continue
        o = sub._var_recursive(step_name)
        if o.shape is None:
            continue
        s = list(o.shape)
        set_var_meta(block, out_name, [t] + s if tm else s[:1] + [t] + s[1:], o.dtype)
    for boot_name, final_name in zip(op.inputs.get("Boot", ()), op.outputs.get("FinalState", ())):
        _copy_meta(block, boot_name, final_name)


def _parallel_do_infer(op, block):
    sub = op.attrs.get("sub_block")
    if sub is None:
        return
    for step_name, out_name in zip(op.attrs.get("out_names", ()), op.outputs.get("Out", ())):
        if sub.has_var_recursive(step_name):
            src = sub._var_recursive(step_name)
            set_var_meta(block, out_name, src.shape, src.dtype)


@register("parallel_do", infer_shape=_parallel_do_infer)
def _parallel_do(ctx, ins, attrs):
    """The deprecated intra-graph data-parallel island (reference
    controlflow/parallel_do_op.cc: split the batch across places, run the
    sub-block per device, gather). A ParallelExecutor already gives each
    rank its rows of the batch, so the sub-block runs once over them (on
    one device, over the whole batch), as the JAX package runs it once
    under GSPMD."""
    env = dict(zip(attrs.get("x_names", []), ins.get("X", [])))
    lower_ops(ctx, attrs["sub_block"].ops, env)
    return {"Out": [env[n] for n in attrs.get("out_names", [])]}


@register("recurrent", infer_shape=_recurrent_infer)
def _recurrent(ctx, ins, attrs):
    """A loop over time. Inputs: X stacked sequence inputs, Boot initial
    states, C closure (parameters and the like), SeqLen optional per-row
    lengths: past its length a row keeps its state and outputs zeros."""
    sub = attrs["sub_block"]
    x_names = list(attrs["x_names"])
    pre_names = list(attrs["pre_state_names"])
    new_names = list(attrs["new_state_names"])
    out_names = list(attrs["out_names"])
    time_major = bool(attrs.get("time_major", False))
    taxis = 0 if time_major else 1

    seq = list(ins.get("X", []))
    states = tuple(ins.get("Boot", []))
    closure = dict(zip(attrs.get("closure_names", []), ins.get("C", [])))
    seqlen = ins.get("SeqLen", [None])[0]
    if seqlen is not None:
        seqlen = seqlen.reshape(-1)
    T = seq[0].shape[taxis] if seq else int(attrs["length"])
    order = range(T - 1, -1, -1) if attrs.get("reverse", False) else range(T)
    ys = [None] * T
    for t in order:
        e = dict(closure)
        e.update(zip(pre_names, states))
        e.update(zip(x_names, (v.select(taxis, t) for v in seq)))
        lower_ops(ctx, sub.ops, e)
        new_states = tuple(e[n].to(s.dtype).reshape(s.shape) for n, s in zip(new_names, states))
        outs = tuple(e[n] for n in out_names)
        if seqlen is not None:
            active = seqlen > t
            new_states = tuple(_mask_rows(active, ns, s) for ns, s in zip(new_states, states))
            outs = tuple(_mask_rows(active, o, torch.zeros_like(o)) for o in outs)
        states = new_states
        ys[t] = outs
    stacked = [torch.stack([y[k] for y in ys], dim=taxis) for k in range(len(out_names))]
    return {"Out": stacked, "FinalState": list(states)}


# ---------------------------------------------------------------------------
# tensor arrays: (buffer [capacity, ...], size) pairs
# ---------------------------------------------------------------------------


def _index(i, cap):
    """A write or read index as a 1-element device tensor, clamped into the
    buffer (so an untaken branch's access cannot fault)."""
    return torch.clamp(i.reshape(1).long(), 0, cap - 1)


@register("create_array", infer_shape=_noop_infer)
def _create_array(ctx, ins, attrs):
    shape = attrs.get("shape")
    if not shape:
        return {"Out": [None]}  # the first write_to_array makes the buffer
    buf = torch.zeros(tuple(shape), dtype=torch_dtype(attrs.get("dtype", "float32")),
                      device=ctx.device)
    return {"Out": [(buf, torch.zeros((), dtype=torch.int32, device=ctx.device))]}


@register("write_to_array", infer_shape=_noop_infer)
def _write_to_array(ctx, ins, attrs):
    """A write at a device index. A growable array (no preallocated shape)
    carries static capacity bookkeeping from the layer: ``init_cap`` sizes
    the buffer of a first write, ``grow_slots`` appends just enough rows."""
    (x,) = ins["X"]
    (i,) = ins["I"]
    i = i.reshape(()).to(torch.int32)
    arr = ins.get("Array", [None])[0]
    if arr is None:
        cap = int(attrs.get("init_cap", 1))
        buf = torch.zeros((cap,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        size = torch.clamp(i + 1, min=1)
    else:
        buf, size = arr
        grow = int(attrs.get("grow_slots", 0))
        if grow:
            pad = torch.zeros((grow,) + tuple(x.shape), dtype=buf.dtype, device=buf.device)
            buf = torch.cat([buf, pad], dim=0)
        size = torch.maximum(size, i + 1)
    buf = buf.index_copy(0, _index(i, buf.shape[0]), x[None].to(buf.dtype))
    return {"Out": [(buf, size)]}


@register("read_from_array", infer_shape=_noop_infer)
def _read_from_array(ctx, ins, attrs):
    (arr,) = ins["X"]
    (i,) = ins["I"]
    buf, _ = arr
    return {"Out": [torch.index_select(buf, 0, _index(i, buf.shape[0]))[0]]}


def _scalar_i64_infer(op, block):
    for n in op.outputs.get("Out", ()):
        set_var_meta(block, n, (1,), "int64")


@register("lod_array_length", no_grad=True, infer_shape=_scalar_i64_infer)
def _array_length(ctx, ins, attrs):
    (arr,) = ins["X"]
    return {"Out": [arr[1].reshape((1,)).to(_I64)]}


@register("lod_tensor_to_array", infer_shape=_noop_infer)
def _lod_tensor_to_array(ctx, ins, attrs):
    """Padded [B, T, ...] -> a time-major array buffer [T, B, ...] of size
    T (masking takes the place of the reference's shrinking batches)."""
    (x,) = ins["X"]
    buf = x.transpose(0, 1)
    return {"Out": [(buf, torch.full((), buf.shape[0], dtype=torch.int32, device=x.device))]}


@register("array_to_lod_tensor", infer_shape=_noop_infer)
def _array_to_lod_tensor(ctx, ins, attrs):
    (arr,) = ins["X"]
    return {"Out": [arr[0].transpose(0, 1)]}


def _identity_infer(op, block):
    xs = op.inputs.get("X", ())
    outs = op.outputs.get("Out", ())
    if xs and outs:
        _copy_meta(block, xs[0], outs[0])


@register("shrink_rnn_memory", infer_shape=_identity_infer)
def _shrink_rnn_memory(ctx, ins, attrs):
    # the reference drops finished rows from the batch; the padded form
    # keeps them and masks instead (the recurrent op): the identity
    (x,) = ins["X"]
    return {"Out": [x]}


@register("max_sequence_len", no_grad=True, infer_shape=_scalar_i64_infer)
def _max_sequence_len(ctx, ins, attrs):
    (seqlen,) = ins["X"]
    return {"Out": [torch.amax(seqlen.reshape(-1)).reshape(1).to(_I64)]}


@register("reorder_lod_tensor_by_rank", infer_shape=_identity_infer)
def _reorder_by_rank(ctx, ins, attrs):
    (x,) = ins["X"]
    (rank,) = ins["RankTable"]
    return {"Out": [torch.index_select(x, 0, rank.reshape(-1).long())]}


def _lod_rank_table_infer(op, block):
    xs = op.inputs.get("X", ())
    outs = op.outputs.get("Out", ())
    if not (xs and outs):
        return
    numel = -1
    if block.has_var_recursive(xs[0]):
        v = block._var_recursive(xs[0])
        if v.shape is not None and all(isinstance(d, int) and d >= 0 for d in v.shape):
            numel = 1
            for d in v.shape:
                numel *= d
    set_var_meta(block, outs[0], (numel,), "int64")


@register("lod_rank_table", no_grad=True, infer_shape=_lod_rank_table_infer)
def _lod_rank_table(ctx, ins, attrs):
    """Row indices sorted by sequence length, descending, ties in row order
    (jnp.argsort's stable sort). Input is the SeqLen companion."""
    (seqlen,) = ins["X"]
    return {"Out": [torch.argsort(-seqlen.reshape(-1), stable=True).to(_I64)]}


@register("print", infer_shape=_identity_infer, host_effect=True)
def _print(ctx, ins, attrs):
    """reference print_op.cc, as the JAX package prints: the message, the
    shape, the mean and the first `summarize` values (all of them for
    summarize < 0). It reads its input on the host, so the executor runs it
    between graph segments (OpDef.host_effect), on every run."""
    (x,) = ins["X"]
    if x.device.type == "meta":
        return {"Out": [x]}
    msg = attrs.get("message", "")
    first_n = int(attrs.get("summarize", 20) or 20)
    flat = x.reshape(-1) if first_n < 0 else x.reshape(-1)[: max(first_n, 1)]
    fmt = "%s shape=%s mean={m} first={f}" % (msg, tuple(x.shape))
    flat = flat.detach().cpu()
    if flat.dtype == torch.bfloat16:
        flat = flat.float()  # numpy has no bfloat16
    print(fmt.format(m=np.float32(x.detach().float().mean().item()), f=flat.numpy()),
          flush=True)
    return {"Out": [x]}


@register("print_grad", no_grad=True)
def _print_grad(ctx, ins, attrs):
    """The identity on the cotangent (a print's backward prints nothing)."""
    (g,) = ins["Out@GRAD"]
    return {"X@GRAD": [g]}
