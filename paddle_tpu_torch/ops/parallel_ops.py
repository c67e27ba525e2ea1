"""Mesh-aware graph ops: ring attention and the row-sharded embedding
lookup (the counterpart of paddle_tpu/ops/parallel_ops.py).

Each op takes its distributed form when the executor's mesh (ctx.mesh, a
ParallelExecutor's) gives its axis an extent above 1, and the exact
single-device computation otherwise, so the same program runs anywhere.

ring_attention keeps the op boundary of parallel/ring_attention.py in
both directions: Q, K, V and Out are the same on every sp rank, and so are
the grads of Q, K and V (each rank's chunk all-gathered), so the
parameters upstream see equal gradients across sp. Its explicit grad runs
the ring backward against the global lse, which it recomputes with one
more ring forward (the op declares no Lse output, as in the JAX package).
"""

import torch

from ..embedding.lookup import sharded_embedding_lookup
from ..parallel.ring_attention import attention_plain, sharded_backward, sharded_forward
from .registry import mesh_over, register


def _ring_args(ins, attrs):
    (q,) = ins["Q"]
    (k,) = ins["K"]
    (v,) = ins["V"]
    return q, k, v, bool(attrs.get("causal", False)), attrs.get("axis_name", "sp")


@register("ring_attention")
def _ring_attention(ctx, ins, attrs):
    q, k, v, causal, axis = _ring_args(ins, attrs)
    mesh = mesh_over(ctx, axis)
    if mesh is not None:
        out, _ = sharded_forward(q, k, v, mesh, axis_name=axis, causal=causal)
    else:
        out = attention_plain(q, k, v, causal=causal)
    return {"Out": [out]}


@register("ring_attention_grad", no_grad=True)
def _ring_attention_grad(ctx, ins, attrs):
    """Q@GRAD, K@GRAD, V@GRAD: the ring backward on an sp mesh, else the
    vjp of the plain attention."""
    q, k, v, causal, axis = _ring_args(ins, attrs)
    (dout,) = ins["Out@GRAD"]
    mesh = mesh_over(ctx, axis)
    if mesh is not None:
        (out,) = ins["Out"]
        dq, dk, dv = sharded_backward(q, k, v, out, dout, mesh, axis_name=axis,
                                            causal=causal)
    else:
        _, vjp = torch.func.vjp(lambda a, b, c: attention_plain(a, b, c, causal), q, k, v)
        dq, dk, dv = vjp(dout.to(q.dtype))
    return {"Q@GRAD": [dq], "K@GRAD": [dk], "V@GRAD": [dv]}


@register("distributed_lookup_table")
def _distributed_lookup_table(ctx, ins, attrs):
    """Forward of EmbeddingEngine.lookup: the row-sharded gather + all-reduce
    over `axis_name` when the mesh has it (W is then this rank's rows),
    otherwise the exact dense lookup. Negative ids and padding_idx give zero
    rows, in the table's dtype, as lookup_table does, so the sharded and
    the single-device forms give the same bits."""
    (w,) = ins["W"]
    (ids,) = ins["Ids"]
    axis = attrs.get("axis_name", "ep")
    padding_idx = int(attrs.get("padding_idx", -1))
    flat = ids.reshape(ids.shape[:-1]) if ids.shape[-1] == 1 else ids
    mesh = mesh_over(ctx, axis)
    if mesh is not None:
        out = sharded_embedding_lookup(w, flat, mesh, axis_name=axis,
                                       padding_idx=padding_idx if padding_idx != -1 else None)
        return {"Out": [out]}
    fl = flat.reshape(-1).to(torch.int64)
    out = torch.index_select(w, 0, fl.clamp(min=0))
    mask = fl < 0
    if padding_idx != -1:
        pad = padding_idx if padding_idx >= 0 else padding_idx + w.shape[0]
        mask = mask | (fl == pad)
    out = torch.where(mask[:, None], torch.zeros((), dtype=out.dtype, device=out.device), out)
    return {"Out": [out.reshape(tuple(flat.shape) + (w.shape[1],))]}
