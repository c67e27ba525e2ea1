"""Beam-search decode ops (the torch counterparts of
paddle_tpu/ops/decode_ops.py).

Beams live in a dense [batch * beam, ...] layout, and `beam_search` emits
an explicit ParentIdx tensor (flat indices into the batch * beam axis):
callers gather their decoder state with it each step and write ids, scores
and parents into tensor arrays, which `beam_search_decode` walks backward.
Both run on the device with no read on the host.

Ties break as the JAX package's lax.top_k breaks them (the lower index
first): core_ops.stable_top_k, never torch.topk, whose order of ties is
unspecified.

First-step convention: all beams of a source start identical, so
pre_scores start as [0, -inf, -inf, ...] per source.
"""

import torch

from .control_flow_ops import _noop_infer
from .core_ops import stable_top_k
from .registry import register, torch_dtype

NEG_INF = -1e9

_I64 = torch_dtype("int64")


@register("beam_search", no_grad=True)
def _beam_search(ctx, ins, attrs):
    (pre_ids,) = ins["pre_ids"]  # [N, 1] int
    (pre_scores,) = ins["pre_scores"]  # [N, 1] float
    (ids,) = ins["ids"]  # [N, K] candidate tokens per beam
    (scores,) = ins["scores"]  # [N, K] accumulated scores
    beam_size = int(attrs["beam_size"])
    end_id = int(attrs["end_id"])
    n, k = ids.shape
    b = n // beam_size

    pre_id = pre_ids.reshape(n).long()
    pre_score = pre_scores.reshape(n).float()
    finished = (pre_id == end_id)[:, None]
    col = torch.arange(k, device=ids.device)[None, :]
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=ids.device)
    # a finished beam contributes exactly one candidate: (end_id, pre_score)
    cand_scores = torch.where(finished, torch.where(col == 0, pre_score[:, None], neg),
                              scores.float())
    cand_ids = torch.where(finished, torch.full((), end_id, dtype=torch.long, device=ids.device),
                           ids.long())
    top_scores, top_idx = stable_top_k(cand_scores.reshape(b, beam_size * k), beam_size)
    sel_ids = torch.gather(cand_ids.reshape(b, beam_size * k), 1, top_idx)
    parent = (torch.div(top_idx, k, rounding_mode="floor")
              + torch.arange(b, device=ids.device)[:, None] * beam_size)
    return {
        "selected_ids": [sel_ids.reshape(n, 1).to(_I64)],
        "selected_scores": [top_scores.reshape(n, 1)],
        "parent_idx": [parent.reshape(n).to(torch.int32)],
    }


@register("beam_search_decode", no_grad=True, infer_shape=_noop_infer)
def _beam_search_decode(ctx, ins, attrs):
    """Backtrack the (ids, parents) step arrays into [B, beam, T]
    hypotheses, the best beam first per source, with their final scores
    and lengths (up to and including the first end_id among the valid
    steps, else the array's size)."""
    ids_buf, size = ins["Ids"][0]  # ([T, N, 1], size)
    scores_buf = ins["Scores"][0][0]
    parents_in = ins.get("Parents", [None])[0]
    beam_size = int(attrs["beam_size"])
    end_id = int(attrs["end_id"])
    t_cap, n = ids_buf.shape[0], ids_buf.shape[1]
    b = n // beam_size
    dev = ids_buf.device
    ids_buf = ids_buf.reshape(t_cap, n).long()
    scores_buf = scores_buf.reshape(t_cap, n).float()
    if parents_in is None:
        parents_buf = torch.arange(n, device=dev)[None, :].expand(t_cap, n)
    else:
        parents_buf = parents_in[0].reshape(t_cap, n).long()
    size = size.reshape(()).long()

    # walk backward from the last valid step; steps >= size pass through
    beam_idx = torch.arange(n, device=dev)
    end = torch.full((), end_id, dtype=torch.long, device=dev)
    toks = [None] * t_cap
    for t in range(t_cap - 1, -1, -1):
        valid = size > t
        toks[t] = torch.where(valid, ids_buf[t][beam_idx], end)
        beam_idx = torch.where(valid, parents_buf[t][beam_idx], beam_idx)
    seq = torch.stack(toks, dim=1).reshape(b, beam_size, t_cap)

    last = torch.clamp(size - 1, min=0)
    final_scores = torch.index_select(scores_buf, 0, last.reshape(1))[0].reshape(b, beam_size)
    # rank beams best first per source (a stable sort, as jnp.argsort)
    order = torch.argsort(-final_scores, dim=1, stable=True)
    seq = torch.gather(seq, 1, order[:, :, None].expand(seq.shape))
    final_scores = torch.gather(final_scores, 1, order)

    t_idx = torch.arange(t_cap, device=dev)
    is_end = (seq == end_id) & (t_idx[None, None, :] < size)
    first_end = torch.argmax(is_end.to(torch.int32), dim=2)
    lens = torch.where(is_end.any(dim=2), first_end + 1, size)
    return {
        "SentenceIds": [seq.to(_I64)],
        "SentenceScores": [final_scores],
        "SentenceLength": [lens.to(torch.int32)],
    }
