"""Generation-serving ops: paged KV-cache writes and paged attention (the
torch counterparts of paddle_tpu/ops/generation_ops.py).

Conventions (shared with the JAX package):
  * A pool is a persistable ``[n_pages * page_size, n_head * d_head]`` f32
    tensor. Row ``page_id * page_size + offset`` holds the K (or V) row of
    one token. Page 0 is a scratch page the allocator never hands out —
    writes landing there (padded prefill tail, idle decode slots) are
    masked out of every attention read.
  * ``kv_cache_write`` updates the pool IN PLACE (``index_copy_``) and
    returns the pool itself as its ``Out``, so the executor classifies the
    pool as written state exactly as the JAX package's donated-buffer form
    does; no copy of the pool is ever made.
  * ``paged_attention`` takes a block table of either shape: ``[S, P]``
    (decode — one page list per query row) or ``[P]`` (chunked prefill —
    one slot's list shared by every row of the chunk). It runs the CUDA
    kernel of ops/paged_flash.py for tensors on the card; FLAGS_paged_flash
    "off" selects the plain torch version instead.
  * The int8 pool mode of the JAX package (``Scales`` / ``KScales``) is not
    ported yet and raises NotImplementedError.
"""

import torch

from .. import flags as _flags
from . import paged_flash as _pf
from .registry import register

__all__ = []


def _flat_rows(block_table, positions, page_size):
    """Pool row index for each (slot, position): block_table picks the page,
    position % page_size the offset. block_table may be [S, P] (decode, one
    row per slot) or [P] (prefill, one slot writing many positions). A
    position at or past the table's capacity (P * page_size — only the
    padded tail of a prefill chunk near the context bound can get there) is
    routed to the scratch page's rows instead of clamp-corrupting the last
    real page."""
    positions = positions.reshape(-1).to(torch.int64)
    page_idx = torch.div(positions, page_size, rounding_mode="floor")
    n_pages = block_table.shape[-1]
    safe_idx = torch.clamp(page_idx, max=n_pages - 1)
    bt = block_table.to(torch.int64)
    if bt.dim() == 1:
        page_id = bt[safe_idx]
    else:
        page_id = torch.gather(bt, 1, safe_idx[:, None])[:, 0]
    page_id = torch.where(page_idx < n_pages, page_id, torch.zeros_like(page_id))
    return page_id * page_size + torch.remainder(positions, page_size)


def _int8_not_ported(op_type):
    raise NotImplementedError(
        "%s: int8 KV pools (kv_dtype='int8') are not ported to the torch "
        "package yet; use kv_dtype='float32'" % op_type
    )


@register("kv_cache_write", no_grad=True)
def _kv_cache_write(ctx, ins, attrs):
    """Scatter K/V rows into the pool in place; Out is the pool itself."""
    (pool,) = ins["Pool"]
    (rows,) = ins["Rows"]
    (bt,) = ins["BlockTable"]
    (pos,) = ins["Pos"]
    if ins.get("Scales", [None])[0] is not None:
        _int8_not_ported("kv_cache_write")
    flat = _flat_rows(bt, pos, int(attrs["page_size"]))
    pool.index_copy_(0, flat, rows.to(pool.dtype))
    return {"Out": [pool]}


@register("paged_attention", no_grad=True)
def _paged_attention(ctx, ins, attrs):
    (q,) = ins["Q"]  # [S, H*D] — one query token per row
    (kp,) = ins["KPool"]
    (vp,) = ins["VPool"]
    (bt,) = ins["BlockTable"]  # [S, P] or [P] int32 page ids (0 = scratch)
    (pos,) = ins["Pos"]  # [S] position of each query (attends 0..pos)
    if ins.get("KScales", [None])[0] is not None:
        _int8_not_ported("paged_attention")
    fn = _pf.paged_flash_attention
    if _flags.get_flags("paged_flash")["paged_flash"] == "off":
        fn = _pf.paged_attention_plain
    out = fn(
        q, kp, vp, bt, pos,
        n_head=int(attrs["n_head"]), page_size=int(attrs["page_size"]),
        sm_scale=attrs.get("sm_scale"),
    )
    return {"Out": [out]}
