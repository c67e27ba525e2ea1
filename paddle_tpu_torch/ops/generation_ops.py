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
  * **int8 pool mode** — when ``kv_cache_write`` is given a ``Scales``
    input, the pool holds int8 levels (symmetric per-row absmax/127
    quantization on the scatter) and a ``[pool_rows]`` f32 scale pool, one
    scale per pool row shared by all heads, is updated in place beside it
    and comes back as ``OutScales``. ``paged_attention`` takes the matching
    ``KScales``/``VScales`` and its kernel dequantizes on the page walk.
    The write itself is plain torch, as it is plain JAX in the JAX package.
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


KV_QUANT_LEVELS = 127.0  # symmetric int8: round(x / scale), scale = absmax/127


@register("kv_cache_write", no_grad=True)
def _kv_cache_write(ctx, ins, attrs):
    """Scatter K/V rows into the pool in place; Out is the pool itself. With
    a Scales input each row quantizes symmetrically on the way in (scale =
    max(absmax, 1e-8) / 127 per row, torch.round half to even like
    jnp.round, clamped to +-127) and its f32 scale lands in the scale pool
    at the same row, also in place (OutScales)."""
    (pool,) = ins["Pool"]
    (rows,) = ins["Rows"]
    (bt,) = ins["BlockTable"]
    (pos,) = ins["Pos"]
    flat = _flat_rows(bt, pos, int(attrs["page_size"]))
    scales = ins.get("Scales", [None])[0]
    if scales is None:
        pool.index_copy_(0, flat, rows.to(pool.dtype))
        return {"Out": [pool]}
    r32 = rows.float()
    scale = torch.clamp(r32.abs().amax(dim=-1), min=1e-8) / KV_QUANT_LEVELS
    q = torch.clamp(
        torch.round(r32 / scale[:, None]), -KV_QUANT_LEVELS, KV_QUANT_LEVELS
    ).to(pool.dtype)
    pool.index_copy_(0, flat, q)
    scales.index_copy_(0, flat, scale.to(scales.dtype))
    return {"Out": [pool], "OutScales": [scales]}


@register("paged_attention", no_grad=True)
def _paged_attention(ctx, ins, attrs):
    (q,) = ins["Q"]  # [S, H*D] — one query token per row
    (kp,) = ins["KPool"]
    (vp,) = ins["VPool"]
    (bt,) = ins["BlockTable"]  # [S, P] or [P] int32 page ids (0 = scratch)
    (pos,) = ins["Pos"]  # [S] position of each query (attends 0..pos)
    fn = _pf.paged_flash_attention
    if _flags.get_flags("paged_flash")["paged_flash"] == "off":
        fn = _pf.paged_attention_plain
    out = fn(
        q, kp, vp, bt, pos,
        n_head=int(attrs["n_head"]), page_size=int(attrs["page_size"]),
        sm_scale=attrs.get("sm_scale"),
        k_scales=ins.get("KScales", [None])[0], v_scales=ins.get("VScales", [None])[0],
    )
    return {"Out": [out]}
