"""Paged flash attention: the hand-written CUDA kernels (csrc/paged_flash.cu),
their launch counters and their plain torch version.

Replaces paddle_tpu/ops/pallas_kernels.py paged_flash_attention (the
_paged_flash_decode_kernel and _paged_flash_shared_kernel Pallas bodies, and
for int8 pools with per-row f32 scales _paged_flash_decode_quant_kernel and
_paged_flash_shared_quant_kernel).
The kernels read the paged pool through the block table with an online
softmax and never materialize the gathered context. For head widths up to
128: the decode form on the CUDA cores, 128 context positions a CTA (one a
lane of 4 warps) gathered by cp.async, its splits merged by the last one to
finish (an arrival counter per (slot, head)); the shared-table (prefill
chunk) form, 64-key stages through a cp.async ring with both products on
the tensor cores (3xTF32), its splits merged the same way (a counter per
(32-row tile, head)). Wider heads, in either form, take one kernel that
gathers 64 context positions a CTA through the table and walks the head in
64-column chunks on the CUDA cores (any head width, any page size), its
splits merged the same way. The plain version (`paged_attention_plain`) is the dense
gather + where-mask safe softmax of the JAX dense lowering
(paddle_tpu/ops/generation_ops.py:134-183).

Dispatch: `paged_flash_attention` checks the operands and calls the
torch.library op `paddle_tpu_torch::paged_flash_attention` (one op for
both table forms and both pool types), whose CUDA implementation launches
the kernel (and counts the launch) and raises if it cannot be built or
launched, whose CPU implementation is the plain version, and whose fake
gives the output's shape and dtype alone, so torch.export records the op.
The op only reads the pools (kv_cache_write writes them, in place, before
it); its scratch (the per-split partials, the arrival counters) is private
to a launch. Nothing falls back silently.

Build: `nvcc` for sm_90a at first use, from the source in this checkout,
into a shared library with a plain C interface loaded with ctypes
(ops/_build.py).
"""

import ctypes
from typing import Optional

import torch

from . import _build

__all__ = [
    "kernel_launches",
    "launch_key",
    "paged_attention_plain",
    "paged_flash_attention",
    "reset_kernel_launches",
]

# query rows a CTA of the shared form takes (one arrival counter per tile
# and head)
SHARED_TILE_ROWS = 32

# the widest head the decode and shared kernels take; wider heads launch
# the wide kernel, counted under its own keys
MAX_NARROW_HEAD = 128

# kernel launches by form, counted where the wrapper launches its kernel and
# nowhere else (the plain version does not count)
_LAUNCHES = {
    "%s%s%s" % (form, wide, pool): 0
    for form in ("paged_flash", "paged_flash_shared")
    for wide in ("", "_wide")
    for pool in ("", "_int8")
}


def kernel_launches():
    """Kernel launches so far, keyed "paged_flash" (per-slot decode table),
    "paged_flash_shared" (one table shared by a prefill chunk), their
    int8-pool forms "paged_flash_int8" and "paged_flash_shared_int8", and
    the same four with "_wide" before any "_int8" for heads past
    MAX_NARROW_HEAD (the wide kernel)."""
    return dict(_LAUNCHES)


def reset_kernel_launches():
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def _bind(lib):
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (lib.paged_flash_decode, lib.paged_flash_shared):
        fn.argtypes = [ptr] * 3 + [i32] + [ptr] * 6 + [i32] * 6 + [f32, ptr]
        fn.restype = i32
    for fn in (lib.paged_flash_decode_int8, lib.paged_flash_shared_int8):
        fn.argtypes = [ptr] * 5 + [i32] + [ptr] * 6 + [i32] * 6 + [f32, ptr]
        fn.restype = i32
    lib.paged_flash_splits.argtypes = [i32] * 4
    lib.paged_flash_splits.restype = i32
    lib.paged_flash_error_string.argtypes = [i32]
    lib.paged_flash_error_string.restype = ctypes.c_char_p


_build.register("paged_flash", _bind)


def _dequant(levels, row_scales, flat):
    """Gathered pool rows as f32: int8 levels times their rows' scales (one
    rounding, the kernels' own value); f32 rows as they are."""
    x = levels.float()
    if row_scales is None:
        return x
    sc = row_scales.reshape(-1).index_select(0, flat).float()
    return x * sc.reshape(sc.shape + (1,) * (x.dim() - 1))


def paged_attention_plain(q, k_pool, v_pool, block_table, pos, *, n_head,
                          page_size, sm_scale=None, k_scales=None, v_scales=None):
    """Dense reference: gather every table page's rows (dequantized for
    int8 pools), then a causal-by-position where-mask and a safe softmax.
    Same arguments as paged_flash_attention. Dead entries get weight exactly
    0 (never an additive -1e9) and a row with pos < 0 emits zeros."""
    s = q.shape[0]
    p = block_table.shape[-1]
    ctx_len = p * page_size
    d = q.shape[-1] // n_head
    scale = float(sm_scale or 0.0) or d ** -0.5
    qh = q.reshape(s, n_head, d).float()
    offsets = torch.arange(page_size, dtype=torch.int64, device=q.device)
    bt = block_table.to(torch.int64)
    if bt.dim() == 1:
        # one shared page list: gather each context row once for all queries
        flat = (bt[:, None] * page_size + offsets[None, :]).reshape(ctx_len)
        k = _dequant(k_pool.index_select(0, flat), k_scales, flat).reshape(ctx_len, n_head, d)
        v = _dequant(v_pool.index_select(0, flat), v_scales, flat).reshape(ctx_len, n_head, d)
        scores = torch.einsum("shd,chd->shc", qh, k) * scale
    else:
        flat = (bt[:, :, None] * page_size + offsets[None, None, :]).reshape(-1)
        k = _dequant(k_pool.index_select(0, flat), k_scales, flat).reshape(s, ctx_len, n_head, d)
        v = _dequant(v_pool.index_select(0, flat), v_scales, flat).reshape(s, ctx_len, n_head, d)
        scores = torch.einsum("shd,schd->shc", qh, k) * scale
    live = (
        torch.arange(ctx_len, dtype=torch.int64, device=q.device)[None, :]
        <= pos.reshape(-1).to(torch.int64)[:, None]
    )[:, None, :]
    neg_inf = torch.full((), float("-inf"), device=q.device)
    scores = torch.where(live, scores, neg_inf)
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros((), device=q.device))
    w = torch.where(live, torch.exp(scores - m), torch.zeros((), device=q.device))
    denom = w.sum(dim=-1, keepdim=True)
    w = w / torch.where(denom > 0.0, denom, torch.ones((), device=q.device))
    if bt.dim() == 1:
        out = torch.einsum("shc,chd->shd", w, v)
    else:
        out = torch.einsum("shc,schd->shd", w, v)
    return out.reshape(s, n_head * d).to(q.dtype)


def paged_flash_attention(q, k_pool, v_pool, block_table, pos, *, n_head,
                          page_size, sm_scale=None, k_scales=None, v_scales=None):
    """Paged attention over the KV pool. q is [rows, n_head*d] f32;
    k_pool/v_pool [pool_rows, n_head*d] f32, or int8 levels with
    k_scales/v_scales (both or neither) the [pool_rows] f32 scale of each
    pool row; block_table [rows, P] (decode: one page list per row) or [P]
    (chunked prefill: one list shared by all rows); pos[r] bounds row r's
    live context (positions 0..pos inclusive, pos < 0 emits zeros). Returns
    [rows, n_head*d] f32.

    Checks the operands, then calls the op
    paddle_tpu_torch::paged_flash_attention: CUDA tensors launch the kernel
    (and raise if it cannot be built or launched); CPU tensors run
    paged_attention_plain."""
    quant = k_scales is not None
    if quant != (v_scales is not None):
        raise ValueError("paged_flash: k_scales and v_scales go together")
    sm_scale = float(sm_scale or 0.0)
    if q.device.type != "cuda":
        return _paged_op(q, k_pool, v_pool, block_table, pos, int(n_head), int(page_size),
                         sm_scale, k_scales, v_scales)
    rows, feat = q.shape
    if (feat // n_head) * n_head != feat:
        raise ValueError("q width %d is not n_head=%d heads" % (feat, n_head))
    pool_dtype = torch.int8 if quant else torch.float32
    for name, t, dt in (("q", q, torch.float32), ("k_pool", k_pool, pool_dtype),
                        ("v_pool", v_pool, pool_dtype)):
        if t.dtype != dt:
            raise TypeError("paged_flash: %s must be %s, got %s" % (name, dt, t.dtype))
        if t.device != q.device:
            raise ValueError("paged_flash: %s is on %s, q on %s" % (name, t.device, q.device))
    if k_pool.shape != v_pool.shape or k_pool.dim() != 2 or k_pool.shape[1] != feat:
        raise ValueError(
            "paged_flash: pools %s/%s do not match q width %d"
            % (tuple(k_pool.shape), tuple(v_pool.shape), feat)
        )
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("paged_flash: the KV pools must be contiguous")
    pool_rows = k_pool.shape[0]
    if pool_rows % page_size:
        raise ValueError("pool rows %d not a multiple of page_size %d" % (pool_rows, page_size))
    if quant:
        for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
            if (t.dtype != torch.float32 or t.device != q.device or t.numel() != pool_rows
                    or not t.is_contiguous()):
                raise ValueError(
                    "paged_flash: %s must be %d contiguous float32 values on %s, got %s %s"
                    % (name, pool_rows, q.device, tuple(t.shape), t.dtype))
    if block_table.dim() not in (1, 2) or (block_table.dim() == 2
                                            and block_table.shape[0] != rows):
        raise ValueError(
            "paged_flash: block table %s does not match %d query rows"
            % (tuple(block_table.shape), rows)
        )
    if pos.numel() != rows:
        raise ValueError("paged_flash: %d positions for %d rows" % (pos.numel(), rows))
    if (block_table.device != q.device or pos.device != q.device) and (
            torch.cuda.is_current_stream_capturing()):
        # a graph replays a host-to-device copy from the address it captured
        raise ValueError("paged_flash: the block table and positions must be on %s "
                         "during a CUDA graph capture, got %s and %s"
                         % (q.device, block_table.device, pos.device))
    # no-ops for the executor's feeds: int32 tensors on the card already
    bt = block_table.to(device=q.device, dtype=torch.int32).contiguous()
    pv = pos.reshape(-1).to(device=q.device, dtype=torch.int32).contiguous()
    return _paged_op(q, k_pool, v_pool, bt, pv, int(n_head), int(page_size), sm_scale,
                     k_scales, v_scales)


# the op: one entry for the executor, CUDA graphs and torch.export (whose
# graphs record it by name). sm_scale 0.0 means d ** -0.5. It reads the
# pools and writes nothing it is given: mutates_args is empty.
@torch.library.custom_op("paddle_tpu_torch::paged_flash_attention", mutates_args=(),
                         device_types="cpu")
def _paged_op(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
              block_table: torch.Tensor, pos: torch.Tensor, n_head: int, page_size: int,
              sm_scale: float, k_scales: Optional[torch.Tensor],
              v_scales: Optional[torch.Tensor]) -> torch.Tensor:
    return paged_attention_plain(
        q, k_pool, v_pool, block_table, pos, n_head=n_head, page_size=page_size,
        sm_scale=sm_scale, k_scales=k_scales, v_scales=v_scales,
    ).contiguous()


@_paged_op.register_fake
def _(q, k_pool, v_pool, block_table, pos, n_head, page_size, sm_scale, k_scales, v_scales):
    return q.new_empty(q.shape)


@_paged_op.register_kernel("cuda")
def _(q, k_pool, v_pool, block_table, pos, n_head, page_size, sm_scale, k_scales, v_scales):
    quant = k_scales is not None
    rows, feat = q.shape
    d = feat // n_head
    scale = sm_scale or d ** -0.5
    for name, t in (("block_table", block_table), ("pos", pos)):
        if t.device != q.device or t.dtype != torch.int32:
            raise ValueError("paged_flash: the op takes %s as int32 on %s, got %s on %s"
                             % (name, q.device, t.dtype, t.device))
    shared = block_table.dim() == 1
    n_pages = block_table.shape[-1]
    pool_rows = k_pool.shape[0]
    qc, bt, pv = q.contiguous(), block_table.contiguous(), pos.reshape(-1).contiguous()
    out = torch.empty_like(qc)
    lib = _build.load("paged_flash")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    # per-split (acc, m, l) scratch that the merge reads back
    splits = lib.paged_flash_splits(n_pages, page_size, d, int(shared))
    part_acc = torch.empty((splits, rows, n_head, d), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((splits, rows, n_head, 2), dtype=torch.float32, device=q.device)
    # 16-byte row loads: a head's slice and every row of the pools (4 f32
    # values, 16 int8 levels) and of q start on a 16-byte boundary
    unit = 16 if quant else 4
    vec = int(d % unit == 0 and feat % unit == 0 and qc.data_ptr() % 16 == 0
              and k_pool.data_ptr() % 16 == 0 and v_pool.data_ptr() % 16 == 0)
    pools = (k_pool.data_ptr(), v_pool.data_ptr())
    if quant:
        pools += (k_scales.data_ptr(), v_scales.data_ptr())
    # the arrival counters of the last split's merge: one per (32-row tile,
    # head) of a chunk, one per (slot, head) of a decode step
    groups = (-(-rows // SHARED_TILE_ROWS) if shared else rows) * n_head
    arrivals = _build.arrival_counters(q.device, stream, groups)
    if shared:
        fn = lib.paged_flash_shared_int8 if quant else lib.paged_flash_shared
    else:
        fn = lib.paged_flash_decode_int8 if quant else lib.paged_flash_decode
    with torch.cuda.device(q.device):
        err = fn(qc.data_ptr(), *pools, vec, bt.data_ptr(), pv.data_ptr(), out.data_ptr(),
                 part_acc.data_ptr(), part_ml.data_ptr(), arrivals.data_ptr(), rows, n_head, d,
                 n_pages, page_size, pool_rows, scale, stream)
    if err:
        raise RuntimeError(
            "paged_flash kernel launch failed: %s"
            % lib.paged_flash_error_string(err).decode()
        )
    _LAUNCHES[launch_key(shared, d, quant)] += 1
    return out


def launch_key(shared, head_dim, quant):
    """The kernel_launches() key of a call: its table form, head width and
    pool type."""
    return "%s%s%s" % ("paged_flash_shared" if shared else "paged_flash",
                       "_wide" if head_dim > MAX_NARROW_HEAD else "",
                       "_int8" if quant else "")
