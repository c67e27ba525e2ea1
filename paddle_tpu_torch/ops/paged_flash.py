"""Paged flash attention: the hand-written CUDA kernel (csrc/paged_flash.cu),
its loader, its launch counter and its plain torch version.

Replaces paddle_tpu/ops/pallas_kernels.py paged_flash_attention (the
_paged_flash_decode_kernel and _paged_flash_shared_kernel Pallas bodies).
The kernel reads the paged pool through the block table with an online
softmax and never materializes the gathered context; the plain version
(`paged_attention_plain`) is the dense gather + where-mask safe softmax of
the JAX dense lowering (paddle_tpu/ops/generation_ops.py:134-183).

Dispatch: `paged_flash_attention` launches the kernel for tensors on a CUDA
device and raises if it cannot be built or launched; it runs the plain
version only for tensors on the CPU (or on the meta device, during shape
inference). Nothing falls back silently.

Build: `nvcc` for sm_90a at first use, from the source in this checkout,
into paddle_tpu_torch/_build/ as a shared library with a plain C interface,
loaded with ctypes. The library name carries a hash of the source, so an
edited kernel never loads a stale build.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

__all__ = [
    "build",
    "kernel_launches",
    "paged_attention_plain",
    "paged_flash_attention",
    "reset_kernel_launches",
]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "paged_flash.cu")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# table entries one CTA walks: a decode row's 64-entry table at page_size 16
# spreads over 16 CTAs per (slot, head), so 8 slots x 12 heads put 1536 CTAs
# on the card's 132 SMs instead of 96 (and a prefill chunk 192 instead of 12)
PAGES_PER_SPLIT = 4

# kernel launches by form, counted where the wrapper launches its kernel and
# nowhere else (the plain version does not count)
_LAUNCHES = {"paged_flash": 0, "paged_flash_shared": 0}

_lib = None
_lib_lock = threading.Lock()
build_log = ""  # nvcc's output of the build this process loaded (ptxas -v)


def kernel_launches():
    """Kernel launches so far, keyed "paged_flash" (per-slot decode table)
    and "paged_flash_shared" (one table shared by a prefill chunk)."""
    return dict(_LAUNCHES)


def reset_kernel_launches():
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("paged_flash: nvcc not found (CUDA_HOME=%r)" % CUDA_HOME)


def build():
    """Compile (if needed) and load the kernel library; returns the ctypes
    handle. Raises with nvcc's output when the build fails."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        with open(_SRC, "rb") as f:
            src = f.read()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        so = os.path.join(_BUILD_DIR, "libpaged_flash-%s.so" % tag)
        if not os.path.exists(so):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = "%s.%d.tmp" % (so, os.getpid())
            proc = subprocess.run(
                [_nvcc()] + NVCC_FLAGS + ["-o", tmp, _SRC],
                capture_output=True, text=True,
            )
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError("paged_flash: nvcc failed:\n" + build_log)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for fn in (lib.paged_flash_decode, lib.paged_flash_shared):
            fn.argtypes = [ptr] * 8 + [i32] * 7 + [f32, ptr]
            fn.restype = i32
        lib.paged_flash_n_splits.argtypes = [i32, i32]
        lib.paged_flash_n_splits.restype = i32
        lib.paged_flash_error_string.argtypes = [i32]
        lib.paged_flash_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def paged_attention_plain(q, k_pool, v_pool, block_table, pos, *, n_head,
                          page_size, sm_scale=None):
    """Dense reference: gather every table page's rows, then a causal-by-
    position where-mask and a safe softmax. Same arguments as
    paged_flash_attention. Dead entries get weight exactly 0 (never an
    additive -1e9) and a row with pos < 0 emits zeros."""
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
        k = k_pool.index_select(0, flat).reshape(ctx_len, n_head, d).float()
        v = v_pool.index_select(0, flat).reshape(ctx_len, n_head, d).float()
        scores = torch.einsum("shd,chd->shc", qh, k) * scale
    else:
        flat = (bt[:, :, None] * page_size + offsets[None, None, :]).reshape(-1)
        k = k_pool.index_select(0, flat).reshape(s, ctx_len, n_head, d).float()
        v = v_pool.index_select(0, flat).reshape(s, ctx_len, n_head, d).float()
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
                          page_size, sm_scale=None):
    """Paged attention over the KV pool. q is [rows, n_head*d] f32;
    k_pool/v_pool [pool_rows, n_head*d] f32; block_table [rows, P] (decode:
    one page list per row) or [P] (chunked prefill: one list shared by all
    rows); pos[r] bounds row r's live context (positions 0..pos inclusive,
    pos < 0 emits zeros). Returns [rows, n_head*d] f32.

    CUDA tensors launch the kernel (and raise if it cannot be built or
    launched); CPU tensors run paged_attention_plain."""
    if q.device.type != "cuda":
        return paged_attention_plain(
            q, k_pool, v_pool, block_table, pos,
            n_head=n_head, page_size=page_size, sm_scale=sm_scale,
        )
    rows, feat = q.shape
    d = feat // n_head
    scale = float(sm_scale or 0.0) or d ** -0.5
    if d * n_head != feat:
        raise ValueError("q width %d is not n_head=%d heads" % (feat, n_head))
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != torch.float32:
            raise TypeError("paged_flash: %s must be float32, got %s" % (name, t.dtype))
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
    shared = block_table.dim() == 1
    if not shared and (block_table.dim() != 2 or block_table.shape[0] != rows):
        raise ValueError(
            "paged_flash: block table %s does not match %d query rows"
            % (tuple(block_table.shape), rows)
        )
    n_pages = block_table.shape[-1]
    qc = q.contiguous()
    bt = block_table.to(device=q.device, dtype=torch.int32).contiguous()
    pv = pos.reshape(-1).to(device=q.device, dtype=torch.int32).contiguous()
    if pv.shape[0] != rows:
        raise ValueError("paged_flash: %d positions for %d rows" % (pv.shape[0], rows))
    out = torch.empty_like(qc)
    lib = build()
    # per-split (acc, m, l) scratch that the merge kernel reads back
    splits = lib.paged_flash_n_splits(n_pages, PAGES_PER_SPLIT)
    part_acc = torch.empty((splits, rows, n_head, d), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((splits, rows, n_head, 2), dtype=torch.float32, device=q.device)
    fn = lib.paged_flash_shared if shared else lib.paged_flash_decode
    with torch.cuda.device(q.device):
        err = fn(
            qc.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), bt.data_ptr(),
            pv.data_ptr(), out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
            rows, n_head, d, n_pages, page_size, pool_rows, PAGES_PER_SPLIT, scale,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            "paged_flash kernel launch failed: %s"
            % lib.paged_flash_error_string(err).decode()
        )
    _LAUNCHES["paged_flash_shared" if shared else "paged_flash"] += 1
    return out
