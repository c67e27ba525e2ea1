"""Fused residual-add + layer_norm, forward and backward: the hand-written
CUDA kernels (csrc/layer_norm.cu), their launch counters and their plain
torch versions.

Replaces paddle_tpu/ops/pallas_kernels.py fused_layer_norm (_ln_fwd_kernel)
and fused_layer_norm_grad (_ln_bwd_kernel). Forward: s = x + r in the input
dtype, Welford mean and biased variance in f32, y rounded once. Backward:
dx from the saved stats, dscale and dbias summed over all rows in f32.

Dispatch: `fused_layer_norm` / `fused_layer_norm_grad` launch the kernels
for tensors on a CUDA device and raise if they cannot be built or launched;
they run the plain versions only for tensors on the CPU. Nothing falls back
silently.
"""

import ctypes

import torch

from . import _build

__all__ = [
    "fused_layer_norm",
    "fused_layer_norm_grad",
    "fused_layer_norm_grad_plain",
    "fused_layer_norm_plain",
    "kernel_launches",
    "reset_kernel_launches",
]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# launches, counted where the wrapper launches its kernel and nowhere else
_LAUNCHES = {"layer_norm": 0, "layer_norm_grad": 0}


def kernel_launches():
    return dict(_LAUNCHES)


def reset_kernel_launches():
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def _bind(lib):
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.layer_norm_fwd.argtypes = [ptr] * 8 + [i32, i32, f32, i32, ptr]
    lib.layer_norm_fwd.restype = i32
    lib.layer_norm_bwd.argtypes = [ptr] * 10 + [i32, i32, f32, i32, ptr]
    lib.layer_norm_bwd.restype = i32
    lib.layer_norm_partial_rows.argtypes = []
    lib.layer_norm_partial_rows.restype = i32
    lib.layer_norm_error_string.argtypes = [i32]
    lib.layer_norm_error_string.restype = ctypes.c_char_p


_build.register("layer_norm", _bind)


def _vec(v, cols, device):
    """A [cols] f32 scale/bias row on `device`, or None (ones/zeros)."""
    if v is None:
        return None
    v = v.reshape(-1)
    if v.numel() != cols:
        raise ValueError("layer_norm: %d values for %d columns" % (v.numel(), cols))
    if v.device != device:
        raise ValueError("layer_norm: scale/bias on %s, x on %s" % (v.device, device))
    return v.to(torch.float32).contiguous()  # widening a float is exact


def fused_layer_norm_plain(x2, residual2, scale, bias, eps):
    """(s, y, mean, var) of layer_norm(x2 [+ residual2]) over rows: s in the
    input dtype (None without a residual), mean/var f32 (biased var)."""
    s = None if residual2 is None else x2 + residual2
    b32 = (x2 if s is None else s).float()
    var, mean = torch.var_mean(b32, dim=1, unbiased=False)
    y = (b32 - mean[:, None]) * torch.rsqrt(var[:, None] + eps)
    if scale is not None:
        y = y * scale.reshape(1, -1).float()
    if bias is not None:
        y = y + bias.reshape(1, -1).float()
    return s, y.to(x2.dtype), mean, var


def fused_layer_norm(x2, residual2, scale, bias, eps):
    """layer_norm(x2 [+ residual2]) over the (rows, cols) view. Returns
    (s, y, mean, var): s = x2 + residual2 in the input dtype (None when no
    residual), y in the input dtype, mean/var the f32 per-row stats (biased
    variance). scale/bias of None behave as ones/zeros. CUDA tensors launch
    the kernel; CPU tensors run fused_layer_norm_plain."""
    if x2.device.type != "cuda":
        return fused_layer_norm_plain(x2, residual2, scale, bias, eps)
    if x2.dim() != 2 or x2.dtype not in _DTYPE_CODE:
        raise TypeError("fused_layer_norm: x2 must be 2-D f32 or bf16, got %s %s"
                        % (tuple(x2.shape), x2.dtype))
    rows, cols = x2.shape
    xc = x2.contiguous()
    rc = None
    if residual2 is not None:
        if residual2.shape != x2.shape or residual2.dtype != x2.dtype:
            raise ValueError("fused_layer_norm: residual %s %s vs x %s %s" % (
                tuple(residual2.shape), residual2.dtype, tuple(x2.shape), x2.dtype))
        rc = residual2.contiguous()
    sc, bc = _vec(scale, cols, x2.device), _vec(bias, cols, x2.device)
    s = torch.empty_like(xc) if rc is not None else None
    y = torch.empty_like(xc)
    mean = torch.empty(rows, dtype=torch.float32, device=x2.device)
    var = torch.empty_like(mean)
    lib = _build.load("layer_norm")
    with torch.cuda.device(x2.device):
        err = lib.layer_norm_fwd(
            xc.data_ptr(), None if rc is None else rc.data_ptr(),
            None if sc is None else sc.data_ptr(), None if bc is None else bc.data_ptr(),
            None if s is None else s.data_ptr(), y.data_ptr(), mean.data_ptr(),
            var.data_ptr(), rows, cols, float(eps), _DTYPE_CODE[x2.dtype],
            torch.cuda.current_stream(x2.device).cuda_stream,
        )
    if err:
        raise RuntimeError("layer_norm kernel launch failed: %s"
                           % lib.layer_norm_error_string(err).decode())
    _LAUNCHES["layer_norm"] += 1
    return s, y, mean, var


def fused_layer_norm_grad_plain(x2, scale, mean, var, dy2, eps):
    """(dx, dscale, dbias) of layer_norm from the saved stats: dx in x2's
    dtype, dscale/dbias (cols,) f32."""
    x32, dy32 = x2.float(), dy2.float()
    rstd = torch.rsqrt(var + eps)
    xhat = (x32 - mean[:, None]) * rstd[:, None]
    dxh = dy32 if scale is None else dy32 * scale.reshape(1, -1).float()
    c1 = torch.mean(dxh, dim=1)
    c2 = torch.mean(dxh * xhat, dim=1)
    dx = (rstd[:, None] * (dxh - c1[:, None] - xhat * c2[:, None])).to(x2.dtype)
    return dx, torch.sum(dy32 * xhat, dim=0), torch.sum(dy32, dim=0)


def fused_layer_norm_grad(x2, scale, mean, var, dy2, eps):
    """Backward of the fused layer_norm over the (rows, cols) view. Returns
    (dx, dscale, dbias): dx in x2's dtype, dscale/dbias (cols,) f32 sums
    over all rows (the caller casts them to the param dtypes). scale of
    None behaves as ones. CUDA tensors launch the kernels; CPU tensors run
    fused_layer_norm_grad_plain."""
    if x2.device.type != "cuda":
        return fused_layer_norm_grad_plain(x2, scale, mean, var, dy2, eps)
    if x2.dim() != 2 or x2.dtype not in _DTYPE_CODE:
        raise TypeError("fused_layer_norm_grad: x2 must be 2-D f32 or bf16, got %s %s"
                        % (tuple(x2.shape), x2.dtype))
    rows, cols = x2.shape
    if dy2.shape != x2.shape or dy2.dtype != x2.dtype:
        raise ValueError("fused_layer_norm_grad: dy %s %s vs x %s %s" % (
            tuple(dy2.shape), dy2.dtype, tuple(x2.shape), x2.dtype))
    for name, st in (("mean", mean), ("var", var)):
        if st.numel() != rows or st.dtype != torch.float32 or st.device != x2.device:
            raise ValueError("fused_layer_norm_grad: %s must be (%d,) f32 on %s"
                             % (name, rows, x2.device))
    xc, dyc = x2.contiguous(), dy2.contiguous()
    mc, vc = mean.reshape(-1).contiguous(), var.reshape(-1).contiguous()
    sc = _vec(scale, cols, x2.device)
    lib = _build.load("layer_norm")
    chunks = -(-rows // lib.layer_norm_partial_rows())
    dx = torch.empty_like(xc)
    ds = torch.empty(cols, dtype=torch.float32, device=x2.device)
    db = torch.empty_like(ds)
    part = torch.empty((2, chunks, cols), dtype=torch.float32, device=x2.device)
    with torch.cuda.device(x2.device):
        err = lib.layer_norm_bwd(
            xc.data_ptr(), None if sc is None else sc.data_ptr(), mc.data_ptr(),
            vc.data_ptr(), dyc.data_ptr(), dx.data_ptr(), ds.data_ptr(), db.data_ptr(),
            part[0].data_ptr(), part[1].data_ptr(), rows, cols, float(eps),
            _DTYPE_CODE[x2.dtype], torch.cuda.current_stream(x2.device).cuda_stream,
        )
    if err:
        raise RuntimeError("layer_norm_grad kernel launch failed: %s"
                           % lib.layer_norm_error_string(err).decode())
    _LAUNCHES["layer_norm_grad"] += 1
    return dx, ds, db
