"""Quantized GEMM + dequant scale + bias + activation: the hand-written CUDA
kernel (csrc/quant_gemm.cu), its launch counters and its plain torch
version.

Replaces paddle_tpu/ops/pallas_kernels.py quant_gemm_bias_act
(_quant_gemm_kernel), both operand forms: int8 x int8 with exact i32 sums,
and float8 e4m3 x e4m3 with f32 sums. Either way z = (x2 @ w2) * scale +
bias with one combined per-tensor scale and y = act(z), f32 out.

Dispatch: `quant_gemm_bias_act` launches the kernel for tensors on a CUDA
device and raises if it cannot be built or launched, or if the shape is one
the kernel does not take (k or n not a multiple of 16); it runs the plain
version (`quant_gemm_bias_act_plain`) only for tensors on the CPU.
"""

import ctypes

import torch

from . import _build
from .gemm_epilogue import ACT_F32

__all__ = [
    "kernel_launches",
    "quant_gemm_bias_act",
    "quant_gemm_bias_act_plain",
    "reset_kernel_launches",
]

_ACT_CODE = {None: 0, "relu": 1, "gelu": 2, "tanh": 3, "sigmoid": 4}
_FORMS = {torch.int8: "quant_gemm_int8", torch.float8_e4m3fn: "quant_gemm_fp8"}

# launches by operand form, counted where the wrapper launches its kernel
# and nowhere else
_LAUNCHES = {name: 0 for name in _FORMS.values()}


def kernel_launches():
    """Kernel launches so far, keyed "quant_gemm_int8" and "quant_gemm_fp8"."""
    return dict(_LAUNCHES)


def reset_kernel_launches():
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def _bind(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.quant_gemm_bias_act.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.quant_gemm_bias_act.restype = i32
    lib.quant_gemm_error_string.argtypes = [i32]
    lib.quant_gemm_error_string.restype = ctypes.c_char_p


_build.register("quant_gemm", _bind)


def _wide_product(x2, w2):
    """x2 @ w2 as f32: int8 levels multiply as float64, whose sums are exact
    integers here (|sum| <= k * 127^2 < 2^53; torch.matmul takes no integer
    tensors on CUDA, and an f32 sum is inexact past 2^24), then round once
    to f32 like the JAX package's i32 -> f32; e4m3 values as f32."""
    if x2.dtype == torch.int8:
        return torch.matmul(x2.double(), w2.double()).float()
    return torch.matmul(x2.float(), w2.float())


def quant_gemm_bias_act_plain(x2, w2, scale, bias_row=None, act=None):
    """act((x2 @ w2) * scale + bias) with the wide product of _wide_product:
    the product times the scale, plus the bias, each rounded in f32. Returns
    (z, y), y None without an act."""
    z = _wide_product(x2, w2) * scale.reshape(()).float()
    if bias_row is not None:
        z = z + bias_row.reshape(1, -1).float()
    return z, (ACT_F32[act](z) if act else None)


def quant_gemm_bias_act(x2, w2, scale, bias_row=None, act=None):
    """act((x2 @ w2) * scale + bias) over 2-D int8 (or float8_e4m3fn)
    operands of one dtype; scale is one f32 value (a tensor, on the
    operands' device), bias_row n values or None. Returns (z, y) in f32: z
    the post-bias pre-activation value, y = act(z), None when act is None.
    CUDA tensors launch the kernel; CPU tensors run
    quant_gemm_bias_act_plain."""
    if act not in _ACT_CODE:
        raise ValueError("quant_gemm_bias_act: unknown act %r" % (act,))
    if x2.dtype != w2.dtype or x2.dtype not in _FORMS:
        raise TypeError("quant_gemm_bias_act: operands must share int8 or float8_e4m3fn, "
                        "got %s and %s" % (x2.dtype, w2.dtype))
    if x2.dim() != 2 or w2.dim() != 2 or x2.shape[1] != w2.shape[0]:
        raise ValueError("quant_gemm_bias_act: shapes %s @ %s"
                         % (tuple(x2.shape), tuple(w2.shape)))
    if x2.device.type != "cuda":
        return quant_gemm_bias_act_plain(x2, w2, scale, bias_row, act)
    m, k = x2.shape
    n = w2.shape[1]
    if k % 16 or n % 16:
        raise ValueError("quant_gemm_bias_act: the kernel takes k and n multiples of 16, "
                         "got k=%d n=%d" % (k, n))
    bias = (torch.zeros(n, dtype=torch.float32, device=x2.device) if bias_row is None
            else bias_row.reshape(-1).to(torch.float32).contiguous())
    if bias.numel() != n:
        raise ValueError("quant_gemm_bias_act: %d bias values for n=%d" % (bias.numel(), n))
    s = scale.reshape(-1).to(torch.float32).contiguous()
    if s.numel() != 1:
        raise ValueError("quant_gemm_bias_act: scale must be one value, got %d" % s.numel())
    for name, t in (("w2", w2), ("bias", bias), ("scale", s)):
        if t.device != x2.device:
            raise ValueError("quant_gemm_bias_act: %s is on %s, x2 on %s"
                             % (name, t.device, x2.device))
    xc, wc = x2.contiguous(), w2.contiguous()
    if xc.data_ptr() % 16 or wc.data_ptr() % 16:
        raise ValueError("quant_gemm_bias_act: operands must be 16-byte aligned")
    z = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    y = torch.empty_like(z) if act else None
    lib = _build.load("quant_gemm")
    with torch.cuda.device(x2.device):
        err = lib.quant_gemm_bias_act(
            xc.data_ptr(), wc.data_ptr(), s.data_ptr(), bias.data_ptr(), z.data_ptr(),
            y.data_ptr() if act else None, m, n, k, int(x2.dtype != torch.int8),
            _ACT_CODE[act], torch.cuda.current_stream(x2.device).cuda_stream,
        )
    if err:
        raise RuntimeError("quant_gemm kernel launch failed: %s"
                           % lib.quant_gemm_error_string(err).decode())
    _LAUNCHES[_FORMS[x2.dtype]] += 1
    return z, y
