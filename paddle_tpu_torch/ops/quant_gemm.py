"""Quantized GEMM + dequant scale + bias + activation: the hand-written CUDA
kernel (csrc/quant_gemm.cu), its launch counters and its plain torch
version.

Replaces paddle_tpu/ops/pallas_kernels.py quant_gemm_bias_act
(_quant_gemm_kernel), both operand forms: int8 x int8 with exact i32 sums,
and float8 e4m3 x e4m3 with f32 sums. Either way z = (x2 @ w2) * scale +
bias with one combined per-tensor scale and y = act(z), f32 out.

Also `fp8_matmul`, the counterpart of paddle_tpu/ops/pallas_kernels.py
fp8_matmul (FLAGS_fp8_matmul's dtype policy for the mul / matmul
lowerings): both operands cast to float8_e4m3fn, contracted with f32 sums,
the result in x's dtype, at any shape, batched operands included. On the
card it is two hand-written launches of csrc/quant_gemm.cu: the cast pass
(e4m3_cast_pad_kernel, once per operand, into zero-padded staging buffers
with k and n rounded up to 16) and the e4m3 GEMM with the batch on the
grid's z axis, writing x's dtype at the real n.

Dispatch: `quant_gemm_bias_act` and `fp8_matmul` launch their kernels for
tensors on a CUDA device and raise if they cannot be built or launched, or
if the shape is one the kernel does not take (quant_gemm_bias_act: k or n
not a multiple of 16); they run their plain versions
(`quant_gemm_bias_act_plain`, `fp8_matmul_plain`) only for tensors on the
CPU.
"""

import ctypes
import math

import torch

from . import _build
from .gemm_epilogue import ACT_F32
from .registry import reduce_grad_to_shape

__all__ = [
    "e4m3_round_plain",
    "fp8_matmul",
    "fp8_matmul_plain",
    "kernel_launches",
    "quant_gemm_bias_act",
    "quant_gemm_bias_act_plain",
    "reset_kernel_launches",
]

_ACT_CODE = {None: 0, "relu": 1, "gelu": 2, "tanh": 3, "sigmoid": 4}
_FORMS = {torch.int8: "quant_gemm_int8", torch.float8_e4m3fn: "quant_gemm_fp8"}

# launches by operand form, and of fp8_matmul's cast pass ("e4m3_cast"),
# counted where the wrapper launches its kernel and nowhere else
_LAUNCHES = dict({name: 0 for name in _FORMS.values()}, e4m3_cast=0)

_F8 = torch.float8_e4m3fn
_E4M3_PAST = 464.0  # |v| above it rounds past e4m3's largest finite value, 448
_MM_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_launches():
    """Kernel launches so far, keyed "quant_gemm_int8", "quant_gemm_fp8"
    (fp8_matmul's products among them) and "e4m3_cast"."""
    return dict(_LAUNCHES)


def reset_kernel_launches():
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def _bind(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.quant_gemm_bias_act.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.quant_gemm_bias_act.restype = i32
    i64 = ctypes.c_int64
    lib.e4m3_cast_pad.argtypes = [ptr, ptr] + [i32] * 5 + [i64, i32, ptr]
    lib.e4m3_cast_pad.restype = i32
    lib.fp8_matmul_launch.argtypes = [ptr] * 3 + [i32] * 5 + [i64] * 3 + [i32, i32, ptr]
    lib.fp8_matmul_launch.restype = i32
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


# ---------------------------------------------------------------------------
# fp8_matmul
# ---------------------------------------------------------------------------


def e4m3_round_plain(t):
    """t rounded to float8_e4m3fn and widened to f32, as ml_dtypes and XLA
    convert round it: to nearest even, with what rounds past 448 (|t| > 464,
    inf) and NaN giving NaN of t's sign. torch's own cast saturates to 448
    there, so those values are set here."""
    t = t.float()
    nan = torch.copysign(torch.full_like(t, float("nan")), t)
    return torch.where(t.abs() <= _E4M3_PAST, t.to(_F8).float(), nan)


def fp8_matmul_plain(x, y):
    """The cast plus an f32 torch.matmul of the widened e4m3 values, the
    result in x's dtype (the JAX function's contract)."""
    return torch.matmul(e4m3_round_plain(x), e4m3_round_plain(y)).to(x.dtype)


def _lib():
    return _build.load("quant_gemm")


def _raise_if(err, what):
    if err:
        raise RuntimeError("%s kernel launch failed: %s"
                           % (what, _lib().quant_gemm_error_string(err).decode()))


def _round16(v):
    return -(-v // 16) * 16


def _stage_e4m3(t, rows_p, cols_p):
    """t [B, R, C] (f32 or bf16) cast to e4m3 bytes in a new [B, rows_p,
    cols_p] buffer, zero past R and C, by the cast kernel."""
    b, r, c = t.shape
    src = t.contiguous()
    dst = torch.empty((b, rows_p, cols_p), dtype=torch.uint8, device=t.device)
    err = _lib().e4m3_cast_pad(
        src.data_ptr(), dst.data_ptr(), b, r, c, rows_p, cols_p, r * c,
        _MM_DTYPES[t.dtype], torch.cuda.current_stream(t.device).cuda_stream)
    _raise_if(err, "e4m3_cast")
    _LAUNCHES["e4m3_cast"] += 1
    return dst


def _batched_operand(t, batch):
    """(t as [B, R, C], batch stride in matrices): an operand that covers the
    whole broadcast batch, or one matrix shared by it (stride 0); a partly
    broadcast operand is expanded first."""
    own = tuple(t.shape[:-2])
    if math.prod(own) == 1:
        return t.reshape((1,) + tuple(t.shape[-2:])), 0
    if own != tuple(batch):
        t = t.expand(tuple(batch) + tuple(t.shape[-2:]))
    return t.reshape((-1,) + tuple(t.shape[-2:])), 1


def _fp8_matmul_cuda(x, y):
    if x.dtype not in _MM_DTYPES or y.dtype not in _MM_DTYPES:
        raise TypeError("fp8_matmul: the kernel takes f32 or bf16 operands, got %s and %s"
                        % (x.dtype, y.dtype))
    if y.device != x.device:
        raise ValueError("fp8_matmul: y is on %s, x on %s" % (y.device, x.device))
    m, k = x.shape[-2:]
    n = y.shape[-1]
    batch = torch.broadcast_shapes(tuple(x.shape[:-2]), tuple(y.shape[:-2]))
    nb = math.prod(batch)
    out = torch.empty(tuple(batch) + (m, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    kp, np_ = _round16(k), _round16(n)
    x3, x_batched = _batched_operand(x, batch)
    y3, y_batched = _batched_operand(y, batch)
    with torch.cuda.device(x.device):
        x8 = _stage_e4m3(x3, m, kp)
        y8 = _stage_e4m3(y3, kp, np_)
        err = _lib().fp8_matmul_launch(
            x8.data_ptr(), y8.data_ptr(), out.data_ptr(), m, n, kp, np_, nb,
            m * kp * x_batched, kp * np_ * y_batched, m * n, n, _MM_DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_if(err, "fp8_matmul")
    _LAUNCHES["quant_gemm_fp8"] += 1
    return out


class _Fp8Matmul(torch.autograd.Function):
    """fp8_matmul with the JAX function's gradient: jax.vjp of the cast, the
    f32-summed product and the output cast gives dx = e4m3(g @ y8^T) and
    dy = e4m3(x8^T @ g), each rounded to e4m3 (its operand's cast
    transposed) and returned in the operand's dtype; g enters in f32. The
    backward's products are f32 library matmuls, as XLA's dots are in the
    JAX package. torch.func.vjp (the generic grads) runs it: forward and
    setup_context are separate."""

    @staticmethod
    def forward(x, y):
        if x.device.type != "cuda":
            return fp8_matmul_plain(x, y)
        return _fp8_matmul_cuda(x, y)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        g32 = g.float()
        dx = dy = None
        if ctx.needs_input_grad[0]:
            dx = e4m3_round_plain(torch.matmul(g32, e4m3_round_plain(y).transpose(-1, -2)))
            dx = reduce_grad_to_shape(dx, x.shape).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dy = e4m3_round_plain(torch.matmul(e4m3_round_plain(x).transpose(-1, -2), g32))
            dy = reduce_grad_to_shape(dy, y.shape).to(y.dtype)
        return dx, dy


def fp8_matmul(x, y):
    """x @ y with both operands cast to float8_e4m3fn and f32 sums, the result
    in x's dtype. x is (..., m, k), y (..., k, n), leading dims broadcast as
    in torch.matmul. CUDA tensors launch the cast pass and the e4m3 GEMM
    (f32 or bf16 operands); CPU tensors run fp8_matmul_plain."""
    if not (torch.is_floating_point(x) and torch.is_floating_point(y)):
        raise TypeError("fp8_matmul: floating operands, got %s and %s" % (x.dtype, y.dtype))
    if x.dim() < 2 or y.dim() < 2 or x.shape[-1] != y.shape[-2]:
        raise ValueError("fp8_matmul: shapes %s @ %s" % (tuple(x.shape), tuple(y.shape)))
    return _Fp8Matmul.apply(x, y)
