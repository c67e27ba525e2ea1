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
the result in x's dtype, at any shape, batched operands included, with
the gradient jax.vjp gives it. On the card its forward is one launch of
csrc/fp8_gemm.cu, which rounds both operands in the GEMM's producer; with
bf16 operands and g its gradients are that family's dx and dy forms
(bf16 tensor cores, f32 sums, the e4m3 rounding in the epilogue); an f32
g (or a partly broadcast operand) takes f32 library matmuls rounded by
the family's e4m3_round_kernel.

Dispatch: `quant_gemm_bias_act` and `fp8_matmul` launch their kernels for
tensors on a CUDA device and raise if they cannot be built or launched, or
if the shape is one the kernel does not take (quant_gemm_bias_act: k or n
not a multiple of 16; fp8_matmul: more than 65535 matrices a batch); they
run their plain versions (`quant_gemm_bias_act_plain`, `fp8_matmul_plain`,
`e4m3_round_plain`, `fp8_matmul_grads_plain`) only for tensors on the CPU
or the meta device.
"""

import ctypes
import math

import torch

from . import _build
from .gemm_epilogue import ACT_F32
from .registry import reduce_grad_to_shape

__all__ = [
    "e4m3_round_plain",
    "e4m3_round_twin",
    "fp8_matmul",
    "fp8_matmul_grads_plain",
    "fp8_matmul_plain",
    "kernel_launches",
    "quant_gemm_bias_act",
    "quant_gemm_bias_act_plain",
    "reset_kernel_launches",
]

_ACT_CODE = {None: 0, "relu": 1, "gelu": 2, "tanh": 3, "sigmoid": 4}
_FORMS = {torch.int8: "quant_gemm_int8", torch.float8_e4m3fn: "quant_gemm_fp8"}

# fp8_matmul's kernels of csrc/fp8_gemm.cu: the forward, the two gradient
# forms and the rounding pass
_FP8_FORMS = {"fwd": (0, "fp8_matmul"), "dx": (1, "fp8_matmul_dx"), "dy": (2, "fp8_matmul_dy")}

# launches by kernel, counted where the wrapper launches it and nowhere else
_LAUNCHES = dict({name: 0 for name in _FORMS.values()},
                 **{key: 0 for _, key in _FP8_FORMS.values()}, e4m3_round=0)

_F8 = torch.float8_e4m3fn
_E4M3_PAST = 464.0  # |v| above it rounds past e4m3's largest finite value, 448
_MM_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_launches():
    """Kernel launches so far, keyed "quant_gemm_int8", "quant_gemm_fp8",
    and fp8_matmul's "fp8_matmul" (the forward form), "fp8_matmul_dx",
    "fp8_matmul_dy" and "e4m3_round"."""
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


class _Operand(ctypes.Structure):
    """fp8_gemm.cu's Operand: a row-major [rows, cols] view a matrix, matrix
    (z, r) at p + z * sz + r * sr elements; vec: every row start 16-byte
    aligned."""

    _fields_ = [("p", ctypes.c_void_p), ("sz", ctypes.c_longlong), ("sr", ctypes.c_longlong),
                ("ld", ctypes.c_longlong), ("rows", ctypes.c_int), ("cols", ctypes.c_int),
                ("vec", ctypes.c_int), ("pad_", ctypes.c_int)]


class _Problem(ctypes.Structure):
    """fp8_gemm.cu's Problem: out [batch, rows, cols], summed over nr
    reduced matrices of kt_per 64-deep stages, split over `splits` CTAs a
    tile (their f32 sums in ws) where splits > 1."""

    _fields_ = [("a", _Operand), ("b", _Operand), ("out", ctypes.c_void_p),
                ("ws", ctypes.c_void_p), ("so", ctypes.c_longlong), ("ldo", ctypes.c_longlong),
                ("rows", ctypes.c_int), ("cols", ctypes.c_int), ("ovec", ctypes.c_int),
                ("batch", ctypes.c_int), ("nr", ctypes.c_int), ("kt_per", ctypes.c_int),
                ("splits", ctypes.c_int), ("pad_", ctypes.c_int)]


def _bind_fp8(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fp8_gemm.argtypes = [ctypes.POINTER(_Problem)] + [i32] * 3 + [ptr]
    lib.fp8_gemm.restype = i32
    lib.e4m3_round.argtypes = [ptr, ptr, ctypes.c_int64, i32, ptr]
    lib.e4m3_round.restype = i32
    lib.fp8_gemm_error_string.argtypes = [i32]
    lib.fp8_gemm_error_string.restype = ctypes.c_char_p


_build.register("fp8_gemm", _bind_fp8)


def _wide_product(x2, w2):
    """x2 @ w2 as f32: int8 levels multiply as float64, whose sums are exact
    integers here (|sum| <= k * 127^2 < 2^53; torch.matmul takes no integer
    tensors on CUDA, and an f32 sum is inexact past 2^24), then round once
    to f32 like the JAX package's i32 -> f32; e4m3 values as f32."""
    if x2.dtype == torch.int8:
        return torch.matmul(x2.double(), w2.double()).float()
    return torch.matmul(x2.float(), w2.float())


def _round16(v):
    return -(-v // 16) * 16


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

_MAX_BATCH = 65535  # a grid's z axis
_TILE = 128  # fp8_gemm.cu's output tile, rows and columns
_SMS = 132  # an H100 SXM's SMs: a grid of fewer tiles than half of them splits
_MIN_SPLIT_STAGES = 4  # 64-deep stages a split keeps at least


def e4m3_round_plain(t):
    """t rounded to float8_e4m3fn and widened to f32, as ml_dtypes and XLA
    convert round it: to nearest even, with what rounds past 448 (|t| > 464,
    inf) and NaN giving NaN of t's sign. torch's own cast saturates to 448
    there, so those values are set here."""
    t = t.float()
    nan = torch.copysign(torch.full_like(t, float("nan")), t)
    return torch.where(t.abs() <= _E4M3_PAST, t.to(_F8).float(), nan)


def e4m3_round_twin(t):
    """The same rule in integer steps on t's f32 bits: normal values (2^-6
    and up) keep 3 of 23 mantissa bits, the dropped 20 rounded to even;
    subnormals are multiples of 2^-9 (|t| * 512 rounded to even, exact);
    |t| past 464 (0x43e80000), inf and NaN give NaN of t's sign. Returns
    f32; e4m3_round_plain bit for bit (tests/test_torch_fp8.py)."""
    bits = t.float().contiguous().view(torch.int32)
    sign = bits & -(1 << 31)
    a = bits & 0x7FFFFFFF
    normal = (a + 0x7FFFF + ((a >> 20) & 1)) & -(1 << 20)
    sub = (torch.round(a.view(torch.float32) * 512.0) / 512.0).view(torch.int32)
    out = torch.where(a > 0x43E80000, torch.full_like(a, 0x7FC00000),
                      torch.where(a >= 0x3C800000, normal, sub))
    return (out | sign).view(torch.float32)


def fp8_matmul_plain(x, y):
    """The cast plus an f32 torch.matmul of the widened e4m3 values, the
    result in x's dtype (the JAX function's contract)."""
    return torch.matmul(e4m3_round_plain(x), e4m3_round_plain(y)).to(x.dtype)


def fp8_matmul_grads_plain(x, y, g, need=(True, True)):
    """jax.vjp of the JAX function: dx = e4m3(g @ y8^T) and dy = e4m3(x8^T @
    g) with f32 sums, each summed over what its operand is broadcast over
    before its one rounding, in the operand's dtype (None where `need` says
    so)."""
    g32 = g.float()
    dx = dy = None
    if need[0]:
        dx = torch.matmul(g32, e4m3_round_plain(y).transpose(-1, -2))
        dx = e4m3_round_plain(reduce_grad_to_shape(dx, x.shape)).to(x.dtype)
    if need[1]:
        dy = torch.matmul(e4m3_round_plain(x).transpose(-1, -2), g32)
        dy = e4m3_round_plain(reduce_grad_to_shape(dy, y.shape)).to(y.dtype)
    return dx, dy


def _lib8():
    return _build.load("fp8_gemm")


def _raise_if(err, what):
    if err:
        raise RuntimeError("%s kernel launch failed: %s"
                           % (what, _lib8().fp8_gemm_error_string(err).decode()))


def _e4m3_round_cuda(t):
    """t (f32 or bf16) rounded to e4m3 by e4m3_round_kernel, in t's dtype."""
    if t.dtype not in _MM_DTYPES:
        raise TypeError("e4m3_round: f32 or bf16, got %s" % t.dtype)
    src = t.contiguous()
    dst = torch.empty_like(src)
    if src.numel() == 0:
        return dst
    with torch.cuda.device(t.device):
        err = _lib8().e4m3_round(src.data_ptr(), dst.data_ptr(), src.numel(),
                                 _MM_DTYPES[t.dtype],
                                 torch.cuda.current_stream(t.device).cuda_stream)
    _raise_if(err, "e4m3_round")
    _LAUNCHES["e4m3_round"] += 1
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


def _operand(t, rows, cols, sz=0, sr=0):
    """The Operand of a contiguous [*, rows, cols] tensor, matrices sz (the
    output's batch) and sr (the reduced batch) elements apart."""
    e = t.element_size()
    vec = (t.data_ptr() % 16 == 0 and cols * e % 16 == 0 and sz * e % 16 == 0
           and sr * e % 16 == 0)
    return _Operand(t.data_ptr(), sz, sr, cols, rows, cols, int(vec), 0)


def _splits(tiles, stages):
    """CTAs a tile: the reduction split where the output's tiles fill less
    than half the card, each split at least _MIN_SPLIT_STAGES stages long
    (the last one too)."""
    if 2 * tiles >= _SMS or stages < 2 * _MIN_SPLIT_STAGES:
        return 1
    want = min(-(-_SMS // tiles), stages // _MIN_SPLIT_STAGES)
    per = -(-stages // want)
    return -(-stages // per)


def _fp8_gemm(form, a, b, load_dtype, out, rows, cols, red, nr=1):
    """One launch of fp8_gemm.cu's `form` ("fwd", "dx", "dy") into out
    [batch, rows, cols] (contiguous), the reduction over red values of nr
    matrices (with a split reduction, the kernel and its split sum)."""
    batch = out.numel() // (rows * cols)
    stages = nr * -(-red // 64)
    splits = _splits(-(-rows // _TILE) * -(-cols // _TILE) * batch, stages)
    if batch * splits > _MAX_BATCH or nr > _MAX_BATCH:
        raise ValueError("fp8_matmul: the kernel takes at most %d matrices a batch, got %d"
                         % (_MAX_BATCH, max(batch, nr)))
    code, key = _FP8_FORMS[form]
    ws = (torch.empty((batch, splits, rows, cols), dtype=torch.float32, device=out.device)
          if splits > 1 else None)
    ovec = out.data_ptr() % 16 == 0 and cols % 4 == 0
    pr = _Problem(a, b, out.data_ptr(), None if ws is None else ws.data_ptr(), rows * cols, cols,
                  rows, cols, int(ovec), batch, nr, -(-red // 64), splits, 0)
    with torch.cuda.device(out.device):
        err = _lib8().fp8_gemm(ctypes.byref(pr), code, _MM_DTYPES[load_dtype],
                               _MM_DTYPES[out.dtype],
                               torch.cuda.current_stream(out.device).cuda_stream)
    _raise_if(err, key)
    _LAUNCHES[key] += 1
    return out


def _check_cuda(x, y):
    if x.dtype not in _MM_DTYPES or y.dtype not in _MM_DTYPES:
        raise TypeError("fp8_matmul: the kernel takes f32 or bf16 operands, got %s and %s"
                        % (x.dtype, y.dtype))
    if y.device != x.device:
        raise ValueError("fp8_matmul: y is on %s, x on %s" % (y.device, x.device))


def _fp8_matmul_cuda(x, y):
    """The forward: one launch, both operands read in their dtype (a bf16
    one beside an f32 one widened to f32 first, exactly)."""
    _check_cuda(x, y)
    m, k = x.shape[-2:]
    n = y.shape[-1]
    batch = torch.broadcast_shapes(tuple(x.shape[:-2]), tuple(y.shape[:-2]))
    out = torch.empty(tuple(batch) + (m, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    lt = torch.bfloat16 if x.dtype == y.dtype == torch.bfloat16 else torch.float32
    x3, xb = _batched_operand(x.to(lt), batch)
    y3, yb = _batched_operand(y.to(lt), batch)
    x3, y3 = x3.contiguous(), y3.contiguous()
    return _fp8_gemm("fwd", _operand(x3, m, k, sz=m * k * xb), _operand(y3, k, n, sz=k * n * yb),
                     lt, out, m, n, k)


def _whole_or_shared(t, batch):
    own = tuple(t.shape[:-2])
    return own == tuple(batch) or math.prod(own) == 1


def _fp8_grads_cuda(x, y, g, need):
    """The gradients on the card: bf16 x, y and g through the dx and dy
    forms (an operand shared by the batch summed over batch x its rows in
    the kernel); otherwise f32 library products rounded by e4m3_round."""
    _check_cuda(x, y)
    m, k = x.shape[-2:]
    n = y.shape[-1]
    batch = tuple(g.shape[:-2])
    nb = math.prod(batch)
    if not (x.dtype == y.dtype == g.dtype == torch.bfloat16 and g.numel() and k
            and _whole_or_shared(x, batch) and _whole_or_shared(y, batch)):
        return _fp8_grads_library(x, y, g, need)
    g3 = g.reshape((nb, m, n)).contiguous()
    x3, xb = _batched_operand(x, batch)
    y3, yb = _batched_operand(y, batch)
    x3, y3 = x3.contiguous(), y3.contiguous()
    dx = dy = None
    if need[0]:
        # dx [m, k] sums g [m, n] (K-major) against y [k, n] (K-major) over n
        shared = not xb and nb > 1
        zs, rs = (0, m * n) if shared else (m * n, 0)
        a = _operand(g3, m, n, sz=zs, sr=rs)
        b = _operand(y3, k, n, sz=0 if shared else k * n * yb, sr=k * n * yb if shared else 0)
        out = torch.empty((1 if shared else nb, m, k), dtype=x.dtype, device=x.device)
        dx = _fp8_gemm("dx", a, b, g.dtype, out, m, k, n, nr=nb if shared else 1).reshape(x.shape)
    if need[1]:
        # dy [k, n] sums x [m, k] (MN-major) against g [m, n] (MN-major) over m
        shared = not yb and nb > 1
        a = _operand(x3, m, k, sz=0 if shared else m * k * xb, sr=m * k * xb if shared else 0)
        zs, rs = (0, m * n) if shared else (m * n, 0)
        b = _operand(g3, m, n, sz=zs, sr=rs)
        out = torch.empty((1 if shared else nb, k, n), dtype=y.dtype, device=y.device)
        dy = _fp8_gemm("dy", a, b, g.dtype, out, k, n, m, nr=nb if shared else 1).reshape(y.shape)
    return dx, dy


def _fp8_grads_library(x, y, g, need):
    """f32 library products (XLA's dots in the JAX package), each rounding
    by the e4m3_round kernel."""
    g32 = g.float()
    dx = dy = None
    if need[0]:
        dx = torch.matmul(g32, _e4m3_round_cuda(y).float().transpose(-1, -2))
        dx = _e4m3_round_cuda(reduce_grad_to_shape(dx, x.shape)).to(x.dtype)
    if need[1]:
        dy = torch.matmul(_e4m3_round_cuda(x).float().transpose(-1, -2), g32)
        dy = _e4m3_round_cuda(reduce_grad_to_shape(dy, y.shape)).to(y.dtype)
    return dx, dy


class _Fp8Matmul(torch.autograd.Function):
    """fp8_matmul with the JAX function's gradient: jax.vjp of the cast, the
    f32-summed product and the output cast gives dx = e4m3(g @ y8^T) and
    dy = e4m3(x8^T @ g), each summed over what its operand is broadcast
    over, then rounded to e4m3 once (its operand's cast transposed) and
    returned in the operand's dtype. torch.func.vjp (the generic grads)
    runs it: forward and setup_context are separate."""

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
        need = tuple(ctx.needs_input_grad[:2])
        if x.device.type != "cuda":
            return fp8_matmul_grads_plain(x, y, g, need)
        return _fp8_grads_cuda(x, y, g, need)


def fp8_matmul(x, y):
    """x @ y with both operands cast to float8_e4m3fn and f32 sums, the result
    in x's dtype. x is (..., m, k), y (..., k, n), leading dims broadcast as
    in torch.matmul. CUDA tensors launch fp8_gemm.cu (f32 or bf16
    operands); CPU tensors run fp8_matmul_plain."""
    if not (torch.is_floating_point(x) and torch.is_floating_point(y)):
        raise TypeError("fp8_matmul: floating operands, got %s and %s" % (x.dtype, y.dtype))
    if x.dim() < 2 or y.dim() < 2 or x.shape[-1] != y.shape[-2]:
        raise ValueError("fp8_matmul: shapes %s @ %s" % (tuple(x.shape), tuple(y.shape)))
    return _Fp8Matmul.apply(x, y)
