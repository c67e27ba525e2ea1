"""Fused GEMM + bias + activation epilogue: the hand-written CUDA kernel
(csrc/gemm_epilogue.cu), its launch counter and its plain torch version.

Replaces paddle_tpu/ops/pallas_kernels.py gemm_bias_act (_gemm_epilogue_kernel)
and _gemm_bias_act_dbuf (_gemm_dbuf_kernel), which compute the same function
bit for bit: z = x2 @ w2 + bias with an f32 accumulator, y = act(z) on the
f32 value, each rounded once to the operand dtype.

Dispatch: `gemm_bias_act` launches the kernel for tensors on a CUDA device
and raises if it cannot be built or launched; it runs the plain version
(`gemm_bias_act_plain`) only for tensors on the CPU. Nothing falls back
silently.
"""

import ctypes

import torch

from . import _build

__all__ = [
    "ACT_F32",
    "gemm_bias_act",
    "gemm_bias_act_plain",
    "kernel_launches",
    "reset_kernel_launches",
]

# epilogue activations on the f32 accumulator, and the lowerings of the
# relu / gelu / tanh / sigmoid ops (core_ops.py); gelu is the erf form
# (jax.nn.gelu(approximate=False))
ACT_F32 = {
    "relu": torch.relu,
    "gelu": lambda z: torch.nn.functional.gelu(z, approximate="none"),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}
_ACT_CODE = {None: 0, "relu": 1, "gelu": 2, "tanh": 3, "sigmoid": 4}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# launches, counted where the wrapper launches its kernel and nowhere else
_LAUNCHES = {"gemm_epilogue": 0}


def kernel_launches():
    return dict(_LAUNCHES)


def reset_kernel_launches():
    _LAUNCHES["gemm_epilogue"] = 0


def _bind(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gemm_bias_act.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
    lib.gemm_bias_act.restype = i32
    lib.gemm_epilogue_error_string.argtypes = [i32]
    lib.gemm_epilogue_error_string.restype = ctypes.c_char_p


_build.register("gemm_epilogue", _bind)


def gemm_bias_act_plain(x2, w2, bias_row, act=None):
    """z = x2 @ w2 + bias in f32, y = act(z); each rounded once to x2's
    dtype. Returns (z, y), y None without an act (the JAX package's dense
    form of gemm_bias_act)."""
    z32 = torch.matmul(x2.float(), w2.float()) + bias_row.reshape(1, -1).float()
    y = ACT_F32[act](z32).to(x2.dtype) if act else None
    return z32.to(x2.dtype), y


def gemm_bias_act(x2, w2, bias_row, act=None):
    """act(x2 @ w2 + bias) over 2-D operands with the bias and activation
    fused into the GEMM epilogue. bias_row holds n values ((1, n) or (n,)).
    Returns (z, y): z the post-bias pre-activation value, y = act(z), None
    when act is None. CUDA tensors launch the kernel; CPU tensors run
    gemm_bias_act_plain."""
    if act not in _ACT_CODE:
        raise ValueError("gemm_bias_act: unknown act %r" % (act,))
    if x2.device.type != "cuda":
        return gemm_bias_act_plain(x2, w2, bias_row, act)
    if x2.dim() != 2 or w2.dim() != 2 or x2.shape[1] != w2.shape[0]:
        raise ValueError("gemm_bias_act: shapes %s @ %s" % (tuple(x2.shape), tuple(w2.shape)))
    if x2.dtype != w2.dtype or x2.dtype not in _DTYPE_CODE:
        raise TypeError("gemm_bias_act: operands must share f32 or bf16, got %s and %s"
                        % (x2.dtype, w2.dtype))
    m, k = x2.shape
    n = w2.shape[1]
    bias = bias_row.reshape(-1)
    if bias.numel() != n:
        raise ValueError("gemm_bias_act: %d bias values for n=%d" % (bias.numel(), n))
    for name, t in (("w2", w2), ("bias", bias)):
        if t.device != x2.device:
            raise ValueError("gemm_bias_act: %s is on %s, x2 on %s" % (name, t.device, x2.device))
    xc, wc = x2.contiguous(), w2.contiguous()
    bias = bias.to(torch.float32).contiguous()  # widening a float is exact
    z = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    y = torch.empty_like(z) if act else None
    lib = _build.load("gemm_epilogue")
    with torch.cuda.device(x2.device):
        err = lib.gemm_bias_act(
            xc.data_ptr(), wc.data_ptr(), bias.data_ptr(), z.data_ptr(),
            y.data_ptr() if act else None, m, n, k, _DTYPE_CODE[x2.dtype],
            _ACT_CODE[act], torch.cuda.current_stream(x2.device).cuda_stream,
        )
    if err:
        raise RuntimeError("gemm_epilogue kernel launch failed: %s"
                           % lib.gemm_epilogue_error_string(err).decode())
    _LAUNCHES["gemm_epilogue"] += 1
    return z, y
