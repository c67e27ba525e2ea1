"""Multi-tensor Adam: the hand-written CUDA kernel (csrc/multi_adam.cu), its
launch counter and its plain torch version.

Replaces paddle_tpu/ops/pallas_kernels.py multi_tensor_adam
(_multi_adam_kernel): Adam over a whole parameter group in one launch, the
_adam f32 expressions rounded to the storage dtypes, with a per-parameter
bias-corrected lr_t. The TPU kernel packs the group into chunk-padded
slabs; the CUDA kernel reads a device table of the tensors' pointers
instead, and updates params and moments IN PLACE.

Dispatch: `multi_tensor_adam` launches the kernel for tensors on a CUDA
device and raises if it cannot be built or launched; it runs the plain
version (`multi_tensor_adam_plain`) only for tensors on the CPU, and writes
its results into the given tensors as the kernel does. Nothing falls back
silently.
"""

import ctypes

import torch

from . import _build

__all__ = [
    "kernel_launches",
    "multi_tensor_adam",
    "multi_tensor_adam_plain",
    "reset_kernel_launches",
]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# launches, counted where the wrapper launches its kernel and nowhere else
_LAUNCHES = {"multi_adam": 0}


def kernel_launches():
    return dict(_LAUNCHES)


def reset_kernel_launches():
    _LAUNCHES["multi_adam"] = 0


def _bind(lib):
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib.multi_adam.argtypes = [ptr, ptr, i32, i64, i32, i32, i32] + [f32] * 5 + [ptr]
    lib.multi_adam.restype = i32
    lib.multi_adam_chunk_elems.argtypes = []
    lib.multi_adam_chunk_elems.restype = i32
    lib.multi_adam_error_string.argtypes = [i32]
    lib.multi_adam_error_string.restype = ctypes.c_char_p


_build.register("multi_adam", _bind)


def multi_tensor_adam_plain(params, grads, m1s, m2s, lr_ts, beta1, beta2, epsilon):
    """Per tensor, the _adam f32 expressions rounded to the storage dtypes;
    results written into params/m1s/m2s. lr_ts: one f32 value per tensor (a
    1-D tensor or a list of scalars). Returns (params, m1s, m2s)."""
    lr_ts = torch.as_tensor(lr_ts, dtype=torch.float32).reshape(-1)
    for i, (p, g, m1, m2) in enumerate(zip(params, grads, m1s, m2s)):
        gf = g.float()
        m1o = beta1 * m1.float() + (1 - beta1) * gf
        m2o = beta2 * m2.float() + (1 - beta2) * torch.square(gf)
        po = p.float() - lr_ts[i].to(p.device) * m1o / (torch.sqrt(m2o) + epsilon)
        p.copy_(po)
        m1.copy_(m1o)
        m2.copy_(m2o)
    return params, m1s, m2s


def multi_tensor_adam(params, grads, m1s, m2s, lr_ts, beta1, beta2, epsilon):
    """Fused Adam over a param group, in place: one kernel launch updates
    every (param, moment1, moment2). lr_ts are per-param f32 values with the
    bias correction applied (lr * sqrt(1 - beta2^t) / (1 - beta1^t)), as a
    1-D tensor on the params' device (computed there, no host sync) or a
    list. Params must share a dtype, as must grads and moments (the fused
    lowering groups by dtype). Returns (params, m1s, m2s). CUDA tensors
    launch the kernel; CPU tensors run multi_tensor_adam_plain."""
    n = len(params)
    if not (n == len(grads) == len(m1s) == len(m2s)):
        raise ValueError("multi_tensor_adam: %d params, %d grads, %d m1, %d m2"
                         % (n, len(grads), len(m1s), len(m2s)))
    if n == 0:
        return params, m1s, m2s
    dev = params[0].device
    if dev.type != "cuda":
        return multi_tensor_adam_plain(params, grads, m1s, m2s, lr_ts, beta1, beta2, epsilon)
    groups = (params, grads, m1s + m2s)
    for group in groups:
        dtypes = {t.dtype for t in group}
        if len(dtypes) != 1 or next(iter(dtypes)) not in _DTYPE_CODE:
            raise TypeError("multi_tensor_adam: dtypes %s (one of f32/bf16 per slot)" % dtypes)
    for quad in zip(params, grads, m1s, m2s):
        p = quad[0]
        for t in quad:
            if t.shape != p.shape or t.device != dev or not t.is_contiguous():
                raise ValueError("multi_tensor_adam: tensors of one param must be "
                                 "contiguous, of one shape, on %s" % dev)
    lr = torch.as_tensor(lr_ts, dtype=torch.float32, device=dev).reshape(-1).contiguous()
    if lr.numel() != n:
        raise ValueError("multi_tensor_adam: %d lr_t values for %d params" % (lr.numel(), n))
    lib = _build.load("multi_adam")
    chunk = lib.multi_adam_chunk_elems()
    ptrs, sizes, starts = [], [], [0]
    for p, g, m1, m2 in zip(params, grads, m1s, m2s):
        ptrs += [p.data_ptr(), g.data_ptr(), m1.data_ptr(), m2.data_ptr()]
        sizes.append(p.numel())
        starts.append(starts[-1] + -(-p.numel() // chunk))
    # the table rides a pinned buffer: the copy is queued on the stream, and
    # the caching host allocator keeps the buffer until the copy has run
    table = torch.tensor(ptrs + sizes + starts, dtype=torch.int64).pin_memory()
    table = table.to(dev, non_blocking=True)
    with torch.cuda.device(dev):
        err = lib.multi_adam(
            table.data_ptr(), lr.data_ptr(), n, starts[-1],
            _DTYPE_CODE[params[0].dtype], _DTYPE_CODE[grads[0].dtype],
            _DTYPE_CODE[m1s[0].dtype], float(beta1), float(1 - beta1), float(beta2),
            float(1 - beta2), float(epsilon), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError("multi_adam kernel launch failed: %s"
                           % lib.multi_adam_error_string(err).decode())
    _LAUNCHES["multi_adam"] += 1
    return params, m1s, m2s
