"""Multi-tensor Adam: the hand-written CUDA kernel (csrc/multi_adam.cu), its
launch counter and its plain torch version.

Replaces paddle_tpu/ops/pallas_kernels.py multi_tensor_adam
(_multi_adam_kernel): Adam over a whole parameter group in one launch, the
_adam f32 expressions rounded to the storage dtypes, with a per-parameter
bias-corrected lr_t. The TPU kernel packs the group into chunk-padded
slabs; the CUDA kernel reads a device table of the tensors' pointers
instead, and updates params and moments IN PLACE, in 4-element vectors
wherever a tensor's four operands share their alignment (a view at an odd
offset is updated element by element, still in place).

Dispatch: `multi_tensor_adam` checks the operands and calls the
torch.library op `paddle_tpu_torch::multi_tensor_adam`, which declares the
params and moments it updates in place (`mutates_args`); its CUDA
implementation launches the kernel (and counts the launch) and raises if it
cannot be built or launched, its CPU implementation is the plain version
(`multi_tensor_adam_plain`), which writes its results into the given
tensors as the kernel does. Nothing falls back silently.
"""

import ctypes
from typing import List

import torch

from . import _build

__all__ = [
    "chunk_elems",
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


def chunk_elems():
    """Elements a CTA of the kernel updates (kChunk of csrc/multi_adam.cu);
    builds the kernel, so it needs the card."""
    return _build.load("multi_adam").multi_adam_chunk_elems()


def _vector_head(quad):
    """Leading elements of a tensor updated one at a time before its first
    4-element vector (0-3), or -1 where its four operands are not at one
    phase mod 4 elements (the kernel then updates it element by element)."""
    phases = set()
    for t in quad:
        size = t.element_size()
        if t.data_ptr() % size:
            return -1
        phases.add(t.data_ptr() // size % 4)
    return (4 - phases.pop()) % 4 if len(phases) == 1 else -1


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


# (pointers, sizes, heads, starts, dtypes, device) -> (pinned host table,
# device table): each distinct set of tensors is uploaded once, from a
# pinned buffer of its own that is never rewritten, since a CUDA graph
# captured over the upload copies from it at every replay
_TABLES = {}
# (params' and moments' pointers, device) -> a pinned buffer no entry
# holds yet: a capture cannot allocate pinned memory, so the upload a
# capture makes (a step's grads live in the graph's pool, at other
# addresses than in its warmup) takes the spare its group's warmup left
_SPARE = {}


def _table(dev, params, grads, m1s, m2s, chunk):
    """The kernel's device table (the four pointers, size, vector head and
    first chunk of every tensor) and its chunk count, uploaded at the first
    call over these tensors and kept (_TABLES). During a CUDA graph capture
    a new set is uploaded from the spare buffer a call over the same
    parameters and moments left, so a capture must follow such a call."""
    ptrs, sizes, heads, starts = [], [], [], [0]
    for quad in zip(params, grads, m1s, m2s):
        ptrs += [t.data_ptr() for t in quad]
        sizes.append(quad[0].numel())
        heads.append(_vector_head(quad))
        starts.append(starts[-1] + -(-quad[0].numel() // chunk))
    host = ptrs + sizes + heads + starts
    key = (tuple(host), tuple(t[0].dtype for t in (params, grads, m1s)), dev)
    entry = _TABLES.get(key)
    if entry is None:
        group = (tuple(t.data_ptr() for t in params + m1s + m2s), dev)
        if torch.cuda.is_current_stream_capturing():
            pinned = _SPARE.pop(group, None)
            if pinned is None:
                raise RuntimeError("multi_tensor_adam: the pinned table is made during a CUDA "
                                   "graph capture; run the step once before capturing it")
            pinned.copy_(torch.tensor(host, dtype=torch.int64))
        else:
            pinned = torch.tensor(host, dtype=torch.int64).pin_memory()
            if group not in _SPARE:
                _SPARE[group] = torch.empty(len(host), dtype=torch.int64, pin_memory=True)
        entry = _TABLES[key] = (pinned, pinned.to(dev, non_blocking=True))
    return entry[1], starts[-1]


def multi_tensor_adam(params, grads, m1s, m2s, lr_ts, beta1, beta2, epsilon):
    """Fused Adam over a param group, in place: one kernel launch updates
    every (param, moment1, moment2). lr_ts are per-param f32 values with the
    bias correction applied (lr * sqrt(1 - beta2^t) / (1 - beta1^t)), as a
    1-D tensor on the params' device (computed there, no host sync) or a
    list. Params must share a dtype, as must grads and moments (the fused
    lowering groups by dtype). Checks the operands, then calls the op
    paddle_tpu_torch::multi_tensor_adam, which declares params and moments
    as the tensors it mutates. Returns (params, m1s, m2s). CUDA tensors
    launch the kernel; CPU tensors run multi_tensor_adam_plain."""
    n = len(params)
    if not (n == len(grads) == len(m1s) == len(m2s)):
        raise ValueError("multi_tensor_adam: %d params, %d grads, %d m1, %d m2"
                         % (n, len(grads), len(m1s), len(m2s)))
    if n == 0:
        return params, m1s, m2s
    dev = params[0].device
    if dev.type == "cuda":
        groups = (params, grads, m1s + m2s)
        for group in groups:
            dtypes = {t.dtype for t in group}
            if len(dtypes) != 1 or next(iter(dtypes)) not in _DTYPE_CODE:
                raise TypeError("multi_tensor_adam: dtypes %s (one of f32/bf16 per slot)"
                                % dtypes)
        for quad in zip(params, grads, m1s, m2s):
            p = quad[0]
            for t in quad:
                if t.shape != p.shape or t.device != dev or not t.is_contiguous():
                    raise ValueError("multi_tensor_adam: tensors of one param must be "
                                     "contiguous, of one shape, on %s" % dev)
    lr = torch.as_tensor(lr_ts, dtype=torch.float32, device=dev).reshape(-1).contiguous()
    if lr.numel() != n:
        raise ValueError("multi_tensor_adam: %d lr_t values for %d params" % (lr.numel(), n))
    _multi_tensor_adam_op(list(params), list(grads), list(m1s), list(m2s), lr, float(beta1),
                          float(beta2), float(epsilon))
    return params, m1s, m2s


# the op: one entry for the executor, CUDA graphs and torch.export, whose
# graphs record its in-place update of params and moments as mutations
@torch.library.custom_op("paddle_tpu_torch::multi_tensor_adam",
                         mutates_args=("params", "m1s", "m2s"), device_types="cpu")
def _multi_tensor_adam_op(params: List[torch.Tensor], grads: List[torch.Tensor],
                          m1s: List[torch.Tensor], m2s: List[torch.Tensor],
                          lr_ts: torch.Tensor, beta1: float, beta2: float,
                          epsilon: float) -> None:
    multi_tensor_adam_plain(params, grads, m1s, m2s, lr_ts, beta1, beta2, epsilon)


@_multi_tensor_adam_op.register_fake
def _(params, grads, m1s, m2s, lr_ts, beta1, beta2, epsilon):
    return None


@_multi_tensor_adam_op.register_kernel("cuda")
def _(params, grads, m1s, m2s, lr_ts, beta1, beta2, epsilon):
    dev = params[0].device
    lib = _build.load("multi_adam")
    table, n_chunks = _table(dev, params, grads, m1s, m2s, chunk_elems())
    with torch.cuda.device(dev):
        err = lib.multi_adam(
            table.data_ptr(), lr_ts.data_ptr(), len(params), n_chunks,
            _DTYPE_CODE[params[0].dtype], _DTYPE_CODE[grads[0].dtype],
            _DTYPE_CODE[m1s[0].dtype], float(beta1), float(1 - beta1), float(beta2),
            float(1 - beta2), float(epsilon), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError("multi_adam kernel launch failed: %s"
                           % lib.multi_adam_error_string(err).decode())
    _LAUNCHES["multi_adam"] += 1
