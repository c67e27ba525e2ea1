"""Flash attention, forward and backward: the hand-written CUDA kernels
(csrc/flash_attention.cu), their launch counters, their plain torch versions,
the path predicates, the autograd Function and the `flash_attention` /
`flash_attention_grad` op lowerings. The counterpart of the flash half of
paddle_tpu/ops/pallas_kernels.py.

Contract, over (b, h, t, d) tensors: out = softmax(q k^T * sm_scale) v with
causal masking aligned bottom-right (query row i sees keys up to
i + tk - tq, the dense form's tril(k=tk-tq)), computed with an f32 online
softmax; lse = m + log(l) per query row, (b, h, tq) f32. The TPU kernel's
semantics, not the dense softmax's, hold at the edges: a fully masked row
(causal with tq > tk) gives out = 0 and lse = 0, not NaN. p, and in the
backward ds = p * (dp - delta) * sm_scale with delta = rowsum(dO * O), are
rounded to the operand dtype before their products. The backward works from
the saved out and lse; nothing of the forward is stored beside them.

The TPU package has two tiers per direction (VMEM-resident and grid-
streamed) and a dense fallback for ragged shapes. A CUDA kernel streams K/V
tiles through shared memory at every length, so one forward kernel serves
both forward tiers. The backward has two tiers, as in the JAX package: the
fused kernel (five products, one CTA per 128-key tile, per-key-tile dQ
partials summed in a fixed order) where those partials stay within 2x dQ
(`flash_bwd_fused_ok`: at most two key tiles, head width up to 64), and the
dK/dV + dQ pair everywhere else (delta = rowsum(dO * O) once per query
row, then both kernels' five products on the tensor cores); on the card
every shape takes a kernel.
The kernels take any head width d >= 1: up to 128 each is built for a few
padded widths and zero-fills the columns past d as it loads a tile, so the
operands reach it as they are, without a padded copy. Heads of 129 to 512
take the wide forward (two warp groups over a resident query tile, each
forming half of the scores, once per 256-wide column block); wider heads,
and the backward's pair past 128, take 128-wide output column blocks, each
CTA forming the scores over all of d (the reference's blocks span d whole).
The path predicates copied from the JAX package decide only whether a
program declares the `Lse` output (layers.flash_attention, the
fuse_attention pass), so both packages build the same programs; they do not
decide how the CUDA kernels tile.

Dispatch: `flash_forward` / `flash_backward` launch the kernels for tensors
on a CUDA device and raise if they cannot be built or launched; they run
the plain versions for
tensors on the CPU and on the meta device (shape inference). Nothing falls
back silently.
"""

import ctypes

import torch

from . import _build, fused
from .registry import register

__all__ = [
    "FlashAttention",
    "attention_reference",
    "flash_attention",
    "flash_backward",
    "flash_backward_plain",
    "flash_bwd_delta_plain",
    "flash_bwd_fused_ok",
    "flash_forward",
    "flash_forward_plain",
    "flash_path_taken",
    "flash_tiles_ok",
    "kernel_launches",
    "reset_kernel_launches",
]

# ---------------------------------------------------------------------------
# path predicates: copies of the JAX package's (its block targets are the TPU
# kernels' tiling, kept here as data)
# ---------------------------------------------------------------------------

_DEF_BLOCK_Q = 1024
_DEF_BLOCK_K = 1024
_DEF_BLOCK_Q_CAUSAL = 512
_DEF_BLOCK_K_CAUSAL = 512


def _resolve_blocks(block_q, block_k, causal):
    return (
        block_q or (_DEF_BLOCK_Q_CAUSAL if causal else _DEF_BLOCK_Q),
        block_k or (_DEF_BLOCK_K_CAUSAL if causal else _DEF_BLOCK_K),
    )


def flash_tiles_ok(t, block=None):
    """Whether a square t takes the flash path in either direction and mode
    (the tightest block target over causal / non-causal and q / k)."""
    if t <= 0:
        return False
    tightest = min(_DEF_BLOCK_Q, _DEF_BLOCK_K, _DEF_BLOCK_Q_CAUSAL, _DEF_BLOCK_K_CAUSAL)
    return fused._auto_block(t, block or tightest) > 0


def flash_path_taken(tq, tk, causal=False, block_q=None, block_k=None):
    """Whether the JAX package's flash_attention op takes its kernel (and
    so declares the Lse output) at these static lengths."""
    if tq <= 0 or tk <= 0:
        return False
    bq, bk = _resolve_blocks(block_q, block_k, causal)
    return fused._auto_block(tq, bq) > 0 and fused._auto_block(tk, bk) > 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _scores(q, k, causal, sm_scale):
    """f32 scores q k^T * sm_scale, -inf where the causal mask hides a key."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        visible = torch.ones((tq, tk), dtype=torch.bool, device=s.device).tril(tk - tq)
        s = s.masked_fill(~visible, float("-inf"))
    return s


def attention_reference(q, k, v, causal, sm_scale):
    """The dense form: softmax over the f32 scores (causal bottom-right,
    tril(k=tk-tq)), probabilities rounded to q's dtype, then @ v. A fully
    masked row is NaN here, as in the JAX package's dense form."""
    probs = torch.softmax(_scores(q, k, causal, sm_scale), dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def flash_forward_plain(q, k, v, causal, sm_scale):
    """(out, lse) of the flash forward, dense in memory: out in q's dtype,
    lse (b, h, tq) f32; a fully masked row gives out 0 and lse 0."""
    s = _scores(q, k, causal, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    masked_row = m == float("-inf")
    p = torch.exp(s - m.masked_fill(masked_row, 0.0))  # exp(-inf) = 0
    del s
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    out = torch.matmul(p.to(q.dtype).float(), v.float()) / l
    lse = (m + torch.log(l)).masked_fill(masked_row, 0.0)
    return out.to(q.dtype), lse.squeeze(-1)


def flash_bwd_delta_plain(out, dout):
    """delta = rowsum(dO * O) in f32, (b, h, tq): what the pair's delta
    kernel computes once per query row (the JAX package's expression)."""
    return (dout.float() * out.float()).sum(dim=-1)


def flash_backward_plain(q, k, v, out, lse, dout, causal, sm_scale):
    """(dq, dk, dv) of the flash forward from its saved out and lse, each in
    its operand's dtype; delta = rowsum(dO * O) in f32."""
    dt = q.dtype
    p = torch.exp(_scores(q, k, causal, sm_scale) - lse.float().unsqueeze(-1))
    do32 = dout.float()
    delta = flash_bwd_delta_plain(out, dout).unsqueeze(-1)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do32)
    dp = torch.matmul(do32, v.float().transpose(-1, -2))
    ds = (p * (dp - delta) * sm_scale).to(dt).float()
    del p, dp
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dq = torch.matmul(ds, k.float())
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# launches, counted where the wrapper launches each kernel and nowhere else,
# per kernel and per form
_LAUNCHES = {
    "flash_fwd": 0,
    "flash_fwd_causal": 0,
    "flash_bwd_fused": 0,
    "flash_bwd_fused_causal": 0,
    "flash_bwd_delta": 0,
    "flash_bwd_delta_causal": 0,
    "flash_bwd_dkv": 0,
    "flash_bwd_dkv_causal": 0,
    "flash_bwd_dq": 0,
    "flash_bwd_dq_causal": 0,
}


def kernel_launches():
    return dict(_LAUNCHES)


def reset_kernel_launches():
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


_Strides = ctypes.c_int64 * 3


class _Params(ctypes.Structure):
    """Mirror of FlashParams in csrc/flash_attention.cu."""

    _fields_ = [
        ("q", ctypes.c_void_p), ("k", ctypes.c_void_p), ("v", ctypes.c_void_p),
        ("o", ctypes.c_void_p), ("dout", ctypes.c_void_p), ("lse", ctypes.c_void_p),
        ("out", ctypes.c_void_p), ("lse_out", ctypes.c_void_p),
        ("dq", ctypes.c_void_p), ("dk", ctypes.c_void_p), ("dv", ctypes.c_void_p),
        ("sq", _Strides), ("sk", _Strides), ("sv", _Strides), ("so", _Strides),
        ("sdo", _Strides),
        ("b", ctypes.c_int), ("h", ctypes.c_int), ("tq", ctypes.c_int),
        ("tk", ctypes.c_int), ("d", ctypes.c_int), ("causal", ctypes.c_int),
        ("dtype", ctypes.c_int), ("vec", ctypes.c_int), ("scale", ctypes.c_float),
    ]


def _bind(lib):
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    lib.flash_attention_fwd.argtypes = [ctypes.POINTER(_Params), ptr]
    lib.flash_attention_fwd.restype = i32
    lib.flash_attention_bwd.argtypes = [ctypes.POINTER(_Params), ptr, ptr]
    lib.flash_attention_bwd.restype = i32
    lib.flash_attention_bwd_fused.argtypes = [ctypes.POINTER(_Params), ptr, ptr, ptr]
    lib.flash_attention_bwd_fused.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


_build.register("flash_attention", _bind)


def _check(q, k, v):
    """(b, h, tq, tk, d) of operands the kernels take; raises otherwise."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (b, h, t, d), got %s %s %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if tuple(k.shape) != (b, h, tk, d) or tuple(v.shape) != (b, h, tk, d):
        raise ValueError("flash_attention: k %s and v %s do not match q %s"
                         % (tuple(k.shape), tuple(v.shape), tuple(q.shape)))
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must share f32 or bf16, got %s %s %s"
                        % (q.dtype, k.dtype, v.dtype))
    if tq <= 0 or tk <= 0 or b * h <= 0 or d <= 0:
        raise ValueError("flash_attention: empty operands %s, %s" % (tuple(q.shape),
                                                                    tuple(k.shape)))
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError("flash_attention: %s is on %s, q on %s" % (name, t.device, q.device))
    return b, h, tq, tk, d


def _operand(x):
    """x as the kernels read it: any (b, h, t) strides with the d axis
    contiguous. The views the model hands over (a transpose of (b, t, h, d)
    memory) are, and pass without a copy at every head width; a view whose
    d axis is strided is copied into a contiguous tensor."""
    if x.stride(3) == 1 or x.shape[3] == 1:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _rows_aligned(x):
    """Whether every row of x starts on a 4-element boundary, so the kernels
    copy it in 4-element units (16 bytes of f32, 8 of bf16); otherwise they
    load it element by element."""
    return (
        x.shape[3] % 4 == 0
        and all(s % 4 == 0 for s in x.stride()[:3])
        and x.data_ptr() % (4 * x.element_size()) == 0
    )


_STRIDE_FIELDS = {"q": "sq", "k": "sk", "v": "sv", "o": "so", "dout": "sdo"}


def _params(causal, sm_scale, **tensors):
    """FlashParams over the named tensors (q, k, v always; the others per
    direction): their pointers, the (b, h, t) strides of the operands and
    whether all of those load in aligned 4-element units."""
    q, k = tensors["q"], tensors["k"]
    b, h, tq, d = q.shape
    vec = all(_rows_aligned(t) for slot, t in tensors.items() if slot in _STRIDE_FIELDS)
    prm = _Params(
        b=b, h=h, tq=tq, tk=k.shape[2], d=d, causal=int(bool(causal)),
        dtype=_DTYPE_CODE[q.dtype], vec=int(vec), scale=float(sm_scale),
    )
    for slot, t in tensors.items():
        setattr(prm, slot, t.data_ptr())
        if slot in _STRIDE_FIELDS:
            setattr(prm, _STRIDE_FIELDS[slot], _Strides(*t.stride()[:3]))
    return prm


# the fused backward tier: keys a CTA, the cap on its dQ partials (the JAX
# package's: at most two key blocks, so the f32 partials stay within 2x dQ)
# and the padded head width it is built for (any d up to it)
FUSED_BWD_KEYS = 128
FUSED_BWD_MAX_PARTIALS = 2
FUSED_BWD_HEAD_DIM = 64


def flash_bwd_fused_ok(tk, d):
    """Whether the backward at tk keys and head width d takes the fused
    kernel (the rest take the dK/dV + dQ pair)."""
    return 1 <= d <= FUSED_BWD_HEAD_DIM and tk <= FUSED_BWD_KEYS * FUSED_BWD_MAX_PARTIALS


def _launch(fn_name, prm, device, *ptrs):
    lib = _build.load("flash_attention")
    with torch.cuda.device(device):
        err = getattr(lib, fn_name)(ctypes.byref(prm), *ptrs,
                                    torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError("%s kernel launch failed: %s"
                           % (fn_name, lib.flash_attention_error_string(err).decode()))


def flash_forward(q, k, v, causal, sm_scale):
    """(out, lse) of flash attention over (b, h, t, d) operands: out in q's
    dtype, contiguous (b, h, tq, d); lse (b, h, tq) f32. CUDA tensors launch
    the forward kernel; CPU and meta tensors run flash_forward_plain."""
    if q.device.type != "cuda":
        return flash_forward_plain(q, k, v, causal, sm_scale)
    b, h, tq, tk, d = _check(q, k, v)
    q, k, v = _operand(q), _operand(k), _operand(v)
    out = torch.empty((b, h, tq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    _launch("flash_attention_fwd",
            _params(causal, sm_scale, q=q, k=k, v=v, out=out, lse_out=lse), q.device)
    _LAUNCHES["flash_fwd_causal" if causal else "flash_fwd"] += 1
    return out, lse


def flash_backward(q, k, v, out, lse, dout, causal, sm_scale):
    """(dq, dk, dv) of flash attention from the saved out and lse (each in
    its operand's dtype, contiguous). CUDA tensors launch the fused kernel
    where flash_bwd_fused_ok holds (its dQ summed by the last key tile of
    each (b, h)), else the pair: delta once per query row into an f32
    scratch, then the dK/dV and the dQ kernels; CPU and meta tensors run
    flash_backward_plain."""
    if q.device.type != "cuda":
        return flash_backward_plain(q, k, v, out, lse, dout, causal, sm_scale)
    b, h, tq, tk, d = _check(q, k, v)
    for name, t in (("out", out), ("dout", dout)):
        if tuple(t.shape) != (b, h, tq, d) or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("flash_backward: %s is %s %s on %s, q %s %s on %s" % (
                name, tuple(t.shape), t.dtype, t.device, tuple(q.shape), q.dtype, q.device))
    if tuple(lse.shape) != (b, h, tq) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError("flash_backward: lse must be (%d, %d, %d) f32 on %s, got %s %s"
                         % (b, h, tq, q.device, tuple(lse.shape), lse.dtype))
    q, k, v, out, dout = (_operand(t) for t in (q, k, v, out, dout))
    lse = lse.contiguous()
    dq = torch.empty((b, h, tq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, h, tk, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    prm = _params(causal, sm_scale, q=q, k=k, v=v, o=out, dout=dout, lse=lse, dq=dq, dk=dk, dv=dv)
    form = "_causal" if causal else ""
    if flash_bwd_fused_ok(tk, d):
        parts = torch.empty((-(-tk // FUSED_BWD_KEYS), b, h, tq, FUSED_BWD_HEAD_DIM),
                            dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        arrivals = _build.arrival_counters(q.device, stream, b * h)
        _launch("flash_attention_bwd_fused", prm, q.device, parts.data_ptr(),
                arrivals.data_ptr())
        _LAUNCHES["flash_bwd_fused" + form] += 1
        return dq, dk, dv
    delta = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    _launch("flash_attention_bwd", prm, q.device, delta.data_ptr())
    _LAUNCHES["flash_bwd_delta" + form] += 1
    _LAUNCHES["flash_bwd_dq" + form] += 1
    _LAUNCHES["flash_bwd_dkv" + form] += 1
    return dq, dk, dv


# ---------------------------------------------------------------------------
# autograd, and the op lowerings
# ---------------------------------------------------------------------------


class FlashAttention(torch.autograd.Function):
    """flash_attention with its backward from the saved out and lse (the
    JAX package's custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = flash_forward(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout.to(q.dtype), ctx.causal,
                                    ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, sm_scale=None):
    """softmax(q k^T * sm_scale [causal-masked]) v over (b, h, t, d) tensors,
    differentiable; sm_scale None means d ** -0.5."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, bool(causal), float(sm_scale))


def _op_args(ins, attrs):
    (q,) = ins["Q"]
    (k,) = ins["K"]
    (v,) = ins["V"]
    sm_scale = attrs.get("sm_scale")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return q, k, v, bool(attrs.get("causal", False)), float(sm_scale)


@register("flash_attention")
def _flash_attention_op(ctx, ins, attrs):
    """Q/K/V (b, h, t, d) -> Out, and the lse residual for programs that
    declare the Lse output (those where flash_path_taken holds; the others
    drop it)."""
    q, k, v, causal, sm_scale = _op_args(ins, attrs)
    if ctx.autograd:
        # a pipeline stage's forward: differentiated by torch.autograd
        # through FlashAttention (the lse stays inside it)
        return {"Out": [FlashAttention.apply(q, k, v, causal, sm_scale)]}
    out, lse = flash_forward(q, k, v, causal, sm_scale)
    return {"Out": [out], "Lse": [lse]}


@register("flash_attention_grad", no_grad=True)
def _flash_attention_grad_op(ctx, ins, attrs):
    """Q@GRAD, K@GRAD, V@GRAD from the saved Out and Lse. A program without
    Lse (a length flash_path_taken rejects) runs the forward again for the
    lse, then the same backward."""
    q, k, v, causal, sm_scale = _op_args(ins, attrs)
    (dout,) = ins["Out@GRAD"]
    lse = ins.get("Lse", [None])[0]
    if lse is None:
        out, lse = flash_forward(q, k, v, causal, sm_scale)
    else:
        (out,) = ins["Out"]
    dq, dk, dv = flash_backward(q, k, v, out, lse, dout.to(q.dtype), causal, sm_scale)
    return {"Q@GRAD": [dq], "K@GRAD": [dk], "V@GRAD": [dv]}
