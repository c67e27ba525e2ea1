"""Quantization ops (the torch counterparts of paddle_tpu/ops/quant_ops.py).

- fake_quantize_abs_max, fake_quantize_range_abs_max and
  fake_dequantize_max_abs: quantization simulated in float for
  quantization-aware training, with identity (straight-through) grads, as
  in the reference's QuantizeTranspiler;
- quantize_abs_max, quantize_static and int8_mul: the calibrated int8
  serving tier that passes/quant.py emits. quantize_static makes int8
  levels from a frozen scale; int8_mul multiplies int8 levels and emits the
  exact integer level-products as f32.

- int8_conv2d: conv2d over int8 levels (QuantizeTranspiler.convert_to_int8
  swaps conv2d and depthwise_conv2d over quantized operands to it), the
  exact integer sums emitted as f32.

int8_mul multiplies as float64 (torch.matmul takes no integer tensors on
CUDA, and an f32 sum is inexact past 2^24, while |sum| <= k * 127^2 here):
the float64 sums are exact integers, rounded once to f32, which is the JAX
package's i32 -> f32. The fused gemm_int8 family (ops/fused.py) runs the
same chains through the quant GEMM kernel instead.

int8_conv2d on the CPU (and on meta tensors) is the same: a float64
conv2d of the levels, rounded once to f32. On the card a convolution with
groups == 1 is an int8 im2col (its columns zero-padded to a multiple of 16,
which keeps every sum exact) through the hand-written quant GEMM
(quant_gemm.quant_gemm_bias_act at scale 1.0, no bias, no activation:
__int2float_rn of the i32 sums, the same f32 bits); a build or launch
failure raises. A grouped one (a converted depthwise_conv2d) takes the
float64 cuDNN convolution, exact as well: the kernel takes one product per
call, and a grouped convolution is many small ones. That is a coverage
rule (`int8_conv2d_path_taken`), not a fallback; ops.fused.stats() counts
the calls of each rule under the dispatches "int8_conv2d" and
"int8_conv2d_grouped".
"""

import torch
import torch.nn.functional as F

from . import quant_gemm
from .registry import prod, register

__all__ = []


def _identity_grad(slot_in="X", slot_out="Out"):
    def maker(op, block, grad_map):
        return [
            {
                "type": "assign",
                "inputs": {"X": [grad_map[op.output(slot_out)[0]]]},
                "outputs": {"Out": [grad_map[op.input(slot_in)[0]]]},
                "attrs": {},
            }
        ]

    return maker


def _quant_levels(bit_length):
    return float((1 << (int(bit_length) - 1)) - 1)


def _nonzero(scale):
    """scale, with 0 replaced by 1 (no division by zero)."""
    return torch.where(scale == 0, torch.ones_like(scale), scale)


@register("fake_quantize_abs_max", grad=_identity_grad())
def _fake_quantize_abs_max(ctx, ins, attrs):
    """Out = round(X / scale * s) where scale = max|X|, s = 2^(bits-1)-1."""
    (x,) = ins["X"]
    s = _quant_levels(attrs.get("bit_length", 8))
    scale = _nonzero(x.abs().amax())
    return {"Out": [torch.round(x / scale * s)], "OutScale": [scale]}


@register("fake_quantize_range_abs_max", grad=_identity_grad())
def _fake_quantize_range_abs_max(ctx, ins, attrs):
    """Training: scale = max(|X|, 0.9 * running scale); inference: scale =
    InScale. Out is clamped to +-s."""
    (x,) = ins["X"]
    s = _quant_levels(attrs.get("bit_length", 8))
    in_scale = ins["InScale"][0] if ins.get("InScale") else None
    if attrs.get("is_test", False) and in_scale is not None:
        scale = in_scale.reshape(())
    else:
        cur = x.abs().amax()
        scale = cur if in_scale is None else torch.maximum(cur, 0.9 * in_scale.reshape(()))
    scale = _nonzero(scale)
    out = torch.clamp(torch.round(x / scale * s), -s, s)
    return {"Out": [out], "OutScale": [scale.reshape(1)]}


@register("fake_dequantize_max_abs", grad=_identity_grad())
def _fake_dequantize_max_abs(ctx, ins, attrs):
    """Out = X * (scale / max_range)."""
    (x,) = ins["X"]
    (scale,) = ins["Scale"]
    max_range = float(attrs.get("max_range", 127.0))
    return {"Out": [x * (scale.reshape(()) / max_range)]}


@register("quantize_abs_max", no_grad=True)
def _quantize_abs_max(ctx, ins, attrs):
    """Serving-time activation quantization: int8 levels and the scale."""
    (x,) = ins["X"]
    s = _quant_levels(attrs.get("bit_length", 8))
    scale = _nonzero(x.abs().amax())
    q = torch.clamp(torch.round(x / scale * s), -s, s).to(torch.int8)
    return {"Out": [q], "OutScale": [scale.reshape(1)]}


@register("quantize_static", no_grad=True)
def _quantize_static(ctx, ins, attrs):
    """Calibrated activation quantization: int8 levels from a FROZEN scale
    (a persistable const the calibrate pass baked); no reduction on the hot
    path. Out-of-range values saturate at +-levels."""
    (x,) = ins["X"]
    (scale,) = ins["Scale"]
    s = _quant_levels(attrs.get("bit_length", 8))
    sc = _nonzero(scale.reshape(()))
    return {"Out": [torch.clamp(torch.round(x / sc * s), -s, s).to(torch.int8)]}


@register("int8_mul", no_grad=True)
def _int8_mul(ctx, ins, attrs):
    """mul over int8 levels, emitted as f32 level-products (the flatten
    semantics of the mul op)."""
    (x,) = ins["X"]
    (y,) = ins["Y"]
    xnc = int(attrs.get("x_num_col_dims", 1))
    ync = int(attrs.get("y_num_col_dims", 1))
    x2 = x.reshape(prod(x.shape[:xnc]), -1)
    y2 = y.reshape(prod(y.shape[:ync]), -1)
    out = torch.matmul(x2.double(), y2.double()).float()
    return {"Out": [out.reshape(tuple(x.shape[:xnc]) + tuple(y.shape[ync:]))]}


def int8_conv2d_path_taken(groups):
    """Whether an int8_conv2d takes the quant GEMM kernel on the card (one
    int8 im2col product): groups == 1."""
    return int(groups) == 1


def _conv_attrs(attrs):
    return ([int(s) for s in attrs.get("strides", [1, 1])],
            [int(p) for p in attrs.get("paddings", [0, 0])],
            [int(d) for d in attrs.get("dilations", [1, 1])],
            int(attrs.get("groups", 1) or 1))


def _int8_im2col(x, kh, kw, strides, paddings, dilations, k_pad):
    """(N * Ho * Wo, k_pad) int8 columns of an NCHW int8 input, each row one
    output position's window in (C, kh, kw) order, zero past C * kh * kw;
    with (Ho, Wo). One strided copy out of the zero-padded input."""
    n, c, h, w = x.shape
    (sh, sw), (ph, pw), (dh, dw) = strides, paddings, dilations
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    xp = F.pad(x, [pw, pw, ph, ph]) if ph or pw else x.contiguous()
    hp, wp = xp.shape[2:]
    win = xp.as_strided((n, ho, wo, c, kh, kw),
                        (c * hp * wp, sh * wp, sw, hp * wp, dh * wp, dw))
    k = c * kh * kw
    cols = torch.empty((n * ho * wo, k_pad), dtype=torch.int8, device=x.device)
    if k_pad > k:
        cols[:, k:].zero_()
    cols[:, :k].view(n, ho, wo, c, kh, kw).copy_(win)
    return cols, ho, wo


def _int8_conv2d_gemm(x, w, strides, paddings, dilations):
    """The card's groups == 1 form: im2col, the quant GEMM kernel, NCHW."""
    o, c, kh, kw = w.shape
    k = c * kh * kw
    k_pad, n_pad = quant_gemm._round16(k), quant_gemm._round16(o)
    cols, ho, wo = _int8_im2col(x, kh, kw, strides, paddings, dilations, k_pad)
    w2 = torch.zeros((k_pad, n_pad), dtype=torch.int8, device=w.device)
    w2[:k, :o] = w.reshape(o, k).t()
    one = torch.ones((), dtype=torch.float32, device=x.device)
    z, _ = quant_gemm.quant_gemm_bias_act(cols, w2, one)
    z = z[:, :o] if n_pad > o else z
    return z.reshape(x.shape[0], ho, wo, o).permute(0, 3, 1, 2).contiguous()


@register("int8_conv2d", no_grad=True)
def _int8_conv2d(ctx, ins, attrs):
    """conv2d over int8 levels (NCHW input, OIHW filter, symmetric
    paddings), the exact integer sums as f32 (see the module docstring for
    the forms)."""
    from .fused import note_dispatch

    (x,) = ins["Input"]
    (w,) = ins["Filter"]
    strides, paddings, dilations, groups = _conv_attrs(attrs)
    if x.device.type == "meta":
        return {"Output": [F.conv2d(x.float(), w.float(), None, strides, paddings, dilations,
                                    groups)]}
    taken = int8_conv2d_path_taken(groups)
    note_dispatch("int8_conv2d" if taken else "int8_conv2d_grouped")
    if x.device.type == "cuda" and taken:
        return {"Output": [_int8_conv2d_gemm(x, w, strides, paddings, dilations)]}
    out = F.conv2d(x.double(), w.double(), None, strides, paddings, dilations, groups)
    return {"Output": [out.float()]}
