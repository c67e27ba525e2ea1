"""Quantization ops (the torch counterparts of paddle_tpu/ops/quant_ops.py).

- fake_quantize_abs_max, fake_quantize_range_abs_max and
  fake_dequantize_max_abs: quantization simulated in float for
  quantization-aware training, with identity (straight-through) grads, as
  in the reference's QuantizeTranspiler;
- quantize_abs_max, quantize_static and int8_mul: the calibrated int8
  serving tier that passes/quant.py emits. quantize_static makes int8
  levels from a frozen scale; int8_mul multiplies int8 levels and emits the
  exact integer level-products as f32.

int8_mul multiplies as float64 (torch.matmul takes no integer tensors on
CUDA, and an f32 sum is inexact past 2^24, while |sum| <= k * 127^2 here):
the float64 sums are exact integers, rounded once to f32, which is the JAX
package's i32 -> f32. The fused gemm_int8 family (ops/fused.py) runs the
same chains through the quant GEMM kernel instead. int8_conv2d waits for
conv2d.
"""

import torch

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
