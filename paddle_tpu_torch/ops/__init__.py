"""Operator lowerings; importing this package registers them: the core
ops, the sequence, control-flow, decode and loss ops, the flash attention
ops (ops/flash_attention.py), the quantization ops (ops/quant_ops.py), and
the fused lowerings of the kernel-substitution tier (ops/fused.py)."""

from . import (  # noqa: F401
    control_flow_ops,
    core_ops,
    decode_ops,
    flash_attention,
    fused,
    generation_ops,
    loss_ops,
    quant_ops,
    sequence_ops,
)
from .registry import OPS, get, is_registered, register  # noqa: F401
