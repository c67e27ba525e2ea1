"""Operator lowerings; importing this package registers them, the flash
attention ops (ops/flash_attention.py), the quantization ops
(ops/quant_ops.py), and the fused lowerings of the kernel-substitution tier
(ops/fused.py)."""

from . import core_ops, flash_attention, fused, generation_ops, quant_ops  # noqa: F401
from .registry import OPS, get, is_registered, register  # noqa: F401
