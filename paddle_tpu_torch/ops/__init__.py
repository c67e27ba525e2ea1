"""Operator lowerings; importing this package registers them, and the fused
lowerings of the kernel-substitution tier (ops/fused.py)."""

from . import core_ops, fused, generation_ops  # noqa: F401
from .registry import OPS, get, is_registered, register  # noqa: F401
