"""Operator lowerings; importing this package registers them."""

from . import core_ops, generation_ops  # noqa: F401
from .registry import OPS, get, is_registered, register  # noqa: F401
