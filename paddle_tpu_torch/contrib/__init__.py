"""Contrib tier (reference python/paddle/fluid/contrib/): the CTR reader
(contrib.reader), and the quantize transpiler, which graduated into
transpiler/ and is re-exported here so `fluid.contrib.*` call sites keep
working. The beam-search decoder helpers, memory_usage_calc and
op_frequence of the JAX package's contrib/ are still to come (ROADMAP A
item 6)."""

from ..transpiler.quantize_transpiler import QuantizeTranspiler  # noqa: F401
from . import reader  # noqa: F401

__all__ = ["QuantizeTranspiler", "reader"]
