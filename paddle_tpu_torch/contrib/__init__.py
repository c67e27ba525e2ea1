"""Contrib tier (reference python/paddle/fluid/contrib/): the CTR reader
(contrib.reader), the memory-usage estimator (memory_usage_calc), the
op-frequency statistics (op_frequence), the beam-search decoder helpers
(contrib.decoder), and the quantize transpiler, which graduated into
transpiler/ and is re-exported here so `fluid.contrib.*` call sites keep
working."""

from ..transpiler.quantize_transpiler import QuantizeTranspiler  # noqa: F401
from . import decoder, memory_usage_calc, op_frequence, reader  # noqa: F401
from .memory_usage_calc import memory_usage  # noqa: F401
from .op_frequence import op_freq_statistic  # noqa: F401

__all__ = ["QuantizeTranspiler", "memory_usage", "memory_usage_calc", "decoder", "reader",
           "op_freq_statistic"]
