"""Whole-program static analysis (the torch counterpart of
paddle_tpu/analysis/): `analyze_program` (dataflow.py), the forward
abstract interpretation the calibrate pass reads its per-var facts from.
The fluidlint checkers and the FLAGS_static_verify gate are not ported
yet."""

from .dataflow import Analysis, OpRecord, SymDim, VarFact, analyze_program

__all__ = ["Analysis", "OpRecord", "SymDim", "VarFact", "analyze_program"]
