"""Graph-level pass framework (reference framework/ir/: ir::Graph + Pass +
PassRegistry + BuildStrategy::Apply), ported from paddle_tpu/passes.

Program → Graph(program) → [Pass, Pass, ...] → Program, with a lossless
round-trip, per-pass invariant verification and telemetry. Executor.run
applies a pipeline at one choke point before a program runs
(executor._apply_pass_pipeline); presets live in manager.PRESETS and are
selected with FLAGS_pass_pipeline. The transpilers' rewrites
(fold_batch_norm, memory_optimize, quantize_training; passes/ports.py) are
registered passes that no preset runs.
"""

from .graph import Graph, GraphVerifyError, OpNode, VarNode, clone_program
from .manager import (
    PRESETS,
    PassManager,
    apply_cached,
    apply_inplace,
    resolve_pipeline,
)
from .pass_base import (
    PASSES,
    Pass,
    PassContext,
    get_pass,
    register_pass,
    registered_passes,
)
from . import builtin, ports, quant  # noqa: F401  (self-registering pass battery)

__all__ = [
    "Graph",
    "GraphVerifyError",
    "OpNode",
    "VarNode",
    "clone_program",
    "Pass",
    "PassContext",
    "PassManager",
    "PASSES",
    "PRESETS",
    "apply_cached",
    "apply_inplace",
    "get_pass",
    "register_pass",
    "registered_passes",
    "resolve_pipeline",
]
