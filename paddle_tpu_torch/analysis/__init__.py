"""Whole-program static analysis and the fluidlint checker suite (the torch
counterpart of paddle_tpu/analysis/):

- `analyze_program` (dataflow.py): forward abstract interpretation over the
  Graph IR (shape with symbolic dynamic dims, dtype, LoD; lowerings run on
  meta tensors; control-flow sub-blocks walked in line) plus backward
  liveness;
- `lint_program` / `CHECKERS` (checkers.py): the eight fluidlint checkers
  (donation-alias, sharding-rules, dtype-boundary, determinism, dead-write,
  write-never-read, fetch-unwritten, cf-capture), findings equal to the
  JAX package's on one program;
- `static_verify` / `maybe_static_verify` / `verify_graph` (verify.py): the
  FLAGS_static_verify gate Executor.run, aot_serve_lowering, the serving
  engines and the PassManager call.

Sharding layouts (a mesh) come with ROADMAP A6.
"""

from .checkers import (
    CHECKERS,
    STRUCTURAL_CHECKS,
    Finding,
    lint_program,
    register_checker,
    render_findings,
    run_checkers,
)
from .dataflow import Analysis, OpRecord, SymDim, VarFact, analyze_program
from .verify import (
    StaticVerifyError,
    maybe_static_verify,
    static_verify,
    verify_graph,
)

__all__ = [
    "Analysis",
    "CHECKERS",
    "Finding",
    "OpRecord",
    "STRUCTURAL_CHECKS",
    "StaticVerifyError",
    "SymDim",
    "VarFact",
    "analyze_program",
    "lint_program",
    "maybe_static_verify",
    "register_checker",
    "render_findings",
    "run_checkers",
    "static_verify",
    "verify_graph",
]
