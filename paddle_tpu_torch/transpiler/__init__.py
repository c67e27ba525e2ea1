"""Program -> Program rewrites (reference python/paddle/fluid/transpiler/):
Bf16Transpiler, and Float16Transpiler, its alias.

The JAX package's other transpilers (DistributeTranspiler and its pserver
dispatchers, gradient_merge, memory_optimize, InferenceTranspiler,
QuantizeTranspiler) rewrite programs for the mesh and the distributed
runtime, and come with the parallel and distributed layers.
"""

from .bf16_transpiler import Bf16Transpiler, Float16Transpiler  # noqa: F401

__all__ = ["Bf16Transpiler", "Float16Transpiler"]
