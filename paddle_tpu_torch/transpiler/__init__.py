"""Program -> Program rewrites (reference python/paddle/fluid/transpiler/):
Bf16Transpiler (and Float16Transpiler, its alias), InferenceTranspiler (the
conv + batch_norm fold), memory_optimize / release_memory, and
QuantizeTranspiler (quantization-aware training, freeze, int8). The fold
and memory_optimize are shims over the registered passes of
passes/ports.py, whose quantize_training pass runs QuantizeTranspiler's
training rewrite.

gradient_merge_transpile accumulates k micro-batches' gradients before one
optimizer step. The JAX package's DistributeTranspiler with its pserver
dispatchers comes with the parameter server (ROADMAP A6b item 4).
"""

from .bf16_transpiler import Bf16Transpiler, Float16Transpiler  # noqa: F401
from .gradient_merge import gradient_merge_transpile  # noqa: F401
from .inference_transpiler import InferenceTranspiler  # noqa: F401
from .memory_optimization_transpiler import memory_optimize, release_memory  # noqa: F401
from .quantize_transpiler import QuantizeTranspiler  # noqa: F401

__all__ = ["Bf16Transpiler", "Float16Transpiler", "InferenceTranspiler", "QuantizeTranspiler",
           "gradient_merge_transpile", "memory_optimize", "release_memory"]
