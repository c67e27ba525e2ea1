"""Program -> Program rewrites (reference python/paddle/fluid/transpiler/):
DistributeTranspiler (pserver and collective modes) with its PS
dispatchers, Bf16Transpiler (and Float16Transpiler, its alias),
InferenceTranspiler (the conv + batch_norm fold), memory_optimize /
release_memory, and QuantizeTranspiler (quantization-aware training,
freeze, int8). The fold and memory_optimize are shims over the registered
passes of passes/ports.py, whose quantize_training pass runs
QuantizeTranspiler's training rewrite. gradient_merge_transpile accumulates
k micro-batches' gradients before one optimizer step.
"""

from .bf16_transpiler import Bf16Transpiler, Float16Transpiler  # noqa: F401
from .distribute_transpiler import (  # noqa: F401
    DistributeTranspiler,
    DistributeTranspilerConfig,
)
from .gradient_merge import gradient_merge_transpile  # noqa: F401
from .inference_transpiler import InferenceTranspiler  # noqa: F401
from .memory_optimization_transpiler import memory_optimize, release_memory  # noqa: F401
from .ps_dispatcher import HashName, PSDispatcher, RoundRobin  # noqa: F401
from .quantize_transpiler import QuantizeTranspiler  # noqa: F401

__all__ = ["Bf16Transpiler", "DistributeTranspiler", "DistributeTranspilerConfig",
           "Float16Transpiler", "HashName", "InferenceTranspiler", "PSDispatcher",
           "QuantizeTranspiler", "RoundRobin", "gradient_merge_transpile", "memory_optimize",
           "release_memory"]
