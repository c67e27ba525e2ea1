"""Imperative (eager) mode: define-by-run on torch tensors with a gradient
tape (the torch counterpart of paddle_tpu/imperative/).

Reference analog: python/paddle/fluid/imperative/ (layers.py PyLayer base)
+ paddle/fluid/imperative/tracer.{h,cc}: ops execute immediately while a
tracer records a tape that backward() replays.

Eager values are torch tensors on the guard's device (the card unless
`guard(CPUPlace())`), so executing an op is one torch call. A Layer's
forward is any torch-composed function; its __call__ is traced as ONE tape
node, differentiated through torch autograd, and `layer.jit()` compiles the
body with torch.compile (inductor's Triton kernels on the card) without a
change to user code.
"""

from . import nn  # noqa: F401
from .base import Tape, Variable, enabled, guard, to_variable  # noqa: F401
from .layers import Layer, PyLayer  # noqa: F401
from .parallel import (  # noqa: F401
    DataParallel,
    Env,
    ParallelEnv,
    prepare_context,
)

__all__ = [
    "guard", "enabled", "to_variable", "Variable", "Layer", "PyLayer", "Tape",
    "nn", "ParallelEnv", "Env", "DataParallel", "prepare_context",
]
