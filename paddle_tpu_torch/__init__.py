"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu, slice by slice.

This slice serves generation: the fluid-style front end (framework, layers)
builds the GPTDecoder's Programs, the executor runs their ops as torch calls
on one device, and the GenerationEngine/GenerationScheduler serve requests
over a paged KV pool read by a hand-written CUDA paged flash-attention
kernel (ops/paged_flash.py). Entry points run on the card (CUDAPlace(0))
unless the caller passes CPUPlace().

The package imports torch and never jax, and nothing of paddle_tpu.
"""

from . import flags, framework, layers, ops, unique_name  # noqa: F401
from .executor import Executor, Scope, global_scope, scope_guard  # noqa: F401
from .framework import Program, default_main_program, default_startup_program, program_guard  # noqa: F401
from .param_attr import ParamAttr  # noqa: F401
from .place import CPUPlace, CUDAPlace  # noqa: F401
