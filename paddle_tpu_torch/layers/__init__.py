"""Layer functions that build Programs (the slice of paddle_tpu/layers that
the generation path uses)."""

from . import io, math_op_patch, nn, ops, tensor  # noqa: F401
from .io import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
