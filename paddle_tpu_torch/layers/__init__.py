"""Layer functions that build Programs (paddle_tpu/layers): the slice the
GPTDecoder, the Transformer and the CNN training programs use, re-exported
flat so that `fluid.layers.fc(...)` works unchanged."""

from . import io, math_op_patch, metric_op, nn, ops, tensor  # noqa: F401
from .io import *  # noqa: F401,F403
from .metric_op import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
