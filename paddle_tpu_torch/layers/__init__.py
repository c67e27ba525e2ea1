"""Layer functions that build Programs (paddle_tpu/layers), re-exported
flat so that `fluid.layers.fc(...)` works unchanged: the GPTDecoder, the
Transformer, the CNN training programs, the sequence, control-flow,
loss and learning-rate layers of the recurrent models, the detection
layers (`Print` among the control-flow ones), and the data layer's feed
variables and program readers (`data`, `py_reader`, `read_file`)."""

from . import (  # noqa: F401
    control_flow,
    detection,
    io,
    learning_rate_scheduler,
    loss,
    math_op_patch,
    metric_op,
    nn,
    ops,
    sequence,
    tensor,
)
from .control_flow import *  # noqa: F401,F403
from .detection import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .metric_op import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
