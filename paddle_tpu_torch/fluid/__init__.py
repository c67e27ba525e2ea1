"""`import paddle_tpu_torch.fluid as fluid`: the fluid surface of the port,
the names of paddle_tpu/fluid/__init__.py that the port has. Names the JAX
package exports from modules not ported yet (AsyncExecutor,
DistributeTranspiler and its config, PyReader's EOFException,
DataFeedDesc, the imperative, contrib, debugger, inference, distributed,
resilience and native modules) are absent until their modules are."""

from .. import *  # noqa: F401,F403
from .. import (  # noqa: F401
    average,
    backward,
    clip,
    dataset,
    embedding,
    evaluator,
    flags,
    framework,
    initializer,
    io,
    layers,
    lod_tensor,
    metrics,
    nets,
    observability,
    optimizer,
    parallel,
    param_attr,
    profiler,
    reader,
    regularizer,
    serving,
    transpiler,
    unique_name,
)
from ..batch import batch  # noqa: F401
from ..data_feeder import DataFeeder  # noqa: F401
from ..executor import Executor, Scope, global_scope, scope_guard  # noqa: F401
from ..flags import get_flags, set_flags  # noqa: F401
from ..lod_tensor import create_lod_tensor, create_random_int_lodtensor  # noqa: F401
from ..parallel_executor import BuildStrategy, ExecutionStrategy, ParallelExecutor  # noqa: F401
from ..transpiler import InferenceTranspiler, memory_optimize, release_memory  # noqa: F401
