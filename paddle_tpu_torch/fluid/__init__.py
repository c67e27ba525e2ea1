"""`import paddle_tpu_torch.fluid as fluid`: the fluid surface of the port,
the names of paddle_tpu/fluid/__init__.py that the port has. Names the JAX
package exports from modules not ported yet (the imperative, debugger and
inference modules) are absent until their modules are."""

from .. import *  # noqa: F401,F403
from .. import (  # noqa: F401
    async_executor,
    average,
    backward,
    clip,
    contrib,
    data_feed_desc,
    dataset,
    distributed,
    embedding,
    evaluator,
    flags,
    framework,
    initializer,
    io,
    layers,
    lod_tensor,
    metrics,
    native,
    nets,
    observability,
    optimizer,
    parallel,
    param_attr,
    profiler,
    py_reader,
    reader,
    regularizer,
    resilience,
    serving,
    transpiler,
    unique_name,
)
from ..async_executor import AsyncExecutor  # noqa: F401
from ..batch import batch  # noqa: F401
from ..data_feed_desc import DataFeedDesc  # noqa: F401
from ..data_feeder import DataFeeder  # noqa: F401
from ..executor import Executor, Scope, global_scope, scope_guard  # noqa: F401
from ..flags import get_flags, set_flags  # noqa: F401
from ..lod_tensor import create_lod_tensor, create_random_int_lodtensor  # noqa: F401
from ..place import CUDAPinnedPlace  # noqa: F401
from ..py_reader import EOFException  # noqa: F401
from ..parallel_executor import BuildStrategy, ExecutionStrategy, ParallelExecutor  # noqa: F401
from ..transpiler import (  # noqa: F401
    DistributeTranspiler,
    DistributeTranspilerConfig,
    InferenceTranspiler,
    memory_optimize,
    release_memory,
)
