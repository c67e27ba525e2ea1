"""Serving on torch: GenerationEngine / GenerationScheduler (prefill
buckets + one fixed-shape decode step over a paged KV-cache pool of f32 or
int8 rows, token-level continuous batching), the ContinuousBatcher shell
they extend, the host-side page allocator and prefix cache, the
ServingEngine (batch-bucketed forward serving of a saved model, native or
calibrated int8, on CUDA graphs on the card, with parameter hot swap), the
persistent CompileCache both engines load prepared variants from, and the
ModelServer (stdlib multi-model HTTP front end: `:predict`, `:generate`,
`/healthz`, `/v1/models`, `/metrics`)."""

from . import batcher, compile_cache, engine, generation, kv_cache, server  # noqa: F401
from .batcher import (  # noqa: F401
    ContinuousBatcher,
    QueueFullError,
    RequestTimeout,
    ServingFuture,
    ShutdownError,
)
from .generation import (  # noqa: F401
    GenerationEngine,
    GenerationScheduler,
    GenRequest,
    GenResult,
)
from .compile_cache import CompileCache  # noqa: F401
from .engine import DEFAULT_BATCH_BUCKETS, ServingEngine  # noqa: F401
from .kv_cache import PagedKVPool, PoolExhausted, PrefixCache  # noqa: F401
from .server import ModelServer  # noqa: F401

__all__ = [
    "ContinuousBatcher",
    "ServingFuture",
    "QueueFullError",
    "RequestTimeout",
    "ShutdownError",
    "DEFAULT_BATCH_BUCKETS",
    "ServingEngine",
    "CompileCache",
    "ModelServer",
    "GenerationEngine",
    "GenerationScheduler",
    "GenRequest",
    "GenResult",
    "PagedKVPool",
    "PrefixCache",
    "PoolExhausted",
]
