"""Generation serving on torch: GenerationEngine / GenerationScheduler (AOT
prefill buckets + one fixed-shape decode step over a paged KV-cache pool,
token-level continuous batching), the ContinuousBatcher shell they extend,
and the host-side page allocator and prefix cache."""

from . import batcher, generation, kv_cache  # noqa: F401
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
from .kv_cache import PagedKVPool, PoolExhausted, PrefixCache  # noqa: F401

__all__ = [
    "ContinuousBatcher",
    "ServingFuture",
    "QueueFullError",
    "RequestTimeout",
    "ShutdownError",
    "GenerationEngine",
    "GenerationScheduler",
    "GenRequest",
    "GenResult",
    "PagedKVPool",
    "PrefixCache",
    "PoolExhausted",
]
