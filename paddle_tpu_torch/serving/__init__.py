"""Serving on torch: GenerationEngine / GenerationScheduler (prefill
buckets + one fixed-shape decode step over a paged KV-cache pool of f32 or
int8 rows, token-level continuous batching), the ContinuousBatcher shell
they extend, the host-side page allocator and prefix cache, and the
ServingEngine (batch-bucketed forward serving of a saved model, native or
calibrated int8)."""

from . import batcher, engine, generation, kv_cache  # noqa: F401
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
from .engine import DEFAULT_BATCH_BUCKETS, ServingEngine  # noqa: F401
from .kv_cache import PagedKVPool, PoolExhausted, PrefixCache  # noqa: F401

__all__ = [
    "ContinuousBatcher",
    "ServingFuture",
    "QueueFullError",
    "RequestTimeout",
    "ShutdownError",
    "DEFAULT_BATCH_BUCKETS",
    "ServingEngine",
    "GenerationEngine",
    "GenerationScheduler",
    "GenRequest",
    "GenResult",
    "PagedKVPool",
    "PrefixCache",
    "PoolExhausted",
]
