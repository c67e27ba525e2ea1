"""Fault-tolerant training runtime on torch (the JAX package's resilience/,
with its names):

- faults:     deterministic, seeded fault injection (PADDLE_TPU_FAULTS env
              or faults.install) with hook points in rpc / master / io /
              executor / the serving front end.
- retry:      one RetryPolicy (bounded attempts, exponential backoff and
              jitter, an overall deadline, typed retryable-vs-fatal errors)
              shared by RPCClient, MasterClient, the data runtime and
              multihost init.
- checkpoint: manifest-based crash-safe checkpoints (per-file checksums, an
              atomic MANIFEST.json committed last, keep-last-N GC,
              load_latest_valid skips torn checkpoints) and resume_or_init.
- health:     process-wide counters for degraded-but-alive events (skipped
              NaN steps, rpc retries, requeued tasks).
- async_ckpt: the elastic checkpoint format (per-host row-range shards,
              neighbour replicas, a rank-0 manifest committed after a
              cross-host barrier); AsyncCheckpointer stalls the step only
              for the device-to-host copy into pinned buffers it reuses.
- elastic:    Supervisor (step-deadline watchdog, NaN-storm rollback with a
              bounded budget, SIGTERM / preempt drain) and the
              topology-aware resume_or_init.

The executor's NaN step guard (FLAGS_resilience_nan_guard) and its
`nan_grad` fault live in executor.py. Every file these modules write is the
JAX package's, so either package resumes from the other's checkpoints.
"""

from . import async_ckpt, checkpoint, elastic, faults, health, retry  # noqa: F401
from .async_ckpt import AsyncCheckpointer  # noqa: F401
from .checkpoint import (  # noqa: F401
    load_latest_valid,
    resume_or_init,
    save_checkpoint,
    snapshot_persistables,
)
from .elastic import Preempted, Supervisor  # noqa: F401
from .faults import FaultPlan, InjectedFault  # noqa: F401
from .retry import DeadlineExceeded, FatalError, RetryPolicy  # noqa: F401

__all__ = [
    "FaultPlan",
    "InjectedFault",
    "RetryPolicy",
    "DeadlineExceeded",
    "FatalError",
    "AsyncCheckpointer",
    "Supervisor",
    "Preempted",
    "save_checkpoint",
    "load_latest_valid",
    "resume_or_init",
    "snapshot_persistables",
    "faults",
    "retry",
    "checkpoint",
    "health",
    "async_ckpt",
    "elastic",
]
