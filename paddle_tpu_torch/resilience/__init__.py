"""Resilience on torch: the modules serving and the data layer need.

- faults: deterministic, seeded fault injection (PADDLE_TPU_FAULTS env or
  faults.install), the JAX package's spec syntax; the HTTP ModelServer
  consults replica_kill, conn_reset and slow_response on every POST.
- health: process-wide counters for degraded-but-alive events, read by the
  flight recorder (observability/flightrec.py).
- retry: the unified retry policy (bounded attempts, jittered backoff, a
  deadline); the data runtime respawns its decode workers under it. Its
  names are not re-exported here yet: they come with the rest of the JAX
  package's resilience/ names.

The checkpoint, elastic and async-checkpoint modules of the JAX package's
resilience/ are still to come (ROADMAP A item 2).
"""

from . import faults, health, retry  # noqa: F401
from .faults import FaultPlan, InjectedFault  # noqa: F401

__all__ = ["FaultPlan", "InjectedFault", "faults", "health", "retry"]
