"""Resilience on torch: the two modules serving needs.

- faults: deterministic, seeded fault injection (PADDLE_TPU_FAULTS env or
  faults.install), the JAX package's spec syntax; the HTTP ModelServer
  consults replica_kill, conn_reset and slow_response on every POST.
- health: process-wide counters for degraded-but-alive events, read by the
  flight recorder (observability/flightrec.py).

The checkpoint, elastic, retry and async-checkpoint modules of the JAX
package's resilience/ are still to come (ROADMAP A7).
"""

from . import faults, health  # noqa: F401
from .faults import FaultPlan, InjectedFault  # noqa: F401

__all__ = ["FaultPlan", "InjectedFault", "faults", "health"]
