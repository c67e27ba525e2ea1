"""Fault-tolerant serving fleet on torch (docs/fleet.md; the JAX package's
fleet/, its names).

A `Router` HTTP front end spreads predict/generate traffic across N replica
ModelServers with active+passive health tracking, per-replica circuit
breakers, deadline-bounded failover retries under the fleet retry budget,
tail-latency hedging for idempotent predicts, graceful drain, and a
staleness gate tied to the online-learning repository (a replica is
routable only once it has landed AND acked the published model version).
`ReplicaProcess` spawns replicas as real subprocesses so SIGKILL chaos
(chip_smoke.py's fleet phase, tests/test_torch_fleet.py) exercises true
process death. A replica serves on the card unless its spec says
"place": "cpu".
"""

from .breaker import CLOSED, HALF_OPEN, OPEN, CircuitBreaker
from .health import Replica
from .replica import ReplicaProcess
from .router import NoReplicaAvailable, RetryBudget, Router, UpstreamError

__all__ = [
    "CircuitBreaker",
    "CLOSED",
    "HALF_OPEN",
    "OPEN",
    "NoReplicaAvailable",
    "Replica",
    "ReplicaProcess",
    "RetryBudget",
    "Router",
    "UpstreamError",
]
