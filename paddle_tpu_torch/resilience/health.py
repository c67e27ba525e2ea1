"""Process-wide health counters for degraded-but-alive events.

Surviving a fault silently is almost as bad as dying from it: operators need
to see that a run skipped 3 NaN steps and retried 40 RPCs. The storage lives
in the observability metric registry (observability/registry.py) as counters
named "health/<name>", so the same events ride `/metrics`
(registry.to_prometheus) and the flight recorder's bundles
(observability/flightrec.py reads `snapshot()`). A copy of the JAX
package's resilience/health.py.

Well-known counter names:
  nan_steps_skipped   executor NaN/Inf step guard fired
  lr_decays           guard decayed the learning rate / loss scale
  rpc_retries         RPCClient retried a call
  master_retries      MasterClient retried a call
  dist_init_retries   multihost.init_distributed retried the rendezvous
  master_snapshot_corrupt   Master started fresh over a bad snapshot
  ckpt_skipped_invalid      load_latest_valid skipped a torn checkpoint
"""

from ..observability import registry as _registry

__all__ = ["incr", "get", "snapshot", "reset"]

_PREFIX = "health/"


def _reg():
    return _registry.default_registry()


def incr(name, n=1):
    return int(_reg().counter(_PREFIX + name).inc(n))


def get(name):
    m = _reg().get(_PREFIX + name)
    return int(m.value()) if m is not None else 0


def snapshot():
    """{name: count} of every counter incremented since the last reset —
    same contract as the original plain-dict implementation (a counter
    exists only once incr'd, so reset() -> snapshot() == {})."""
    reg = _reg()
    out = {}
    for full in reg.names(_PREFIX):
        m = reg.get(full)
        if m is not None and m.kind == "counter":
            out[full[len(_PREFIX):]] = int(m.value())
    return out


def reset():
    _reg().reset(_PREFIX)
