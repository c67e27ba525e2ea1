"""Deterministic dataset sharding for the native data runtime.

Reference analog: the AsyncExecutor sharded its filelist across parser
threads (async_executor.cc hands each executor_thread_worker a slice of the
file list), and the distributed fluid reader idiom was
``reader = shard(reader, trainer_num, trainer_id)``. Here the same two
levels exist as pure, testable functions:

- HOST level: ``host_shards(order, num_hosts, host_id)`` — every host of a
  multihost run owns a disjoint strided slice of the epoch's shard order,
  so input work is never duplicated across hosts (each sample is decoded by
  exactly one host per epoch).
- WORKER level: within a host, workers pull shards dynamically from a
  shared queue whose order IS the host slice (load balancing without
  losing determinism of the set); ``worker_shards`` gives the static
  sub-assignment used when a fixed mapping is required (tests, skip-replay
  accounting).

The epoch order itself is a seeded permutation: same (seed, epoch) -> same
order on every host, different epochs -> different order. All functions are
pure so the (num_hosts, num_workers) grid properties — disjointness, full
coverage, determinism — are directly unit-testable.
"""

import numpy as np

__all__ = ["epoch_shard_order", "host_shards", "worker_shards"]


def epoch_shard_order(num_shards, seed=0, epoch=0, shuffle=True):
    """Deterministic shard visit order for one epoch: a permutation of
    range(num_shards) seeded by (seed, epoch). Identical on every host —
    the per-host slice is taken AFTER the shuffle, so reshuffling between
    epochs never breaks host disjointness."""
    if num_shards < 0:
        raise ValueError("num_shards must be >= 0, got %r" % (num_shards,))
    ids = np.arange(num_shards, dtype=np.int64)
    if shuffle and num_shards > 1:
        # mix epoch into the seed with a large odd multiplier so (seed=1,
        # epoch=0) and (seed=0, epoch=1) don't collide
        rng = np.random.RandomState((int(seed) * 1000003 + int(epoch)) % (2**32))
        ids = rng.permutation(ids)
    return [int(i) for i in ids]


def _check_part(num, idx, what):
    if num < 1:
        raise ValueError("num_%ss must be >= 1, got %r" % (what, num))
    if not (0 <= idx < num):
        raise ValueError(
            "%s_id %r out of range for num_%ss=%r" % (what, idx, what, num)
        )


def host_shards(order, num_hosts, host_id):
    """This host's strided slice of the epoch order. Disjoint and covering
    across host_id in range(num_hosts); |slice| differs by at most 1."""
    _check_part(num_hosts, host_id, "host")
    return list(order[host_id::num_hosts])


def worker_shards(order, num_workers, worker_id):
    """Static per-worker sub-shard of a host's shard list (strided). The
    runtime's pool assigns shards dynamically from a queue in this same
    list order; this function is the static equivalent for deterministic
    replay and for the grid tests."""
    _check_part(num_workers, worker_id, "worker")
    return list(order[worker_id::num_workers])
