"""The port's native data runtime (paddle_tpu_torch/data/) on the CPU: the
cases of tests/test_data_runtime.py — the shared-memory ring's wraparound,
torn reads, overflow and reclaim, shard cover across hosts and workers,
exact epochs, a SIGKILLed worker losing and duplicating nothing, the
restart budget, the PyReader num_workers forms — with worker processes
forked from the test, and the set of (shard, batch) deliveries held against
the JAX package's DataRuntime for the same seed. Every wait on the workers
is bounded here (_within), since a hang must fail the test, not the run.
"""

import collections
import functools
import os
import signal
import threading
import time

import numpy as np
import pytest

from paddle_tpu_torch.data import (
    DataRuntime as _DataRuntime,
    RingBuffer,
    SlabOverflowError,
    TornSlotError,
    epoch_shard_order,
    host_shards,
    worker_shards,
)
from paddle_tpu_torch.place import CPUPlace
from paddle_tpu_torch.py_reader import EOFException, PyReader as _PyReader

BS = 4
BATCHES_PER_SHARD = 3
WAIT_S = 60  # the longest any case may wait on its workers


def DataRuntime(*a, **kw):
    kw.setdefault("place", CPUPlace())
    return _DataRuntime(*a, **kw)


def PyReader(*a, **kw):
    kw.setdefault("place", CPUPlace())
    return _PyReader(*a, **kw)


def _within(fn, seconds=WAIT_S):
    """fn() run on a thread, failing the test if it has not returned (or
    raised) after `seconds`."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: B036 — re-raised below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        pytest.fail("no result from the data runtime within %d s" % seconds)
    if "err" in box:
        raise box["err"]
    return box.get("out")


# ---- module-level decode fns (picklable; deterministic per shard) ----

def _decode(shard_id, batches=BATCHES_PER_SHARD, delay=0.0):
    for b in range(batches):
        if delay:
            time.sleep(delay)
        yield {
            "ids": (np.arange(BS) + shard_id * 1000 + b * 10).astype(np.int64),
            "x": np.full((BS, 3), shard_id, np.float32),
        }


def _expected_ids(shards, batches=BATCHES_PER_SHARD):
    out = []
    for s in shards:
        for b in range(batches):
            out.extend(int(v) for v in np.arange(BS) + s * 1000 + b * 10)
    return sorted(out)


def _drain_ids(rt):
    def drain():
        got = []
        for feed in rt():
            got.extend(int(v) for v in np.asarray(feed["ids"]).reshape(-1))
        return got

    return _within(drain)


def _failing_decode(shard_id):
    yield {"ids": np.arange(BS, dtype=np.int64)}
    raise ValueError("decode blew up on shard %d" % shard_id)


# ---------------------------------------------------------------- ring

def test_ring_wraparound_and_slab_reuse():
    ring = RingBuffer(2, 4096)
    try:
        reader = RingBuffer(0, 0, name=ring.name, create=False)
        for i in range(13):  # > 6 full wraps over 2 slots
            slot = i % 2
            assert ring.try_claim(slot, owner=0)
            ring.begin_write(slot, 0)
            meta, nbytes = ring.pack(
                slot, {"v": np.full((7,), i, np.int64)}
            )
            seq = ring.commit(slot)
            out = reader.read(slot, meta, seq)
            assert out["v"].tolist() == [i] * 7
            out2 = out["v"].copy()
            ring.release(slot)
            # the copy must survive slot reuse (the next write overwrites
            # the slab in place)
            assert out2.tolist() == [i] * 7
        reader.close()
    finally:
        ring.close()


def test_ring_torn_read_detection():
    ring = RingBuffer(1, 4096)
    try:
        ring.begin_write(0, 0)
        meta, _ = ring.pack(0, {"v": np.arange(3, dtype=np.int64)})
        seq = ring.commit(0)
        # descriptor from a previous life of the slot: seq mismatch
        with pytest.raises(TornSlotError):
            ring.read(0, meta, seq - 2)
        # mid-write (odd seq) must never be served
        ring.begin_write(0, 0)
        with pytest.raises(TornSlotError):
            ring.read(0, meta, seq + 1)
    finally:
        ring.close()


def test_ring_slab_overflow_raises():
    ring = RingBuffer(1, 256)
    try:
        with pytest.raises(SlabOverflowError):
            ring.pack(0, {"v": np.zeros(4096, np.float32)})
    finally:
        ring.close()


def test_ring_reclaim_dead():
    ring = RingBuffer(3, 4096)
    try:
        # worker 1 died mid-write on slot 0, committed-undelivered slot 1
        ring.begin_write(0, 1)
        ring.begin_write(1, 1)
        ring.pack(1, {"v": np.zeros(2, np.int64)})
        ring.commit(1)
        ring.begin_write(2, 0)  # live worker 0: untouched
        reclaimed = ring.reclaim_dead([1])
        assert sorted(reclaimed) == [0, 1]
        assert ring.seq(0) % 2 == 0  # forced even: torn payload unreachable
        assert ring.owned_slots() == [2]
    finally:
        ring.close()


# ------------------------------------------------------------ sharding

@pytest.mark.parametrize("num_shards,num_hosts", [(12, 1), (12, 2), (12, 3),
                                                  (7, 2), (5, 8)])
def test_host_shards_exact_disjoint_cover(num_shards, num_hosts):
    order = epoch_shard_order(num_shards, seed=3, epoch=1)
    parts = [host_shards(order, num_hosts, h) for h in range(num_hosts)]
    flat = [s for p in parts for s in p]
    assert sorted(flat) == list(range(num_shards))  # exact cover
    assert len(set(flat)) == len(flat)  # disjoint
    # deterministic: same seed/epoch -> same order on every host/process
    assert epoch_shard_order(num_shards, seed=3, epoch=1) == order
    # epochs reshuffle
    assert epoch_shard_order(num_shards, seed=3, epoch=2) != order
    # unshuffled is identity
    assert epoch_shard_order(num_shards, seed=3, epoch=1, shuffle=False) == list(
        range(num_shards)
    )


@pytest.mark.parametrize("num_workers", [1, 2, 3, 5])
def test_worker_shards_partition(num_workers):
    order = epoch_shard_order(11, seed=0, epoch=0)
    parts = [worker_shards(order, num_workers, w) for w in range(num_workers)]
    assert sorted(s for p in parts for s in p) == sorted(order)


# ------------------------------------------------------------- runtime

def test_runtime_epoch_exact_and_multi_epoch():
    rt = DataRuntime(_decode, num_shards=6, num_workers=2, seed=1,
                     stage_device=False)
    try:
        for _ in range(2):
            rt.start()
            got = _drain_ids(rt)
            assert sorted(got) == _expected_ids(range(6))
            assert not rt.started  # EOF ends the epoch
    finally:
        rt.close()


@pytest.mark.parametrize("num_hosts,num_workers", [(2, 1), (2, 2), (3, 2)])
def test_runtime_multihost_exact_cover(num_hosts, num_workers):
    rts = [
        DataRuntime(_decode, num_shards=6, num_workers=num_workers, seed=5,
                    num_hosts=num_hosts, host_id=h, stage_device=False)
        for h in range(num_hosts)
    ]
    try:
        all_ids = []
        for rt in rts:
            rt.start()
            all_ids.extend(_drain_ids(rt))
        assert sorted(all_ids) == _expected_ids(range(6))
    finally:
        for rt in rts:
            rt.close()


def test_runtime_empty_host_is_immediate_eof():
    # more hosts than shards: this host holds nothing -> clean empty epoch
    rt = DataRuntime(_decode, num_shards=2, num_workers=2, seed=0,
                     num_hosts=4, host_id=3, stage_device=False,
                     batch_spec={"ids": ((BS,), np.int64),
                                 "x": ((BS, 3), np.float32)})
    try:
        rt.start()
        assert _drain_ids(rt) == []
    finally:
        rt.close()


def test_runtime_eof_and_reset_semantics():
    rt = DataRuntime(_decode, num_shards=4, num_workers=2, seed=2,
                     stage_device=False)
    try:
        rt.start()
        _ = _drain_ids(rt)  # full drain raises EOF internally
        with pytest.raises(RuntimeError):
            rt.next_batch()  # epoch over: not started
        # reset mid-epoch, then a fresh epoch is complete
        rt.start()
        rt.next_batch()
        rt.reset()
        rt.start()
        assert sorted(_drain_ids(rt)) == _expected_ids(range(4))
    finally:
        rt.close()


def test_runtime_decode_error_surfaces():
    rt = DataRuntime(_failing_decode, num_shards=2, num_workers=1, seed=0,
                     stage_device=False,
                     batch_spec={"ids": ((BS,), np.int64)})
    try:
        rt.start()

        def pull():
            while True:
                rt.next_batch()

        with pytest.raises(RuntimeError, match="decode blew up"):
            _within(pull)
    finally:
        rt.close()


def test_runtime_device_staging_returns_tensors():
    import torch

    rt = DataRuntime(_decode, num_shards=2, num_workers=2, seed=0,
                     stage_device=True)
    try:
        rt.start()
        feeds = _within(lambda: list(rt()))
        assert len(feeds) == 2 * BATCHES_PER_SHARD
        for feed in feeds:
            assert isinstance(feed["ids"], torch.Tensor)
            assert feed["ids"].device.type == "cpu" and feed["ids"].dtype == torch.int64
    finally:
        rt.close()


def test_runtime_needs_a_place_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a box without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _DataRuntime(_decode, num_shards=2)


def _tagged_decode(shard_id):
    for b in range(BATCHES_PER_SHARD):
        yield {"shard": np.full((1,), shard_id, np.int64), "index": np.full((1,), b, np.int64),
               "x": np.full((BS, 2), shard_id * 10 + b, np.float32)}


@pytest.mark.parametrize("num_hosts,host_id,num_workers,epoch", [
    (1, 0, 2, 0), (1, 0, 3, 1), (2, 1, 2, 0), (3, 0, 1, 2)])
def test_deliveries_equal_the_jax_runtime(num_hosts, host_id, num_workers, epoch):
    """The set of (shard, batch) pairs an epoch delivers, and each batch's
    values, equal the JAX package's DataRuntime's for the same seed, hosts
    and epoch."""
    from paddle_tpu.data import DataRuntime as JDataRuntime

    def epoch_of(rt):
        rt.start(epoch=epoch)
        feeds = _within(lambda: list(rt()))
        return {(int(np.asarray(f["shard"])[0]), int(np.asarray(f["index"])[0])):
                np.asarray(f["x"]) for f in feeds}

    kw = dict(num_shards=7, num_workers=num_workers, seed=13, num_hosts=num_hosts,
              host_id=host_id, stage_device=False)
    port, ref = DataRuntime(_tagged_decode, **kw), JDataRuntime(_tagged_decode, **kw)
    try:
        got, want = epoch_of(port), epoch_of(ref)
    finally:
        port.close()
        ref.close()
    assert sorted(got) == sorted(want)
    mine = host_shards(epoch_shard_order(7, 13, epoch), num_hosts, host_id)
    assert sorted(got) == sorted((s, b) for s in mine for b in range(BATCHES_PER_SHARD))
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


# ------------------------------------------------- crash-replay contract

def _kill_one_worker_mid_epoch(rt, after_batches):
    rt.start()

    def run():
        got, killed, n = [], False, 0
        for feed in rt():
            got.extend(int(v) for v in np.asarray(feed["ids"]).reshape(-1))
            n += 1
            if n == after_batches and not killed:
                pid = [p for p in rt._pool.pids() if p][0]
                os.kill(pid, signal.SIGKILL)
                killed = True
        assert killed, "epoch ended before the kill point"
        return got

    return _within(run)


def test_worker_kill_mid_epoch_loses_and_duplicates_nothing():
    slow = functools.partial(_decode, batches=5, delay=0.01)
    rt = DataRuntime(slow, num_shards=12, num_workers=3, seed=1,
                     stage_device=False, ring_slots=6)
    try:
        got = _kill_one_worker_mid_epoch(rt, after_batches=5)
        expect = _expected_ids(range(12), batches=5)
        assert sorted(got) == expect, (
            "kill-replay mismatch: %d got vs %d expected"
            % (len(got), len(expect))
        )
        assert sum(rt._pool.restarts) == 1
        # the respawned pool serves the next epoch cleanly
        rt.start()
        assert sorted(_drain_ids(rt)) == expect
    finally:
        rt.close()


def test_worker_kill_with_single_worker_recovers():
    slow = functools.partial(_decode, batches=4, delay=0.01)
    rt = DataRuntime(slow, num_shards=4, num_workers=1, seed=0,
                     stage_device=False)
    try:
        got = _kill_one_worker_mid_epoch(rt, after_batches=2)
        assert sorted(got) == _expected_ids(range(4), batches=4)
    finally:
        rt.close()


def test_worker_restart_budget_exhaustion_is_fatal():
    slow = functools.partial(_decode, batches=50, delay=0.05)
    rt = DataRuntime(slow, num_shards=4, num_workers=1, seed=0,
                     stage_device=False, max_worker_restarts=1)
    try:
        rt.start()

        def kill_until_fatal():
            while True:
                rt.next_batch()
                pid = [p for p in rt._pool.pids() if p][0]
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass  # raced a respawn; the next loop kills the new pid
                time.sleep(0.05)

        with pytest.raises(RuntimeError, match="restart budget"):
            _within(kill_until_fatal)
    finally:
        rt.close()


# --------------------------------------------------- PyReader front end

def _plain_reader():
    for b in range(8):
        yield [((np.arange(3) + b * 10).astype(np.float32), np.int64(b))
               for _ in range(BS)]


def _factory_reader(shard_id, num_shards):
    for b in range(shard_id, 12, num_shards):
        yield {"x": np.full((BS, 3), b, np.float32),
               "y": np.full((BS,), b, np.int64)}


def test_pyreader_num_workers_roundrobin_exact():
    r = PyReader(["x", "y"], return_device_arrays=False)
    r.decorate_paddle_reader(_plain_reader, num_workers=2)
    try:
        for _ in range(2):  # multi-epoch through the same pool
            r.start()
            ys = _within(lambda: [int(np.asarray(f["y"])[0]) for f in r()])
            assert sorted(ys) == list(range(8))
    finally:
        r.close()


def test_pyreader_num_workers_shard_factory_exact():
    r = PyReader(["x", "y"], return_device_arrays=False)
    r.decorate_tensor_provider(_factory_reader, num_workers=2, num_shards=3)
    try:
        r.start()
        ys = _within(lambda: [int(np.asarray(f["y"])[0]) for f in r()])
        assert sorted(ys) == list(range(12))
    finally:
        r.close()


def test_pyreader_runtime_reset_midepoch_then_full_epoch():
    r = PyReader(["x", "y"], return_device_arrays=False)
    r.decorate_paddle_reader(_plain_reader, num_workers=2)
    try:
        r.start()
        _within(r.next_batch)
        r.reset()
        r.start()
        ys = _within(lambda: [int(np.asarray(f["y"])[0]) for f in r()])
        assert sorted(ys) == list(range(8))
    finally:
        r.close()


def test_pyreader_reset_generation_guard_regression():
    """reset()+redecorate races the old feeder thread's epoch-cache
    install: a reader stalled just before StopIteration finishes AFTER the
    new dataset is decorated — without the generation tag its stale cache
    would be installed over the new dataset and replayed (cache_epoch)."""
    entered, release = threading.Event(), threading.Event()

    def reader_a():
        for b in range(3):
            yield {"x": np.full((2,), b, np.float32)}
        entered.set()
        release.wait(timeout=10)  # stall inside user code, past last yield

    def reader_b():
        yield {"x": np.full((2,), 99.0, np.float32)}

    r = PyReader(["x"], return_device_arrays=False, cache_epoch=True)
    r.decorate_tensor_provider(reader_a)
    r.start()
    for _ in range(3):
        r.next_batch()
    assert entered.wait(timeout=10)
    # reset() blocks joining the stalled thread -> run it on the side
    resetter = threading.Thread(target=r.reset)
    resetter.start()
    time.sleep(0.2)  # let reset() bump the generation and set stop
    r.decorate_tensor_provider(reader_b)  # clears the cache for B
    release.set()  # stale A-thread now finishes its install attempt
    resetter.join(timeout=10)
    assert not resetter.is_alive()
    r.start()
    vals = [float(np.asarray(f["x"])[0]) for f in r()]
    assert vals == [99.0], "stale epoch cache leaked across reset: %r" % vals


def test_pyreader_cache_epoch_over_runtime():
    r = PyReader(["x", "y"], return_device_arrays=False, cache_epoch=True)
    r.decorate_paddle_reader(_plain_reader, num_workers=2)
    try:
        r.start()
        e1 = _within(lambda: sorted(int(np.asarray(f["y"])[0]) for f in r()))
        assert r._cache is not None and len(r._cache) == 8
        r.start()
        assert not r._runtime_active  # replay path: workers idle
        e2 = _within(lambda: sorted(int(np.asarray(f["y"])[0]) for f in r()))
        assert e1 == e2 == list(range(8))
    finally:
        r.close()


def test_runtime_metrics_registered():
    from paddle_tpu_torch.observability.registry import default_registry

    rt = DataRuntime(_decode, num_shards=2, num_workers=2, seed=0,
                     stage_device=False)
    try:
        rt.start()
        _ = _drain_ids(rt)
    finally:
        rt.close()
    snap = default_registry().snapshot()
    assert "data/epochs" in snap
    assert "data/batches_total" in snap
    total = sum(snap["data/batches_total"]["values"].values())
    assert total >= 2 * BATCHES_PER_SHARD


@pytest.mark.slow
def test_runtime_spawn_start_method():
    rt = DataRuntime(_decode, num_shards=4, num_workers=2, seed=0,
                     stage_device=False, start_method="spawn")
    try:
        rt.start()
        assert sorted(_drain_ids(rt)) == _expected_ids(range(4))
    finally:
        rt.close()


@pytest.mark.slow
def test_worker_kill_soak():
    """Repeated kill points across the epoch: the exactly-once contract
    must hold wherever the SIGKILL lands."""
    slow = functools.partial(_decode, batches=5, delay=0.01)
    expect = _expected_ids(range(12), batches=5)
    for kill_at in (1, 7, 20, 40):
        rt = DataRuntime(slow, num_shards=12, num_workers=3, seed=kill_at,
                         stage_device=False, ring_slots=6)
        try:
            got = _kill_one_worker_mid_epoch(rt, after_batches=kill_at)
            counts = collections.Counter(got)
            assert sorted(got) == expect, (
                "kill@%d: %d got vs %d expected (dups: %s)"
                % (kill_at, len(got), len(expect),
                   [k for k, v in counts.items() if v > 1][:4])
            )
        finally:
            rt.close()
