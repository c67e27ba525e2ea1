"""The elastic slice of the port (paddle_tpu_torch.resilience async_ckpt and
elastic) against the JAX package, on the CPU:

- elastic checkpoints written by either package load in the other bit for
  bit: two hosts (written concurrently), a replica standing in for a lost
  shard, a bf16 var; the manifests are the JAX package's byte for byte
  but for the shards' sha256 (an npz holds its write time);
- plan_host_ranges and derive_data_shards give the JAX package's outputs;
- the behaviour tests of tests/test_elastic.py on the port: round trips,
  replica fallback, GC, the fsync ordering, torn dirs, the
  AsyncCheckpointer (deferred failures, its stall and pinned-buffer
  readings), the Supervisor (bit-exact resume, the data cursor, preemption
  drain and commit, the watchdog's emergency checkpoint, the NaN-storm
  rollback and its budget, rollback), the format preference of
  resume_or_init, the executor's heartbeat, a SIGKILL of one of two hosts
  resumed bit for bit by one, a SIGKILL soak of the writer, and a dp 2 ->
  dp 1 resume over gloo ranks.
"""

import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import jax
import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu.resilience import async_ckpt as jasync
from paddle_tpu.resilience import elastic as jelastic
from paddle_tpu_torch.observability.registry import default_registry
from paddle_tpu_torch.resilience import (
    AsyncCheckpointer, FatalError, Preempted, Supervisor, async_ckpt, checkpoint as ckpt,
    elastic, faults, health,
)

import torch_parallel_ranks as ranks

jax.config.update("jax_platforms", "cpu")

HERE = os.path.dirname(os.path.abspath(__file__))
RUNNER = os.path.join(HERE, "torch_elastic_runner.py")
CPU = fluid.CPUPlace()


@pytest.fixture(autouse=True)
def _clean_resilience():
    faults.install(None)
    health.reset()
    default_registry().reset("resilience/")
    yield
    faults.install(None)
    health.reset()
    default_registry().reset("resilience/")


@pytest.fixture
def restore_flags():
    names = ["resilience_nan_guard", "resilience_lr_decay", "elastic_step_deadline_s",
             "elastic_nan_budget", "elastic_rollback_budget", "elastic_barrier_timeout_s"]
    saved = fluid.get_flags(names)
    yield
    fluid.set_flags(saved)


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(10, 4).astype(np.float32), "b": rng.randn(4).astype(np.float32),
            "lr": np.float32(0.1)}


def _build_mlp(lr=0.1):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(input=x, size=16, act="relu")
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    return main, startup, loss


def _mlp_batch(step, bs=16):
    rng = np.random.RandomState(step)
    x = rng.randn(bs, 8).astype(np.float32)
    return {"x": x, "y": np.abs(x).sum(axis=1, keepdims=True).astype(np.float32)}


def _scope(seed):
    return fluid.scope_guard(fluid.Scope(seed=seed, place=CPU))


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
    a = np.asarray(v)
    return a.astype(np.float32) if "bfloat16" in str(a.dtype) else a


# ---------------------------------------------------------------------------
# the partition plan and the data shards, against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_hosts", [1, 2, 3, 4])
def test_plan_host_ranges_matches_the_jax_package(num_hosts):
    shapes = {"w": (10, 4), "b": (4,), "lr": (), "t": (7, 2), "s": (2, 3), "e": (4096, 8)}
    assert async_ckpt.plan_host_ranges(shapes, num_hosts) == \
        jasync.plan_host_ranges(shapes, num_hosts)


def test_plan_host_ranges_covers_disjoint_deterministic():
    shapes = {"w": (10, 4), "b": (4,), "lr": ()}
    plans = async_ckpt.plan_host_ranges(shapes, 2)
    assert plans[0]["w"] == [0, 5] and plans[1]["w"] == [5, 10]
    assert plans[0]["b"] == [0, 2] and plans[1]["b"] == [2, 4]
    owners = [h for h, p in enumerate(plans) if "lr" in p]
    assert len(owners) == 1 and plans[owners[0]]["lr"] is None
    (solo,) = async_ckpt.plan_host_ranges(shapes, 1)
    assert set(solo) == set(shapes) and all(v is None for v in solo.values())
    ranges = [p["t"] for p in async_ckpt.plan_host_ranges({"t": (7, 2)}, 3)]
    assert ranges[0][0] == 0 and ranges[-1][1] == 7
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("num_hosts", [1, 2, 3, 4])
def test_derive_data_shards_matches_the_jax_package(num_hosts):
    for cursor in ({"epoch": 3, "batch_index": 17, "seed": 5}, {"epoch": 0}, None):
        union = []
        for h in range(num_hosts):
            got = elastic.derive_data_shards(cursor, num_hosts, h, 16)
            assert got == jelastic.derive_data_shards(cursor, num_hosts, h, 16)
            union.extend(got)
        assert sorted(union) == list(range(16))


# ---------------------------------------------------------------------------
# round trips, replicas, cross-package loads
# ---------------------------------------------------------------------------


def test_single_host_roundtrip(tmp_path):
    root = str(tmp_path)
    arrays = _arrays()
    d = async_ckpt.write_elastic_checkpoint(
        root, arrays, 7, cursor={"epoch": 1, "batch_index": 9, "seed": 3},
        topology={"dp": 8, "num_hosts": 1})
    assert async_ckpt.verify_elastic_checkpoint(d)
    assert async_ckpt.latest_valid_elastic(root) == (7, d)
    step, out, manifest = async_ckpt.load_elastic(d)
    assert step == 7 and manifest["cursor"] == {"epoch": 1, "batch_index": 9, "seed": 3}
    assert manifest["topology"]["dp"] == 8
    for n, a in arrays.items():
        np.testing.assert_array_equal(out[n], a)
        assert out[n].dtype == np.asarray(a).dtype


def _write_two_host(mod, root, arrays, step):
    """Both hosts of a 2-host elastic checkpoint, concurrently (each host's
    replica step waits for its neighbour's shard)."""
    errs = []

    def host(h):
        try:
            mod.write_elastic_checkpoint(root, arrays, step, num_hosts=2, host_id=h,
                                         barrier_timeout=30.0)
        except BaseException as e:
            errs.append(e)

    ts = [threading.Thread(target=host, args=(h,)) for h in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs, errs
    return os.path.join(root, "eckpt-%08d" % step)


def test_two_host_roundtrip_and_replica_fallback(tmp_path):
    root = str(tmp_path)
    arrays = _arrays(1)
    d = _write_two_host(async_ckpt, root, arrays, 12)
    assert async_ckpt.verify_elastic_checkpoint(d)
    step, out, _ = async_ckpt.load_elastic(d)
    assert step == 12
    for n, a in arrays.items():
        np.testing.assert_array_equal(out[n], a)
    os.unlink(os.path.join(d, "shard-00001-of-00002.npz"))
    os.unlink(os.path.join(d, "shard-00001.ok.json"))
    assert async_ckpt.verify_elastic_checkpoint(d)
    _, out, _ = async_ckpt.load_elastic(d)
    for n, a in arrays.items():
        np.testing.assert_array_equal(out[n], a)
    os.unlink(os.path.join(d, "replica-00001-by-00000.npz"))
    assert not async_ckpt.verify_elastic_checkpoint(d)
    with pytest.warns(UserWarning, match="unrecoverable"):
        assert async_ckpt.latest_valid_elastic(root) is None
    assert health.get("ckpt_skipped_invalid") == 1
    with pytest.raises(IOError, match="neither an intact shard nor a replica"):
        async_ckpt.load_elastic(d)


def test_bf16_widening_roundtrip(tmp_path):
    arrays = {"p": torch.arange(8, dtype=torch.float32).to(torch.bfloat16)}
    d = async_ckpt.write_elastic_checkpoint(str(tmp_path), arrays, 1)
    _, out, manifest = async_ckpt.load_elastic(d)
    assert manifest["arrays"]["p"]["dtype"] == "bfloat16"
    assert manifest["arrays"]["p"]["stored_dtype"] == "float32"
    assert out["p"].dtype == torch.bfloat16
    assert torch.equal(out["p"], arrays["p"])


def _mixed_state():
    import jax.numpy as jnp

    base = _arrays(5)
    base["emb"] = np.random.RandomState(6).randn(9, 3).astype(np.float32)
    mom = np.linspace(-2, 2, 18, dtype=np.float32).reshape(6, 3)
    jarrays = dict(base, moment=jnp.asarray(mom, jnp.bfloat16))
    parrays = dict({n: torch.from_numpy(v) if v.ndim else v for n, v in base.items()},
                   moment=torch.from_numpy(mom).to(torch.bfloat16))
    return jarrays, parrays


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_elastic_checkpoint_cross_loads_bit_for_bit(tmp_path, writer):
    """Two hosts of either package write an elastic checkpoint (a bf16 var
    among f32 ones); the other package verifies and loads it bit for bit,
    also from a replica after host 1's shard is lost. Both packages'
    manifests are equal but for the shards' sha256."""
    jarrays, parrays = _mixed_state()
    dirs = {"jax": _write_two_host(jasync, str(tmp_path / "j"), jarrays, 5),
            "port": _write_two_host(async_ckpt, str(tmp_path / "p"), parrays, 5)}
    manifests = {}
    for k, d in dirs.items():
        with open(os.path.join(d, "MANIFEST.json")) as f:
            m = json.load(f)
        for meta in m["files"].values():
            meta.pop("sha256")
        manifests[k] = m
    assert manifests["jax"] == manifests["port"]
    assert manifests["port"]["arrays"]["moment"]["dtype"] == "bfloat16"
    reader = async_ckpt if writer == "jax" else jasync
    d = dirs[writer]
    want = {n: _np(v) for n, v in parrays.items()}
    for lose_host1 in (False, True):
        if lose_host1:
            os.unlink(os.path.join(d, "shard-00001-of-00002.npz"))
        assert reader.verify_elastic_checkpoint(d)
        step, got, _ = reader.load_elastic(d)
        assert step == 5 and sorted(got) == sorted(want)
        for n, v in want.items():
            assert _np(got[n]).tobytes() == v.tobytes(), (n, lose_host1)
        assert "bfloat16" in str(got["moment"].dtype)


def test_keep_last_gc_never_collects_newest(tmp_path):
    root = str(tmp_path)
    for s in range(1, 6):
        async_ckpt.write_elastic_checkpoint(root, _arrays(s), s, keep_last=2)
    assert [s for s, _ in async_ckpt.list_elastic_checkpoints(root)] == [5, 4]
    assert async_ckpt.latest_valid_elastic(root)[0] == 5


def test_manifest_fsync_ordering(tmp_path, monkeypatch):
    """Every data rename and a directory fsync land before the MANIFEST
    rename, and the manifest's rename is followed by a directory fsync, in
    both formats."""
    events = []
    real_replace, real_fsync = os.replace, os.fsync
    monkeypatch.setattr(os, "replace", lambda a, b: (
        events.append(("replace", os.path.basename(b))), real_replace(a, b))[1])
    monkeypatch.setattr(os, "fsync", lambda fd: (events.append(("fsync", fd)),
                                                 real_fsync(fd))[1])
    from paddle_tpu_torch import io as fluid_io

    real_fsync_dir = fluid_io.fsync_dir
    monkeypatch.setattr(fluid_io, "fsync_dir", lambda p: (
        events.append(("fsync_dir", os.path.abspath(p))), real_fsync_dir(p))[1])
    for write in (lambda: ckpt.save_checkpoint(str(tmp_path / "classic"), _arrays(), 1),
                  lambda: async_ckpt.write_elastic_checkpoint(str(tmp_path / "elastic"),
                                                              _arrays(), 1)):
        events.clear()
        d = write()
        idx = [i for i, e in enumerate(events) if e == ("replace", "MANIFEST.json")]
        assert len(idx) == 1
        mi = idx[0]
        assert all(i < mi for i, e in enumerate(events) if e[0] == "replace" and i != mi)
        assert any(e == ("fsync_dir", os.path.abspath(d)) for e in events[:mi]), events
        assert any(e == ("fsync_dir", os.path.abspath(d)) for e in events[mi:]), events
        assert any(e[0] == "fsync" for e in events[:mi])


def test_torn_dir_crashes_are_skipped(tmp_path):
    root = str(tmp_path)
    async_ckpt.write_elastic_checkpoint(root, _arrays(0), 1)
    for kind, step in (("manifest_crash", 2), ("eckpt_commit_crash", 3), ("ckpt_crash", 4)):
        faults.install(kind)
        with pytest.raises(faults.InjectedFault):
            async_ckpt.write_elastic_checkpoint(root, _arrays(step), step)
        faults.install(None)
    torn = os.path.join(root, "eckpt-00000002")
    assert os.path.isdir(torn) and not os.path.exists(os.path.join(torn, "MANIFEST.json"))
    with pytest.warns(UserWarning):
        found = async_ckpt.latest_valid_elastic(root)
    assert found is not None and found[0] == 1
    _, out, _ = async_ckpt.load_elastic(found[1])
    np.testing.assert_array_equal(out["w"], _arrays(0)["w"])
    assert health.get("ckpt_skipped_invalid") >= 2


# ---------------------------------------------------------------------------
# AsyncCheckpointer
# ---------------------------------------------------------------------------


def test_async_checkpointer_defers_background_failure(tmp_path):
    cp = AsyncCheckpointer(str(tmp_path))
    faults.install("eckpt_commit_crash")
    cp.save(_arrays(), 1)
    with pytest.raises(faults.InjectedFault):
        cp.wait()
    assert health.get("ckpt_async_failed") == 1
    faults.install(None)
    cp.save(_arrays(), 2)
    cp.wait()
    assert cp.last_commit_dir is not None
    assert async_ckpt.latest_valid_elastic(str(tmp_path))[0] == 2
    cp.close()


def test_async_checkpointer_records_stall_and_freshness(tmp_path):
    """The stall, the state bytes and the commit's wall are read each save;
    a CPU tensor is copied (a later in-place update does not reach the
    checkpoint), and no pinned buffer is made for CPU state."""
    cp = AsyncCheckpointer(str(tmp_path))
    state = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4), "lr": np.float32(0.5)}
    stall = cp.save(state, 3)
    state["w"].add_(100.0)  # the step after the save, in place
    cp.wait()
    assert stall >= 0.0
    assert cp.stats["state_bytes"] == 12 * 4 + 4 and cp.stats["pinned_blocks"] == 0
    assert cp.stats["write_ms"] >= cp.stats["stall_ms"] >= 0.0
    _, out, _ = async_ckpt.load_elastic(cp.last_commit_dir)
    np.testing.assert_array_equal(out["w"], np.arange(12, dtype=np.float32).reshape(3, 4))
    snap = default_registry().snapshot()
    assert snap["resilience/ckpt_stall_ms"]["count"] >= 1
    assert snap["resilience/ckpt_commits"]["values"][""] == 1
    assert snap["resilience/last_ckpt_step"]["values"][""] == 3.0
    cp.close()


# ---------------------------------------------------------------------------
# fault kinds and drains
# ---------------------------------------------------------------------------


def test_preempt_fault_delivers_sigterm_synchronously():
    hits = []
    old = signal.signal(signal.SIGTERM, lambda s, f: hits.append(s))
    try:
        faults.install("preempt:step=2")
        assert faults.preempt_self() is False and not hits
        assert faults.preempt_self() is True
        assert hits == [signal.SIGTERM]
        assert faults.preempt_self() is False
    finally:
        signal.signal(signal.SIGTERM, old)


def test_hang_fault_sleeps_configured_ms():
    faults.install("hang:ms=80")
    t0 = time.perf_counter()
    assert faults.hang() is True
    assert time.perf_counter() - t0 >= 0.06
    faults.install(None)
    t0 = time.perf_counter()
    assert faults.hang() is False
    assert time.perf_counter() - t0 < 0.05


def test_pyreader_drain_counts_dropped_batches():
    from paddle_tpu_torch.py_reader import PyReader

    r = PyReader(["x"], return_device_arrays=False, place=CPU)
    data = [[(np.full(4, i, "float32"),) for i in range(2)] for _ in range(3)]
    r.decorate_paddle_reader(lambda: iter(data))
    r.start()
    b = r.next_batch()
    r.push_back(b)
    time.sleep(0.05)
    dropped = r.drain()
    assert dropped >= 1
    assert health.get("drain_batches_dropped") == dropped
    r.close()


def test_supervisor_drain_prefers_drain_then_closes():
    calls = []

    class FakeReader:
        def drain(self):
            calls.append("drain")

        def reset(self):
            calls.append("reset")

        def close(self):
            calls.append("close")

    class WedgedReader(FakeReader):
        def drain(self):
            raise RuntimeError("wedged")

    exe = fluid.Executor(CPU)
    Supervisor(exe, "/nonexistent", reader=FakeReader()).drain()
    assert calls == ["drain", "close"]
    calls.clear()
    Supervisor(exe, "/nonexistent", reader=WedgedReader()).drain()
    assert calls == ["reset", "close"]


# ---------------------------------------------------------------------------
# Supervisor
# ---------------------------------------------------------------------------


def _train_supervised(root, steps, ckpt_every, seed=1, resume=False):
    main, startup, loss = _build_mlp()
    with _scope(seed):
        exe = fluid.Executor(CPU)
        sup = Supervisor(exe, root, program=main, ckpt_every=ckpt_every)
        start, _cursor = sup.resume_or_init(startup)
        if not resume:
            assert start == 0
        losses = {}
        with sup:
            for s in range(start, steps):
                (lv,) = sup.run_step(program=main, feed=_mlp_batch(s), fetch_list=[loss])
                losses[s] = float(np.asarray(lv).ravel()[0])
            sup.checkpointer.wait()
    return losses, start


def test_supervisor_resume_is_bit_exact(tmp_path):
    root = str(tmp_path / "ck")
    golden, _ = _train_supervised(str(tmp_path / "golden"), 10, ckpt_every=0)
    first, _ = _train_supervised(root, 6, ckpt_every=2)
    assert async_ckpt.latest_valid_elastic(root)[0] == 6
    assert all(first[s] == golden[s] for s in range(6))
    cont, start = _train_supervised(root, 10, ckpt_every=2, resume=True)
    assert start == 6 and health.get("resumed_from_checkpoint") == 1
    for s in range(6, 10):
        assert cont[s] == golden[s], (s, cont[s], golden[s])


def test_supervisor_resume_restores_data_cursor(tmp_path):
    root = str(tmp_path)
    main, startup, loss = _build_mlp()
    with _scope(1):
        sup = Supervisor(fluid.Executor(CPU), root, program=main, ckpt_every=0)
        sup.resume_or_init(startup)
        with sup:
            for s in range(3):
                sup.run_step(program=main, feed=_mlp_batch(s), fetch_list=[loss])
            sup.next_epoch()
            sup.cursor["seed"] = 7
            sup.save(block=True)
    with _scope(2):
        sup = Supervisor(fluid.Executor(CPU), root, program=main, ckpt_every=0)
        step, cursor = sup.resume_or_init(startup)
    assert step == 3 and cursor == {"epoch": 1, "batch_index": 0, "seed": 7}


def test_supervisor_preemption_drains_and_commits(tmp_path):
    root = str(tmp_path)
    faults.install("preempt:step=3")
    drained = []

    class R:
        def drain(self):
            drained.append(1)

    main, startup, loss = _build_mlp()
    with _scope(1):
        sup = Supervisor(fluid.Executor(CPU), root, program=main, ckpt_every=0, reader=R())
        sup.resume_or_init(startup)
        with sup:
            with pytest.raises(Preempted, match="checkpoint committed"):
                for s in range(10):
                    sup.run_step(program=main, feed=_mlp_batch(s), fetch_list=[loss])
    assert health.get("preemptions") == 1 and health.get("preempt_signals") == 1
    assert drained == [1]
    found = async_ckpt.latest_valid_elastic(root)
    assert found is not None and found[0] == 2
    assert default_registry().snapshot()["resilience/preemptions"]["values"][""] == 1


def test_supervisor_watchdog_emergency_checkpoint(tmp_path, restore_flags):
    root = str(tmp_path)
    faults.install("hang:step=2@ms=700")
    main, startup, loss = _build_mlp()
    with _scope(1):
        sup = Supervisor(fluid.Executor(CPU), root, program=main, ckpt_every=0,
                         step_deadline_s=0.3)
        sup.resume_or_init(startup)
        with sup:
            with pytest.raises(FatalError, match="exceeded deadline 0.300s"):
                for s in range(5):
                    sup.run_step(program=main, feed=_mlp_batch(s), fetch_list=[loss])
    assert health.get("watchdog_stalls") >= 1
    assert health.get("emergency_checkpoints") == 1
    assert async_ckpt.latest_valid_elastic(root) is not None


def test_supervisor_nan_storm_rollback_then_fatal(tmp_path, restore_flags):
    fluid.set_flags({"resilience_nan_guard": True})
    main, startup, loss = _build_mlp()
    with _scope(1):
        sup = Supervisor(fluid.Executor(CPU), str(tmp_path), program=main, ckpt_every=2,
                         nan_budget=2, rollback_budget=1)
        sup.resume_or_init(startup)
        faults.install("nan_grad:every=1@after=3")
        with sup:
            with pytest.raises(FatalError, match="NaN storm persisted"):
                for s in range(50):
                    sup.run_step(program=main, feed=_mlp_batch(s), fetch_list=[loss])
    assert health.get("elastic_rollbacks") == 2
    assert default_registry().snapshot()["resilience/rollbacks"]["values"][""] == 2


def test_rollback_restores_state_and_cursor(tmp_path):
    main, startup, loss = _build_mlp()
    with _scope(1):
        sup = Supervisor(fluid.Executor(CPU), str(tmp_path), program=main, ckpt_every=0)
        sup.resume_or_init(startup)
        with sup:
            for s in range(4):
                sup.run_step(program=main, feed=_mlp_batch(s), fetch_list=[loss])
            sup.save(block=True)
            saved = {n: _np(a).copy() for n, a in sup._state().items()}
            for s in range(4, 7):
                sup.run_step(program=main, feed=_mlp_batch(s), fetch_list=[loss])
            sup.rollback()
            assert sup.step == 4 and sup.cursor["batch_index"] == 4
            for n, a in sup._state().items():
                assert isinstance(a, torch.Tensor)
                np.testing.assert_array_equal(_np(a), saved[n])


def test_resume_prefers_newer_format_either_way(tmp_path):
    _main, startup, _loss = _build_mlp()
    root = str(tmp_path / "a")
    async_ckpt.write_elastic_checkpoint(root, {"m": np.float32(1.0)}, 3)
    ckpt.save_checkpoint(root, {"m": np.float32(2.0)}, 5)
    sc = fluid.Scope(seed=0, place=CPU)
    with fluid.scope_guard(sc):
        assert elastic.resume_or_init(fluid.Executor(CPU), startup, root) == (5, {})
        assert float(sc.find_var("m")) == 2.0
    root = str(tmp_path / "b")
    ckpt.save_checkpoint(root, {"m": np.float32(2.0)}, 5)
    async_ckpt.write_elastic_checkpoint(root, {"m": np.float32(9.0)}, 8,
                                        cursor={"epoch": 2, "batch_index": 1, "seed": 0})
    sc = fluid.Scope(seed=0, place=CPU)
    with fluid.scope_guard(sc):
        step, cursor = elastic.resume_or_init(fluid.Executor(CPU), startup, root)
        assert step == 8 and cursor["epoch"] == 2
        assert float(sc.find_var("m")) == 9.0
    assert health.get("resumed_from_checkpoint") == 2


def test_executor_run_beats_the_watchdog_bus():
    beats = []

    class W:
        def beat(self, now=None):
            beats.append(now)

    main, startup, loss = _build_mlp()
    w = W()
    with elastic._watchers_lock:
        elastic._watchers.append(w)
    try:
        with _scope(0):
            exe = fluid.Executor(CPU)
            exe.run(startup)
            exe.run(main, feed=_mlp_batch(0), fetch_list=[loss])
    finally:
        with elastic._watchers_lock:
            elastic._watchers.remove(w)
    assert len(beats) >= 2


# ---------------------------------------------------------------------------
# subprocesses: SIGKILL, the writer soak, and the dp 2 -> dp 1 resume
# ---------------------------------------------------------------------------


def _child_env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(HERE, ".."), env.get("PYTHONPATH", "")])
    for k in ("PADDLE_TPU_FAULTS", "PADDLE_TRAINER_ENDPOINTS", "PADDLE_TRAINER_ID"):
        env.pop(k, None)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _spawn(mode, env, tag):
    out = tempfile.NamedTemporaryFile(mode="w+", prefix="tel_%s_" % tag, suffix=".out",
                                      delete=False)
    err = tempfile.NamedTemporaryFile(mode="w+", prefix="tel_%s_" % tag, suffix=".err",
                                      delete=False)
    p = subprocess.Popen([sys.executable, RUNNER, mode], stdout=out, stderr=err, text=True,
                         env=env)
    return p, out, err


def _slurp(f):
    f.flush()
    f.seek(0)
    data = f.read()
    name = f.name
    f.close()
    if os.path.exists(name):
        os.unlink(name)
    return data


def _run_to_completion(mode, env, tag, timeout=300):
    p, out, err = _spawn(mode, env, tag)
    try:
        p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
    o, e = _slurp(out), _slurp(err)
    assert p.returncode == 0, "%s failed (rc=%s):\n%s\n%s" % (tag, p.returncode, o[-2000:],
                                                               e[-4000:])
    return o


def _step_hexes(out):
    got = {}
    for line in out.splitlines():
        if line.startswith("STEP "):
            _, s, hx = line.split()
            got[int(s)] = hx
    return got


def _resumed_step(out):
    for line in out.splitlines():
        if line.startswith("RESUMED "):
            return int(line.split()[1])
    raise AssertionError("no RESUMED line in:\n%s" % out[-2000:])


def _quiet_latest(root):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return async_ckpt.latest_valid_elastic(root)


def test_sigkill_one_of_two_hosts_resumes_bit_exact(tmp_path):
    """A 2-host elastic group is SIGKILLed mid-step, the dead host's shard
    files are deleted, and one host resumes from its shard and its replica
    of the other's, the losses continuing bit for bit (hex-compared) from
    the last committed step."""
    root = str(tmp_path / "eck")
    total = 60
    golden = _step_hexes(_run_to_completion("train", _child_env(
        CKPT_ROOT=str(tmp_path / "golden"), ELASTIC_NUM_HOSTS=1, ELASTIC_HOST_ID=0,
        TRAIN_STEPS=total, CKPT_EVERY=0), "golden"))
    assert sorted(golden) == list(range(total))
    procs = []
    try:
        for h in range(2):
            procs.append(_spawn("train", _child_env(
                CKPT_ROOT=root, ELASTIC_NUM_HOSTS=2, ELASTIC_HOST_ID=h, TRAIN_STEPS=100000,
                CKPT_EVERY=3, BARRIER_TIMEOUT=30, STEP_SLEEP_MS=40), "host%d" % h))
        deadline = time.monotonic() + 240
        committed = None
        while time.monotonic() < deadline:
            found = _quiet_latest(root)
            if found is not None and found[0] >= 6:
                committed = found
                break
            for p, _o, _e in procs:
                assert p.poll() is None, "a host exited before the kill"
            time.sleep(0.05)
        assert committed is not None, "no committed elastic checkpoint within 240 s"
        procs[1][0].send_signal(signal.SIGKILL)
        procs[0][0].send_signal(signal.SIGKILL)
        for p, _o, _e in procs:
            p.wait(timeout=30)
    finally:
        outs = []
        for p, o, e in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            outs.append((_slurp(o), _slurp(e)))
    for _s, d in async_ckpt.list_elastic_checkpoints(root):
        for fname in ("shard-00001-of-00002.npz", "shard-00001.ok.json"):
            if os.path.exists(os.path.join(d, fname)):
                os.unlink(os.path.join(d, fname))
    found = _quiet_latest(root)
    assert found is not None, "the shard loss killed the committed checkpoint"
    last_step = found[0]
    assert committed[0] <= last_step < total
    out = _run_to_completion("train", _child_env(
        CKPT_ROOT=root, ELASTIC_NUM_HOSTS=1, ELASTIC_HOST_ID=0, TRAIN_STEPS=total,
        CKPT_EVERY=0), "resume")
    assert _resumed_step(out) == last_step
    resumed = _step_hexes(out)
    assert sorted(resumed) == list(range(last_step, total))
    for s in range(last_step, total):
        assert resumed[s] == golden[s], (s, resumed[s], golden[s])
    for s, hx in _step_hexes(outs[0][0]).items():
        if s in golden:
            assert hx == golden[s]


def _soak_round(tmp_path, i, delay):
    root = str(tmp_path / ("soak%d" % i))
    p, out, err = _spawn("ckpt_loop", _child_env(CKPT_ROOT=root), "soak%d" % i)
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if async_ckpt.list_elastic_checkpoints(root):
                break
            assert p.poll() is None, _slurp(err)[-2000:]
            time.sleep(0.02)
        else:
            raise AssertionError("no checkpoint appeared in 120 s")
        time.sleep(delay)
        p.send_signal(signal.SIGKILL)
        p.wait(timeout=30)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
        _slurp(out), _slurp(err)
    w0 = np.random.RandomState(0).randn(64, 32).astype(np.float32)
    expected = {}
    last = max((s for s, _ in async_ckpt.list_elastic_checkpoints(root)), default=0)
    for step in range(1, 1 + last):
        w0 = w0 + np.float32(1.0)
        expected[step] = w0.copy()
    checked = 0
    for step, d in async_ckpt.list_elastic_checkpoints(root):
        if not os.path.exists(os.path.join(d, "MANIFEST.json")):
            continue
        assert async_ckpt.verify_elastic_checkpoint(d), d
        got_step, arrays, _ = async_ckpt.load_elastic(d)
        assert got_step == step
        np.testing.assert_array_equal(arrays["w0"], expected[step])
        checked += 1
    return checked


def test_checkpoint_sigkill_soak(tmp_path):
    """SIGKILL the writer at varied points of snapshot / write / commit:
    every surviving manifest loads consistently."""
    assert sum(_soak_round(tmp_path, i, d) for i, d in enumerate([0.0, 0.07, 0.15])) >= 1


def test_dp2_to_dp1_resume_parity(tmp_path):
    """ZeRO-1 ParallelExecutor training at dp 2 (gloo ranks, each a host of
    the elastic checkpoint), resumed on the same root at dp 1: the continued
    losses match a dp 1 run from the start (reduction order only), and the
    manifest records the dp it was saved under."""
    root = str(tmp_path / "pe")
    total, cut = 12, 8
    (golden,) = ranks.spawn(1, "sc_elastic_pe", {"root": str(tmp_path / "golden"),
                                                 "steps": total, "every": 0}, tmp_path / "g")
    two = ranks.spawn(2, "sc_elastic_pe", {"root": root, "steps": cut, "every": 4},
                      tmp_path / "dp2")
    assert [r["dp"] for r in two] == [2, 2]
    assert async_ckpt.latest_valid_elastic(root)[0] == cut
    (one,) = ranks.spawn(1, "sc_elastic_pe", {"root": root, "steps": total, "every": 0},
                         tmp_path / "dp1")
    assert one["dp"] == 1 and one["resumed"] == cut
    assert sorted(one["steps"]) == list(range(cut, total))
    for s in range(cut, total):
        np.testing.assert_allclose(float.fromhex(one["steps"][s]),
                                   float.fromhex(golden["steps"][s]), rtol=2e-5, atol=1e-7,
                                   err_msg=str(s))
    with open(os.path.join(async_ckpt.latest_valid_elastic(root)[1], "MANIFEST.json")) as f:
        assert json.load(f)["topology"].get("dp") == 2
