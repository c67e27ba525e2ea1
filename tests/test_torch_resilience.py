"""The resilience slice of the port (paddle_tpu_torch.resilience checkpoint,
the executor's NaN step guard, distributed/rpc.py and master.py) against
the JAX package, on the CPU:

- manifest checkpoints written by either package load in the other bit for
  bit, a bf16 var included, and their files and manifests are byte-equal;
  the port's crash / torn / missing-file / GC cases of tests/test_resilience.py
  and resume_or_init;
- the executor's NaN guard on a small program: after a `nan_grad` step the
  state, the lr decay and the health counters are the JAX package's, and
  the poisoned step rolls back bit for bit (and check_nan_inf does not
  raise over it);
- RPC frames of serialize_var are byte-equal to the JAX package's for f32,
  int64 and bf16, and each read_frame reads the other's; rpc_drop retried,
  a hung server a typed deadline, a send never resent;
- the Master's corrupt-snapshot, snapshot-crash, dropped-reply and
  hung-server cases; a worker killed holding a task, its task re-queued and
  a replacement process resumed from the manifest checkpoint.
"""

import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as fluid
from paddle_tpu import resilience as jres
from paddle_tpu.distributed import rpc as jrpc
from paddle_tpu.resilience import checkpoint as jckpt
from paddle_tpu_torch import convert, resilience
from paddle_tpu_torch.distributed import rpc
from paddle_tpu_torch.distributed.master import Master, MasterClient
from paddle_tpu_torch.distributed.rpc import (
    GET_VAR, SEND_VAR, NonIdempotentError, RPCClient, RPCServer, serialize_var,
)
from paddle_tpu_torch.reader import creator
from paddle_tpu_torch.resilience import DeadlineExceeded, checkpoint as ckpt, faults, health

jax.config.update("jax_platforms", "cpu")

HERE = os.path.dirname(os.path.abspath(__file__))
CPU = fluid.CPUPlace()


@pytest.fixture(autouse=True)
def _clean_resilience():
    """Fault plans and health counters are process-wide, in both packages."""
    for mod in (faults, jres.faults):
        mod.install(None)
    health.reset()
    jres.health.reset()
    yield
    for mod in (faults, jres.faults):
        mod.install(None)
    health.reset()
    jres.health.reset()


@pytest.fixture
def restore_flags():
    names = ["resilience_nan_guard", "resilience_lr_decay", "rpc_op_deadline",
             "rpc_max_retry", "rpc_deadline", "check_nan_inf"]
    saved, jsaved = fluid.get_flags(names), jfluid.get_flags(names)
    yield
    fluid.set_flags(saved)
    jfluid.set_flags(jsaved)


def _arrays(step):
    rng = np.random.RandomState(step)
    return {
        "fc_0.w_0": rng.randn(4, 3).astype(np.float32),
        "fc_0.b_0": rng.randn(3).astype(np.float32),
        "learning_rate_0": np.asarray(0.1, np.float32),
    }


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy() if v.dtype == torch.bfloat16 else v.cpu().numpy()
    return np.asarray(v, dtype=np.float32) if "bfloat16" in str(np.asarray(v).dtype) \
        else np.asarray(v)


# ---------------------------------------------------------------------------
# manifest checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_and_gc(tmp_path):
    root = str(tmp_path)
    for step in (1, 2, 3, 4, 5):
        d = ckpt.save_checkpoint(root, _arrays(step), step, keep_last=2)
        assert ckpt.verify_checkpoint(d)
    kept = sorted(n for n in os.listdir(root) if n.startswith("ckpt-"))
    assert kept == ["ckpt-00000004", "ckpt-00000005"]
    step, arrays = ckpt.load_latest_valid(root)
    assert step == 5
    np.testing.assert_array_equal(_np(arrays["fc_0.w_0"]), _arrays(5)["fc_0.w_0"])


def test_checkpoint_crash_before_manifest_is_skipped(tmp_path):
    root = str(tmp_path)
    ckpt.save_checkpoint(root, _arrays(1), 1)
    faults.install("ckpt_crash:step=1")
    with pytest.raises(faults.InjectedFault):
        ckpt.save_checkpoint(root, _arrays(2), 2)
    faults.install(None)
    assert os.path.isdir(os.path.join(root, "ckpt-00000002"))
    assert not os.path.exists(os.path.join(root, "ckpt-00000002", ckpt.MANIFEST))
    with pytest.warns(UserWarning, match="torn checkpoint"):
        step, _arr = ckpt.load_latest_valid(root)
    assert step == 1
    assert health.get("ckpt_skipped_invalid") >= 1
    ckpt.save_checkpoint(root, _arrays(2), 2)
    assert ckpt.load_latest_valid(root)[0] == 2


def test_checkpoint_crash_before_manifest_commit(tmp_path):
    root = str(tmp_path)
    ckpt.save_checkpoint(root, _arrays(3), 3)
    faults.install("manifest_crash:step=1")
    with pytest.raises(faults.InjectedFault):
        ckpt.save_checkpoint(root, _arrays(4), 4)
    faults.install(None)
    assert not ckpt.verify_checkpoint(os.path.join(root, "ckpt-00000004"))
    with pytest.warns(UserWarning):
        assert ckpt.load_latest_valid(root)[0] == 3


def test_checkpoint_torn_payload_and_missing_file(tmp_path):
    root = str(tmp_path)
    ckpt.save_checkpoint(root, _arrays(1), 1)
    d2 = ckpt.save_checkpoint(root, _arrays(2), 2)
    target = os.path.join(d2, "fc_0.w_0.npy")
    with open(target, "r+b") as f:
        f.truncate(os.path.getsize(target) // 2)
    with pytest.warns(UserWarning, match="torn checkpoint"):
        step, _arr = ckpt.load_latest_valid(root)
    assert step == 1
    d3 = ckpt.save_checkpoint(root, _arrays(3), 3)
    os.unlink(os.path.join(d3, "fc_0.b_0.npy.dtype"))
    assert not ckpt.verify_checkpoint(d3)
    with pytest.warns(UserWarning):
        assert ckpt.load_latest_valid(root)[0] == 1
    assert health.get("ckpt_skipped_invalid") >= 2
    assert ckpt.load_latest_valid(str(tmp_path / "nowhere")) is None


def _state_with_bf16(seed):
    a = _arrays(seed)
    a["moment_bf16"] = np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4)
    return a


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_manifest_checkpoint_cross_loads_bit_for_bit(tmp_path, writer):
    """Either package writes a manifest checkpoint (one var bf16); the other
    verifies and loads it bit for bit, and both writers' files and
    manifests are byte-equal."""
    import jax.numpy as jnp

    base = _state_with_bf16(7)
    jarrays = {n: (jnp.asarray(v, jnp.bfloat16) if n == "moment_bf16" else v)
               for n, v in base.items()}
    parrays = {n: (torch.from_numpy(v).to(torch.bfloat16) if n == "moment_bf16"
                   else torch.from_numpy(v)) for n, v in base.items()}
    dirs = {"jax": jckpt.save_checkpoint(str(tmp_path / "j"), jarrays, 4),
            "port": ckpt.save_checkpoint(str(tmp_path / "p"), parrays, 4)}
    for name in sorted(os.listdir(dirs["jax"])):
        with open(os.path.join(dirs["jax"], name), "rb") as f, \
                open(os.path.join(dirs["port"], name), "rb") as g:
            assert f.read() == g.read(), name
    reader = ckpt if writer == "jax" else jckpt
    root = os.path.dirname(dirs[writer])
    assert reader.verify_checkpoint(dirs[writer])
    step, got = reader.load_latest_valid(root)
    assert step == 4 and sorted(got) == sorted(base)
    for n, v in base.items():
        want = v if n != "moment_bf16" else _np(torch.from_numpy(v).to(torch.bfloat16))
        assert _np(got[n]).tobytes() == np.asarray(want, np.float32 if n == "moment_bf16"
                                                   else v.dtype).tobytes(), n
    assert "bfloat16" in str(got["moment_bf16"].dtype)


def _build_mlp(pkg, lr=0.1):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[8], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        h = pkg.layers.fc(input=x, size=16, act="relu")
        pred = pkg.layers.fc(input=h, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.SGD(learning_rate=lr).minimize(loss)
    return main, startup, loss


def _mlp_batch(step, bs=16):
    rng = np.random.RandomState(step)
    x = rng.randn(bs, 8).astype(np.float32)
    return {"x": x, "y": (np.abs(x).sum(axis=1, keepdims=True)).astype(np.float32)}


def test_resume_or_init(tmp_path):
    root = str(tmp_path)
    main, startup, loss = _build_mlp(fluid)
    scope = fluid.Scope(seed=1, place=CPU)
    with fluid.scope_guard(scope):
        exe = fluid.Executor(CPU)
        assert resilience.resume_or_init(exe, startup, root, scope=scope) == 0
        for s in range(3):
            exe.run(main, feed=_mlp_batch(s), fetch_list=[loss])
        snap = ckpt.snapshot_persistables(main, scope)
        assert snap and all("@" not in n for n in snap)
        ckpt.save_checkpoint(root, snap, step=3)
        # a snapshot is a copy: the next step leaves it as it was
        before = {n: v.copy() for n, v in snap.items()}
        exe.run(main, feed=_mlp_batch(3), fetch_list=[loss])
        for n, v in snap.items():
            assert v.tobytes() == before[n].tobytes(), n
    scope2 = fluid.Scope(seed=99, place=CPU)  # a different init: the restore must win
    with fluid.scope_guard(scope2):
        exe = fluid.Executor(CPU)
        assert resilience.resume_or_init(exe, startup, root, scope=scope2, program=main) == 3
        for name, arr in snap.items():
            assert isinstance(scope2.vars[name], torch.Tensor)
            np.testing.assert_array_equal(scope2.vars[name].numpy(), arr)
    assert health.get("resumed_from_checkpoint") == 1


# ---------------------------------------------------------------------------
# the executor's NaN step guard
# ---------------------------------------------------------------------------


def _guarded_run(pkg, init, names, nan_step=3, steps=6):
    """`steps` SGD steps of the MLP from `init` under the guard with
    nan_grad at `nan_step`: (losses, the final state, the lr before, the
    health counters)."""
    res = jres if pkg is jfluid else resilience
    pkg.set_flags({"resilience_nan_guard": True})
    main, startup, loss = _build_mlp(pkg)
    scope = pkg.Scope(seed=7) if pkg is jfluid else pkg.Scope(seed=7, place=CPU)
    losses = []
    with pkg.scope_guard(scope):
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup)
        if pkg is fluid:
            convert.load_into_scope(scope, init, names)
        else:
            for n in names:
                scope.set_var(n, jax.numpy.asarray(init[n]))
        lr_name = next(n for n in scope.var_names()
                       if n.rsplit("/", 1)[-1].startswith("learning_rate"))
        lr_before = float(_np(scope.vars[lr_name]).reshape(-1)[0])
        res.faults.install("nan_grad:step=%d" % nan_step)
        for s in range(steps):
            (lv,) = exe.run(main, feed=_mlp_batch(s), fetch_list=[loss])
            losses.append(float(np.asarray(lv).reshape(-1)[0]))
        res.faults.install(None)
        state = {n: _np(scope.vars[n]) for n in names}
        lr_after = float(_np(scope.vars[lr_name]).reshape(-1)[0])
    return losses, state, (lr_before, lr_after), res.health.snapshot()


def test_nan_guard_matches_the_jax_package(restore_flags):
    """A poisoned third step: NaN loss, the state rolled back, training
    continues finite; the state, the lr decay and the health counters equal
    the JAX package's after the same 6 steps from the same weights."""
    main, startup, _ = _build_mlp(fluid)
    names = convert.persistable_names(main)
    scope = fluid.Scope(seed=7, place=CPU)
    fluid.Executor(CPU).run(startup, scope=scope)
    init = {n: scope.vars[n].numpy().copy() for n in names}
    pl, ps, (plr0, plr1), ph = _guarded_run(fluid, init, names)
    jl, js, (jlr0, jlr1), jh = _guarded_run(jfluid, init, names)
    assert np.isnan(pl[2]) and np.isnan(jl[2])
    assert np.isfinite(pl[:2]).all() and np.isfinite(pl[3:]).all()
    np.testing.assert_allclose(np.delete(pl, 2), np.delete(jl, 2), rtol=1e-5)
    for n in names:
        assert np.isfinite(ps[n]).all(), n
        np.testing.assert_allclose(ps[n], js[n], rtol=1e-5, atol=1e-6, err_msg=n)
    decay = fluid.get_flags("resilience_lr_decay")["resilience_lr_decay"]
    assert plr1 == pytest.approx(plr0 * decay) and (plr0, plr1) == (jlr0, jlr1)
    assert ph == jh and ph["nan_steps_skipped"] == 1 and ph["lr_decays"] >= 1


def test_nan_guard_rolls_back_bit_for_bit(restore_flags):
    """The guarded step leaves every updated persistable at its pre-step
    bits; FLAGS_check_nan_inf does not raise over a step the guard handled,
    and the fetches still show the NaN."""
    fluid.set_flags({"resilience_nan_guard": True, "check_nan_inf": True})
    main, startup, loss = _build_mlp(fluid)
    scope = fluid.Scope(seed=3, place=CPU)
    with fluid.scope_guard(scope):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        exe.run(main, feed=_mlp_batch(0), fetch_list=[loss])
        names = [n for n in convert.persistable_names(main) if "learning_rate" not in n]
        before = {n: scope.vars[n].numpy().copy() for n in names}
        faults.install("nan_grad:step=1")
        (lv,) = exe.run(main, feed=_mlp_batch(1), fetch_list=[loss])
        faults.install(None)
        assert np.isnan(lv).all()
        for n in names:
            assert scope.vars[n].numpy().tobytes() == before[n].tobytes(), n
        # the next step trains from the rolled-back state
        (lv,) = exe.run(main, feed=_mlp_batch(2), fetch_list=[loss])
        assert np.isfinite(lv).all()
    assert health.get("nan_steps_skipped") == 1


# ---------------------------------------------------------------------------
# RPC
# ---------------------------------------------------------------------------


class _Pipe:
    """A socket-like reader over bytes (read_frame's recv_into)."""

    def __init__(self, data):
        self.data, self.pos = data, 0

    def recv_into(self, view, n):
        chunk = self.data[self.pos:self.pos + n]
        view[:len(chunk)] = chunk
        self.pos += len(chunk)
        return len(chunk)


@pytest.mark.parametrize("dtype", ["float32", "int64", "bfloat16"])
def test_rpc_frames_byte_equal_and_cross_read(dtype):
    import jax.numpy as jnp

    rng = np.random.RandomState(4)
    base = rng.randn(3, 5).astype(np.float32) * 7
    if dtype == "int64":
        jarr = parr = (base * 100).astype(np.int64)
    elif dtype == "bfloat16":
        jarr = np.asarray(jnp.asarray(base, jnp.bfloat16))
        parr = torch.from_numpy(base).to(torch.bfloat16)
    else:
        jarr = parr = base
    for kind in (jrpc.SEND_VAR, jrpc.VAR_REPLY):
        jframe = jrpc.serialize_var(kind, 3, "w@GRAD.block1", jarr)
        pframe = rpc.serialize_var(kind, 3, "w@GRAD.block1", parr)
        assert jframe == pframe
        k, tid, name, got = rpc.read_frame(_Pipe(jframe))
        assert (k, tid, name) == (kind, 3, "w@GRAD.block1")
        assert _np(got).tobytes() == _np(parr).tobytes()
        if dtype == "bfloat16":
            assert got.dtype == torch.bfloat16
        k, tid, name, jgot = jrpc.read_frame(_Pipe(pframe))
        assert str(jgot.dtype) == dtype and _np(jgot).tobytes() == _np(parr).tobytes()
    # var-less frames: the barriers and the "unknown var" reply
    for kind in (jrpc.SEND_BARRIER, jrpc.FETCH_BARRIER, jrpc.COMPLETE, jrpc.VAR_REPLY):
        assert jrpc.serialize_var(kind, 1, "") == rpc.serialize_var(kind, 1, "")


def _echo_server():
    srv = RPCServer("127.0.0.1:0", fanin=1)
    store = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    srv.on_get = lambda name, tid: store.get(name)
    srv.on_send = lambda name, arr, tid: None
    srv.start()
    return srv, store


def test_rpc_drop_retried_under_policy():
    srv, store = _echo_server()
    client = RPCClient(trainer_id=0)
    try:
        faults.install("rpc_drop:step=1")
        arr = client._rpc(srv.endpoint, serialize_var(GET_VAR, 0, "w"), True)
        faults.install(None)
        np.testing.assert_array_equal(arr, store["w"])
        assert health.get("rpc_retries") >= 1
        assert client.bytes_received == store["w"].nbytes
    finally:
        client.close()
        srv.stop()


def _hung_listener():
    hang = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    hang.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    hang.bind(("127.0.0.1", 0))
    hang.listen(4)
    conns = []

    def accept_loop():
        while True:
            try:
                conn, _ = hang.accept()
            except OSError:
                return
            conns.append(conn)  # accept, never reply

    threading.Thread(target=accept_loop, daemon=True).start()
    return hang, conns, "127.0.0.1:%d" % hang.getsockname()[1]


def test_rpc_hung_server_deadline(restore_flags):
    hang, conns, ep = _hung_listener()
    fluid.set_flags({"rpc_op_deadline": 0.3, "rpc_max_retry": 1, "rpc_deadline": 5.0})
    client = RPCClient(trainer_id=0)
    try:
        t0 = time.monotonic()
        with pytest.raises(DeadlineExceeded):
            client._rpc(ep, serialize_var(GET_VAR, 0, "w"), True)
        assert time.monotonic() - t0 < 4.0
        # a send's bytes may have arrived: typed non-idempotent, never resent
        with pytest.raises(NonIdempotentError):
            client._rpc(ep, serialize_var(SEND_VAR, 0, "w", np.zeros(2, np.float32)), False)
    finally:
        client.close()
        hang.close()
        for conn in conns:
            conn.close()


# ---------------------------------------------------------------------------
# the Master
# ---------------------------------------------------------------------------


def _write_task_dataset(td, n=48, per_chunk=8):
    rng = np.random.RandomState(0)
    w = np.abs(rng.randn(8, 1)).astype(np.float32)
    xs = rng.randn(n, 8).astype(np.float32)
    ys = np.abs(xs) @ w

    def reader():
        for i in range(n):
            yield xs[i], ys[i]

    path = os.path.join(td, "train.recordio")
    creator.convert_reader_to_recordio_file(path, reader, max_num_records=per_chunk)
    return path


def test_master_corrupt_snapshot_starts_fresh(tmp_path):
    snap = str(tmp_path / "master.snap")
    with open(snap, "w") as f:
        f.write('{"next_id": 4, "todo": [truncated')
    with pytest.warns(UserWarning, match="starting fresh"):
        m = Master(chunks_per_task=1, snapshot_path=snap)
    try:
        assert not m.todo and m._next_id == 0
        assert health.get("master_snapshot_corrupt") == 1
        m.set_dataset([_write_task_dataset(str(tmp_path))])
        assert len(m.todo) == 6  # partitioning works after the fresh start
    finally:
        m.close()


def test_master_snapshot_crash_keeps_committed_state(tmp_path):
    path = _write_task_dataset(str(tmp_path))
    snap = str(tmp_path / "master.snap")
    m = Master(chunks_per_task=1, snapshot_path=snap)
    m.set_dataset([path])
    m.close()
    faults.install("snapshot_crash")
    m2 = Master(chunks_per_task=1, snapshot_path=snap)
    try:
        with pytest.raises(faults.InjectedFault):
            m2._handle({"op": "get_task"})
    finally:
        m2.close()
        faults.install(None)
    m3 = Master(chunks_per_task=1, snapshot_path=snap)
    try:
        assert len(m3.todo) == 6 and not m3.pending  # the committed state
    finally:
        m3.close()


def test_master_client_survives_dropped_reply(tmp_path):
    m = Master(chunks_per_task=1, timeout_s=30.0).start()
    m.set_dataset([_write_task_dataset(str(tmp_path))])
    try:
        c = MasterClient(m.endpoint, timeout=10.0)
        faults.install("master_conn_drop:step=1")
        stats = c.stats()  # the first reply is lost; the retry lands
        faults.install(None)
        assert stats["todo"] == 6
        assert health.get("master_retries") >= 1
        c.close()
    finally:
        m.close()


def test_master_client_hung_server_deadline():
    hang, conns, ep = _hung_listener()
    try:
        c = MasterClient(ep, timeout=5.0, op_timeout=0.3, max_attempts=2)
        t0 = time.monotonic()
        with pytest.raises(DeadlineExceeded):
            c.stats()
        assert time.monotonic() - t0 < 4.0
        c.close()
    finally:
        hang.close()
        for conn in conns:
            conn.close()


def _spawn_worker(master_ep, ckpt_dir, faults_spec=""):
    env = dict(os.environ)
    env.pop(faults.ENV_VAR, None)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(HERE, ".."), env.get("PYTHONPATH", "")])
    cmd = [sys.executable, os.path.join(HERE, "torch_resilience_runner.py"),
           "--master", master_ep, "--ckpt_dir", ckpt_dir]
    if faults_spec:
        cmd += ["--faults", faults_spec]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env)


def test_worker_killed_and_recovered(tmp_path):
    """Worker 1 dies (worker_die) holding its third task; the master
    re-queues it after timeout_s, and a replacement process resumes from the
    latest manifest checkpoint and drains the dataset: nothing lost, nothing
    discarded."""
    path = _write_task_dataset(str(tmp_path), n=48, per_chunk=8)  # 6 tasks
    ckpt_dir = str(tmp_path / "ckpt")
    m = Master(chunks_per_task=1, timeout_s=2.0, failure_max=5,
               snapshot_path=str(tmp_path / "master.snap")).start()
    m.set_dataset([path])
    try:
        w1 = _spawn_worker(m.endpoint, ckpt_dir, "worker_die:step=3")
        out1, err1 = w1.communicate(timeout=180)
        assert w1.returncode == 3, (out1, err1)
        assert "DYING" in out1 and "RESUMED 0" in out1, out1
        assert ckpt.load_latest_valid(ckpt_dir)[0] == 2
        w2 = _spawn_worker(m.endpoint, ckpt_dir)
        out2, err2 = w2.communicate(timeout=180)
        assert w2.returncode == 0, (out2, err2)
        assert "RESUMED 2" in out2, out2
        fin = [ln for ln in out2.splitlines() if ln.startswith("FINISHED ")]
        assert fin and int(fin[0].split()[1]) == 6, out2
        c = MasterClient(m.endpoint)
        stats = c.stats()
        c.close()
        assert stats["done"] == 6 and stats["discarded"] == 0, stats
        h2 = json.loads([ln for ln in out2.splitlines()
                         if ln.startswith("HEALTH ")][0][len("HEALTH "):])
        assert h2.get("resumed_from_checkpoint") == 1, h2
    finally:
        m.close()


def test_frame_header_layout():
    """The documented header: u8 kind, i32 trainer id, u16 name length."""
    frame = serialize_var(GET_VAR, 7, "ab")
    assert frame[:5] == struct.pack("<Bi", GET_VAR, 7) and frame[5:9] == b"\x02\x00ab"
