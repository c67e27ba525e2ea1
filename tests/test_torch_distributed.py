"""The parameter server of the port (transpiler/distribute_transpiler.py,
ps_dispatcher.py, ops/dist_ops.py, distributed/listen_and_serv.py) against
the JAX package, on the CPU:

- the port's DistributeTranspiler emits the JAX one's trainer, pserver and
  startup programs (op types, inputs, outputs, attrs and vars, block by
  block) for the mlp, word2vec and a small DeepFM (Adam with bf16
  moments), in sync and async mode and with a pserver-side gradient
  merge; the collective mode leaves the program as the JAX one does;
- a 2-pserver x 2-trainer word2vec cluster (processes of
  paddle_tpu_torch.tools.pserver_cluster, from the JAX package's shared
  initialization) gives the JAX package's one-process losses at rtol 2e-3,
  atol 2e-4;
- the behaviour tests of tests/test_dist_subprocess.py and the cluster
  test of tests/test_resilience.py on the port: a dense cluster under a
  seeded rpc_drop completes and converges, an async cluster converges,
  checkpoint_notify mid gradient-merge window and a fresh cluster resumes
  the exact trajectory, the pserver-side merge matches its one-process
  schedule, and a small DeepFM under Adam (bf16 moments) matches its
  one-process form in losses and in the parameters the pservers save;
- ref_by_trainer_id against the JAX lowering, prefetch through a live
  pserver, gen_nccl_id and fake_init.
"""

import os
import threading

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.distributed.rpc import RPCClient
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.tools import pserver_cluster as pc

from torch_ports import endpoints

jax.config.update("jax_platforms", "cpu")

HERE = os.path.dirname(os.path.abspath(__file__))
CPU = fluid.CPUPlace()
EPS = "127.0.0.1:6174,127.0.0.1:6175"
SMALL_DEEPFM = dict(rows=512, fields=4, dim=8, batch=16, layer_sizes=(16,),
                    optimizer="adam", lr=1e-3, moment_dtype="bfloat16")


def _env():
    env = dict(os.environ)
    env.pop(faults.ENV_VAR, None)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(HERE, ".."), env.get("PYTHONPATH", "")])
    return env


def _cluster(n_pservers=2, **common):
    return pc.Cluster(endpoints(n_pservers), env=_env(), place="cpu", **common)


# ---------------------------------------------------------------------------
# the transpiled programs, against the JAX package's
# ---------------------------------------------------------------------------


def _program_form(prog):
    """Every block's vars (name, shape, dtype, persistable) and ops (type,
    inputs, outputs, attrs)."""
    out = []
    for blk in prog.blocks:
        vars_ = sorted((n, tuple(v.shape) if v.shape is not None else None, str(v.dtype),
                        bool(v.persistable)) for n, v in blk.vars.items())
        ops = [(op.type, op.inputs, op.outputs, op.attrs) for op in blk.ops]
        out.append((blk.idx, blk.parent_idx, vars_, ops))
    return out


def _transpiled(pkg, model, sync_mode, gm_k):
    lr = 1e-3 if model == "deepfm" else 0.1
    main, startup, _ = pc.build(pkg, model, lr, cfg=SMALL_DEEPFM)
    t = pc.transpiler(pkg, main, startup, EPS, 1, 2, sync_mode, gm_k)
    forms = {"trainer": _program_form(t.get_trainer_program())}
    for ep in EPS.split(","):
        ps = t.get_pserver_program(ep)
        forms["pserver " + ep] = _program_form(ps)
        forms["startup " + ep] = _program_form(t.get_startup_program(ep, ps))
    return forms


@pytest.mark.parametrize("mode", ["sync", "async", "gm2"])
@pytest.mark.parametrize("model", ["mlp", "word2vec", "deepfm"])
def test_transpiled_programs_equal_the_jax_package(model, mode):
    sync, gm_k = mode != "async", 2 if mode == "gm2" else 0
    got, want = _transpiled(fluid, model, sync, gm_k), _transpiled(jfluid, model, sync, gm_k)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], key
    types = [op[0] for op in got["trainer"][0][3]]
    assert ("send_barrier" in types) == sync and "send" in types and "recv" in types


def test_collective_mode_and_dispatchers():
    from paddle_tpu.transpiler import RoundRobin as JRoundRobin
    from paddle_tpu_torch.transpiler import (
        DistributeTranspiler, DistributeTranspilerConfig, HashName, RoundRobin,
    )

    main, startup, _ = pc.build(fluid, "mlp", 0.1)
    n_ops = len(main.global_block().ops)
    config = DistributeTranspilerConfig()
    config.mode = "collective"
    DistributeTranspiler(config).transpile(trainer_id=1, program=main, trainers=4,
                                           startup_program=startup)
    assert len(main.global_block().ops) == n_ops
    assert (main._num_trainers, main._trainer_id) == (4, 1)

    class V:
        def __init__(self, n):
            self.n = n

        def name(self):
            return self.n

    blocks = [V("b%d" % i) for i in range(5)]
    eps = EPS.split(",")
    assert RoundRobin(eps).dispatch(blocks) == JRoundRobin(eps).dispatch(blocks)
    assert HashName(eps).dispatch(blocks) == [eps[hash(b.name()) % 2] for b in blocks]


# ---------------------------------------------------------------------------
# clusters of processes
# ---------------------------------------------------------------------------


def test_dist_word2vec_cluster_matches_the_jax_package(tmp_path):
    """The [64, 8] shared table row-sliced across 2 pservers; the roles load
    the JAX package's seed-21 initialization (its io files), and the mean of
    the trainers' losses is the JAX package's one-process run on the
    concatenated batches."""
    from test_dist_subprocess import _make_init_dir, _single_process_losses

    steps = 8
    init_dir = _make_init_dir("word2vec", str(tmp_path / "init"))
    cluster = _cluster(model="word2vec", steps=steps, lr=0.2)
    try:
        res = cluster.run(pserver_args={"load_dir": init_dir},
                          trainer_args={"load_dir": init_dir})
    finally:
        cluster.cleanup()
    dist_mean = np.mean([r["losses"] for r in res], axis=0)
    single = _single_process_losses("word2vec", 0.2, 2, steps)
    assert np.isfinite(dist_mean).all() and np.ptp(dist_mean) > 0
    np.testing.assert_allclose(dist_mean, single, rtol=2e-3, atol=2e-4)
    for r in res:
        reading = r["readings"]
        assert reading["bytes_sent"] > 0 and reading["bytes_received"] > 0
        # one send op a gradient of the 5 parameters, one barrier a step
        assert reading["host_ops"]["send"][0] == steps * 5
        assert reading["host_ops"]["send_barrier"][0] == steps


def test_cluster_completes_under_seeded_rpc_drop():
    """2 trainers x 1 pserver with ~8% of RPC attempts dropped (seeded): the
    retries are invisible to the training math; the run converges and
    reports the retries it survived."""
    cluster = _cluster(n_pservers=1, model="mlp", steps=12)
    cluster.env[faults.ENV_VAR] = "rpc_drop:0.08@seed=7"
    try:
        res = cluster.run()
    finally:
        cluster.cleanup()
    for r in res:
        assert np.isfinite(r["losses"]).all()
        assert np.mean(r["losses"][-3:]) < np.mean(r["losses"][:3]) * 0.8, r["losses"]
    assert sum(r["health"].get("rpc_retries", 0) for r in res) >= 1


def test_async_cluster_converges():
    """Async mode: each gradient is applied as it arrives, on the pserver's
    RPC handler threads; no barriers."""
    cluster = _cluster(model="mlp", steps=12, sync_mode=0)
    try:
        res = cluster.run()
    finally:
        cluster.cleanup()
    for r in res:
        assert np.isfinite(r["losses"]).all()
        assert np.mean(r["losses"][-3:]) < np.mean(r["losses"][:3]) * 0.8, r["losses"]
        assert "send_barrier" not in r["readings"]["host_ops"]


def test_dist_save_load_resume_gradient_merge_midwindow(tmp_path):
    """checkpoint_notify lands mid gradient-merge window (5 rounds into
    gm_k=2); the accumulator and phase ride in the checkpoint under __gm_*
    names, and a fresh cluster restores them and continues the exact
    trajectory of an uninterrupted one."""
    ckpt = str(tmp_path / "ckpt")
    args = dict(model="mlp", lr=0.02)
    full = _cluster(steps=12, **args)
    try:
        full_losses = np.mean([r["losses"] for r in full.run(pserver_args={"gm_k": 2})],
                              axis=0)
    finally:
        full.cleanup()
    phase1 = _cluster(steps=5, **args)
    try:
        phase1.run(pserver_args={"gm_k": 2}, trainer_args={"save_dir": ckpt, "save_after": 5})
    finally:
        phase1.cleanup()
    assert any(f.startswith("__gm_") for f in os.listdir(ckpt))
    phase2 = _cluster(steps=7, **args)
    try:
        p2 = np.mean([r["losses"] for r in phase2.run(
            pserver_args={"gm_k": 2, "load_dir": ckpt},
            trainer_args={"start_step": 5, "load_dir": ckpt})], axis=0)
    finally:
        phase2.cleanup()
    np.testing.assert_allclose(p2, full_losses[5:], rtol=1e-3, atol=1e-6)


def test_dist_gradient_merge_pserver():
    """gm_k=2 accumulates two sync rounds on the pservers before each
    apply; parity with the one-process window schedule."""
    steps, gm_k = 8, 2
    init = pc.init_arrays(fluid, "mlp", 0.02, 2, CPU)
    import tempfile

    from paddle_tpu_torch import io

    with tempfile.TemporaryDirectory() as init_dir:
        io.save_arrays(init_dir, init)
        cluster = _cluster(model="mlp", steps=steps, lr=0.02)
        try:
            res = cluster.run(pserver_args={"gm_k": gm_k, "load_dir": init_dir},
                              trainer_args={"load_dir": init_dir})
        finally:
            cluster.cleanup()
    dist_mean = np.mean([r["losses"] for r in res], axis=0)
    single, _ = pc.local_losses(fluid, "mlp", 0.02, 2, steps, CPU, gm_k=gm_k,
                                init={n: v for n, v in init.items() if ".block" not in n})
    np.testing.assert_allclose(dist_mean, single, rtol=5e-3, atol=1e-5)
    assert dist_mean[-1] < dist_mean[0]


def test_dist_deepfm_adam_cluster_matches_its_one_process_form(tmp_path):
    """A small DeepFM (Adam, bf16 moments, dense tables row-sliced over 2
    pservers, training_fused on the trainers), at the card phase's bar
    (rtol 2e-3, atol 2e-4): the trainers' mean losses equal the one-process
    run on the concatenated batches that minimizes 2 x the loss with the
    beta pows frozen (the pservers' Adam), and the losses and the
    parameters the pservers write by checkpoint_notify equal the
    one-process run grouped as the pservers group (local_grouped)."""
    import json

    from paddle_tpu_torch import io

    cfg = dict(pc.deepfm_cfg(), rows=512, batch=32)
    steps = 6
    init = pc.init_arrays(fluid, "deepfm", cfg["lr"], 2, CPU, cfg=cfg)
    init_dir, ckpt_dir = str(tmp_path / "init"), str(tmp_path / "ckpt")
    io.save_arrays(init_dir, init)
    cluster = _cluster(model="deepfm", steps=steps, lr=cfg["lr"], pipeline="training_fused",
                       deepfm_cfg=json.dumps({"rows": 512, "batch": 32}))
    try:
        res = cluster.run(pserver_args={"load_dir": init_dir},
                          trainer_args={"load_dir": init_dir, "save_dir": ckpt_dir,
                                        "save_after": steps})
    finally:
        cluster.cleanup()
    full = {n: v for n, v in init.items() if ".block" not in n}
    dist = np.mean([r["losses"] for r in res], axis=0)
    concat, _ = pc.local_losses(fluid, "deepfm", cfg["lr"], 2, steps, CPU, init=full, cfg=cfg,
                                summed=True)
    np.testing.assert_allclose(dist, concat, rtol=2e-3, atol=2e-4)
    grouped, scope = pc.local_grouped(fluid, "deepfm", cfg["lr"], 2, steps, CPU, init=full,
                                      cfg=cfg)
    np.testing.assert_allclose(dist, grouped, rtol=2e-3, atol=2e-4)
    saved = io.load_arrays(ckpt_dir)
    for name in full:
        parts = sorted((int(k.rpartition(".block")[2]), v) for k, v in saved.items()
                       if k.rpartition(".block")[0] == name)
        got = torch.cat([v for _, v in parts]) if parts else saved[name]  # unsliced: whole
        np.testing.assert_allclose(got.numpy(), scope.vars[name].numpy(), rtol=2e-3, atol=2e-4,
                                   err_msg=name)
    for r in res:  # the trainers' three fc chains took the GEMM epilogue family
        assert r["readings"]["dispatches"]["gemm_epilogue"] == 3 * steps


# ---------------------------------------------------------------------------
# the other distributed ops
# ---------------------------------------------------------------------------


def test_ref_by_trainer_id_matches_the_jax_lowering():
    from paddle_tpu.ops import registry as jreg

    xs = [np.random.RandomState(i).randn(3, 2).astype(np.float32) for i in range(3)]
    for tid in (0, 2, 5, -1):
        t = np.asarray([tid], np.int64)
        want = jreg.get("ref_by_trainer_id").lower(
            None, {"X": [jax.numpy.asarray(x) for x in xs], "TrainerId": [jax.numpy.asarray(t)]},
            {})["Out"][0]
        ctx = registry.LowerCtx(torch.device("cpu"))
        got = registry.get("ref_by_trainer_id").lower(
            ctx, {"X": [torch.from_numpy(x) for x in xs], "TrainerId": [torch.from_numpy(t)]},
            {})["Out"][0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _run_host_op(prog_type, inputs, outputs, attrs, scope):
    prog = fluid.Program()
    blk = prog.global_block()
    for names in list(inputs.values()) + list(outputs.values()):
        for n in names:
            blk.create_var(name=n, shape=None, dtype="float32")
    blk.append_op(type=prog_type, inputs=inputs, outputs=outputs, attrs=attrs)
    fluid.Executor(CPU).run(prog, scope=scope)


def test_prefetch_through_a_live_pserver_and_the_noop_ops():
    """prefetch sends ids to a pserver holding the table and binds the
    rows it serves (a masked id < 0 gives a zero row); gen_nccl_id and
    fake_init bind their placeholders."""
    (ep,) = endpoints(1)
    table = torch.from_numpy(np.random.RandomState(2).randn(10, 3).astype(np.float32))
    ps_scope = fluid.Scope(seed=0, place=CPU)
    ps_scope.set_var("tbl", table)
    ps = fluid.Program()
    ps.global_block().append_op(type="listen_and_serv", inputs={}, outputs={}, attrs={
        "endpoint": ep, "sync_mode": False, "Fanin": 1, "optimize_blocks": [],
        "grad_to_block_id": [], "lr_decay_block_id": -1})
    server = threading.Thread(target=fluid.Executor(CPU).run, args=(ps,),
                              kwargs={"scope": ps_scope}, daemon=True)
    server.start()
    scope = fluid.Scope(seed=0, place=CPU)
    scope.set_var("ids", torch.tensor([3, -1, 9, 0], dtype=torch.int64))
    try:
        _run_host_op("prefetch", {"X": ["ids"]}, {"Out": ["rows"]},
                     {"epmap": [ep], "table_name": "tbl", "trainer_id": 0}, scope)
    finally:
        client = RPCClient._instance
        client.send_complete(ep)
        client.close()
        server.join(timeout=30)
    want = table[[3, 0, 9, 0]].clone()
    want[1] = 0
    assert torch.equal(scope.vars["rows"], want)
    assert not server.is_alive()
    _run_host_op("gen_nccl_id", {}, {"NCCLID": ["nccl_id"]}, {}, scope)
    _run_host_op("fake_init", {}, {"Out": ["w_remote"]}, {}, scope)
    assert scope.vars["nccl_id"].dtype == torch.int32 and scope.vars["w_remote"].shape == (1,)
