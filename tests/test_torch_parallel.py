"""The port's parallel slice against the JAX package on the CPU: the
ParallelExecutor at world 2 and 4 (gloo, spawned ranks, tests/
torch_parallel_ranks.py) from the JAX startup state carried over by name,
against the JAX Executor (the single-device program over the global batch)
and the JAX ParallelExecutor over as many virtual devices; the world-1
ParallelExecutor against the Executor bit for bit; ZeRO-1, ring attention,
the ep-sharded DeepFM, gradient merge, parallel_do, the mesh and the
collective wrappers.

Tolerances are the JAX PE tests': rtol 2e-3 / atol 2e-4 for the MLP,
rtol 5e-3 / atol 5e-4 for SE-ResNeXt, the Transformer and the full-mesh
model (float sums in another order across ranks); ring attention 1e-5;
the ep-sharded DeepFM atol 1e-6 against dense on one device."""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as fluid
import torch_parallel_ranks as R
import paddle_tpu.models.deepfm  # noqa: F401  (the submodules the builders reach)
import paddle_tpu.models.se_resnext  # noqa: F401
import paddle_tpu.models.transformer  # noqa: F401
from paddle_tpu import models as jmodels
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.executor import scope_guard as jscope_guard
from paddle_tpu_torch import convert
import paddle_tpu_torch.models.deepfm  # noqa: F401
import paddle_tpu_torch.models.se_resnext  # noqa: F401
import paddle_tpu_torch.models.transformer  # noqa: F401
from paddle_tpu_torch import models as pmodels
from paddle_tpu_torch.parallel import MeshConfig, make_mesh

_SPAWNED = {}


def _spawn(world, scenario, payload, tmp_path_factory, key=None):
    """R.spawn, once a worker for each (scenario, key)."""
    k = (scenario, world, key)
    if k not in _SPAWNED:
        _SPAWNED[k] = R.spawn(world, scenario, payload,
                              tmp_path_factory.mktemp("%s_%d" % (scenario, world)))
    return _SPAWNED[k]


def _jax_run(build, batches, devices=None, strategy=None, mesh_config=None):
    """(init arrays, losses) of a JAX build: the startup state by name, and
    the losses of the Executor (devices None) or of the ParallelExecutor
    over the first `devices` virtual devices."""
    main, startup, loss = build(jfluid)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = JScope(seed=3)
    losses = []
    with jscope_guard(scope):
        exe.run(startup)
        init = {n: np.asarray(scope.vars[n]).copy() for n in convert.persistable_names(main)}
        pe = None
        if devices is not None:
            pe = jfluid.ParallelExecutor(loss_name=loss.name, main_program=main,
                                         build_strategy=strategy, scope=scope,
                                         devices=jax.devices()[:devices],
                                         mesh_config=mesh_config)
        for feed in batches:
            if pe is not None:
                (val,) = pe.run(fetch_list=[loss.name], feed=feed)
            else:
                (val,) = exe.run(main, feed=feed, fetch_list=[loss.name])
            losses.append(float(np.asarray(val).reshape(-1)[0]))
    return init, losses


def _ranks_agree(results, key="losses"):
    for r in results[1:]:
        assert r[key] == results[0][key]


# ---------------------------------------------------------------------------
# ParallelExecutor at world 2
# ---------------------------------------------------------------------------


def test_pe_mlp_matches_jax_executor_and_pe(tmp_path_factory):
    batches = R.mlp_batches(20, 0)
    init, single = _jax_run(R.build_mlp, batches)
    _, jpe = _jax_run(R.build_mlp, batches, devices=2)
    res = _spawn(2, "sc_mlp", {"init": init}, tmp_path_factory)
    _ranks_agree(res)
    multi = res[0]["losses"]
    np.testing.assert_allclose(multi, single, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(multi, jpe, rtol=2e-3, atol=2e-4)
    assert multi[-1] < multi[0] * 0.9
    assert res[0]["device_count"] == 2
    assert res[0]["topology"]["dp"] == 2 and res[0]["topology"]["num_hosts"] == 2


def test_pe_rejects_indivisible_batch(tmp_path_factory):
    init, _ = _jax_run(R.build_mlp, [])
    res = _spawn(2, "sc_mlp", {"init": init}, tmp_path_factory)
    for r in res:
        assert r["indivisible"] is not None and "not divisible by device count 2" in \
            r["indivisible"]


def test_pe_zero1_matches_allreduce(tmp_path_factory):
    init, _ = _jax_run(lambda f: R.build_mlp(f, "adam"), [])
    res = _spawn(2, "sc_zero1", {"init": init}, tmp_path_factory)
    _ranks_agree(res, "zero1")
    r = res[0]
    np.testing.assert_allclose(r["zero1"], r["allreduce"], rtol=2e-3, atol=2e-4)
    assert r["zero1"][-1] < r["zero1"][0]
    # the fc weights' and biases' moments live as this rank's half; the
    # replicated run shards nothing
    assert r["allreduce_shards"] == {}
    assert r["zero1_shards"]["fc_0.w_0_moment1_acc_0"] == (8, 32)
    assert r["zero1_shards"]["fc_1.w_0_moment2_acc_0"] == (16, 4)
    assert len(r["zero1_shards"]) == 8
    _, jz1 = _jax_run(lambda f: R.build_mlp(f, "adam"), R.mlp_batches(6, 7), devices=2,
                      strategy=_jax_zero1())
    np.testing.assert_allclose(r["zero1"], jz1, rtol=2e-3, atol=2e-4)


def _jax_zero1():
    from paddle_tpu.parallel_executor import BuildStrategy, ReduceStrategy

    s = BuildStrategy()
    s.reduce_strategy = ReduceStrategy.Reduce
    return s


def test_pe_zero1_checkpoint_roundtrip(tmp_path_factory):
    """ZeRO-1 state saved whole through io.save_persistables and resharded
    by load_persistables into a fresh scope: steps 4-6 equal the
    uninterrupted run's."""
    init, _ = _jax_run(lambda f: R.build_mlp(f, "adam"), [])
    ckpt = str(tmp_path_factory.mktemp("z1ckpt"))
    res = _spawn(2, "sc_zero1_ckpt", {"init": init, "dir": ckpt}, tmp_path_factory)
    r = res[0]
    np.testing.assert_allclose(r["resumed"], r["full"], rtol=2e-3, atol=2e-4)
    assert "fc_0.w_0_moment1_acc_0.npy" in r["saved"]
    assert r["saved_shapes"]["fc_0.w_0_moment1_acc_0"] == (16, 32)


def test_pe_se_resnext_sync_batch_norm(tmp_path_factory):
    """Synchronized batch_norm: the statistics of the global batch, so the
    world-2 losses are the single device's (the JAX PE's SE-ResNeXt test)."""
    batches = R.se_resnext_batches()
    init, single = _jax_run(lambda f: R.build_se_resnext(f, jmodels), batches)
    res = _spawn(2, "sc_model", {"init": init, "model": "se_resnext"}, tmp_path_factory,
                 key="se_resnext")
    _ranks_agree(res)
    np.testing.assert_allclose(res[0]["losses"], single, rtol=5e-3, atol=5e-4)


def test_pe_transformer(tmp_path_factory):
    batches = R.transformer_batches()
    init, single = _jax_run(lambda f: R.build_transformer(f, jmodels), batches)
    res = _spawn(2, "sc_model", {"init": init, "model": "transformer"}, tmp_path_factory,
                 key="transformer")
    _ranks_agree(res)
    np.testing.assert_allclose(res[0]["losses"], single, rtol=5e-3, atol=5e-4)
    assert res[0]["losses"][-1] < res[0]["losses"][0]


@pytest.mark.parametrize("mesh", [{"dp": 2, "sp": 2}, {"dp": 1, "sp": 2, "ep": 2}],
                         ids=["dp2_sp2", "sp2_ep2"])
def test_full_mesh_matches_single_device(mesh, tmp_path_factory):
    """tests/test_parallel_pkg.py's model (a distributed_embedding, ring
    attention, fc layers) on 4 ranks against the JAX single-device run."""
    batches = R.full_mesh_batches()
    init, single = _jax_run(R.build_full_mesh, batches)
    res = _spawn(4, "sc_model", {"init": init, "model": "full_mesh", "mesh": mesh},
                 tmp_path_factory, key=tuple(sorted(mesh.items())))
    _ranks_agree(res)
    assert {a: n for a, n in res[0]["mesh"].items() if n > 1} == \
        {a: n for a, n in mesh.items() if n > 1}
    np.testing.assert_allclose(res[0]["losses"], single, rtol=5e-3, atol=5e-4)


# ---------------------------------------------------------------------------
# world 1: the Executor's block, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["mlp_adam", "se_resnext"])
def test_pe_world1_equals_executor_bit_for_bit(model):
    if model == "mlp_adam":
        build, batches = (lambda: R.build_mlp(fluid, "adam")), R.mlp_batches(4, 3)
    else:
        build, batches = (lambda: R.build_se_resnext(fluid, pmodels)), R.se_resnext_batches()
    main, startup, loss = build()
    scope = R.port_state(fluid, startup, None)
    init = convert.scope_to_numpy(scope, convert.persistable_names(main))
    exe = fluid.Executor(fluid.CPUPlace())
    ref = [exe.run(main, feed=f, fetch_list=[loss.name], scope=scope)[0] for f in batches]
    main, startup, loss = build()
    scope = R.port_state(fluid, startup, init)
    pe = fluid.ParallelExecutor(loss_name=loss.name, main_program=main, scope=scope)
    got = [pe.run(fetch_list=[loss.name], feed=f)[0] for f in batches]
    assert pe.device_count == 1
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_pe_runs_the_formerly_refused_layouts():
    """What raised before the sharding rules, the pipeline and the
    multi-step block came runs at world 1: BuildStrategy.sharding_rules, a
    legacy tp spec (parallel.shard_parameter) and MeshConfig's tp / fsdp /
    pp of 1 prune to nothing, and the block is the Executor's bit for bit;
    BuildStrategy.pipeline_stages > 1 asks for more devices than there
    are."""
    main, startup, loss = R.build_mlp(fluid)
    scope = R.port_state(fluid, startup, None)
    init = convert.scope_to_numpy(scope, convert.persistable_names(main))
    exe = fluid.Executor(fluid.CPUPlace())
    feeds = R.mlp_batches(3, 0)
    ref = [exe.run(main, feed=f, fetch_list=[loss.name], scope=scope)[0] for f in feeds]
    s = fluid.BuildStrategy()
    s.sharding_rules = [(".*w_0", (None, "tp")), ("fc_0.b_0", ("fsdp",))]
    for strategy, spec, mesh in ((s, None, None), (None, (None, "tp"), None),
                                 (None, None, MeshConfig(dp=1, tp=1, fsdp=1, pp=1))):
        main, startup, loss = R.build_mlp(fluid)
        if spec is not None:
            fluid.parallel.shard_parameter(main.global_block().var("fc_0.w_0"), spec)
        pe = fluid.ParallelExecutor(loss_name=loss.name, main_program=main,
                                    scope=R.port_state(fluid, startup, init),
                                    build_strategy=strategy, mesh_config=mesh)
        got = [pe.run(fetch_list=[loss.name], feed=f)[0] for f in feeds]
        assert not pe._stored
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    s = fluid.BuildStrategy()
    s.pipeline_stages = 2
    with pytest.raises(ValueError, match="not divisible"):
        fluid.ParallelExecutor(loss_name=loss.name, main_program=main, build_strategy=s,
                               scope=R.port_state(fluid, startup, init))


def test_pe_steps_per_run_equals_single_runs():
    """steps_per_run=k through the ParallelExecutor at world 1: the fetches
    stacked [k, ...], bit for bit k single runs; a feed list (per-device
    dicts) and k < 1 are refused."""
    feeds = R.mlp_batches(4, 1)
    got = {}
    for k in (1, 4):
        main, startup, loss = R.build_mlp(fluid, "adam")
        scope = R.port_state(fluid, startup, None)
        pe = fluid.ParallelExecutor(loss_name=loss.name, main_program=main, scope=scope)
        if k == 1:
            vals = np.stack([pe.run(fetch_list=[loss.name], feed=f)[0] for f in feeds])
        else:
            stacked = {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}
            (vals,) = pe.run(fetch_list=[loss.name], feed=stacked, steps_per_run=k)
            with pytest.raises(TypeError, match="steps_per_run"):
                pe.run(fetch_list=[loss.name], feed=feeds, steps_per_run=k)
            with pytest.raises(ValueError, match="steps_per_run"):
                pe.run(fetch_list=[loss.name], feed=feeds[0], steps_per_run=0)
        got[k] = (vals, {n: scope.vars[n].numpy().copy() for n in sorted(scope.vars)})
    assert got[4][0].shape[0] == 4
    np.testing.assert_array_equal(got[4][0].reshape(-1), got[1][0].reshape(-1))
    for n, v in got[1][1].items():
        np.testing.assert_array_equal(got[4][1][n], v)


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------


def _qkvdo(seed, b=2, h=2, t=16, d=8):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, t, d).astype("float32") for _ in range(4)]


def _jax_ring_plain(qkvdo, causal):
    from paddle_tpu.parallel.ring_attention import ring_attention

    q, k, v, do = (jax.numpy.asarray(a) for a in qkvdo)
    out, vjp = jax.vjp(lambda a, b, c: ring_attention(a, b, c, causal=causal), q, k, v)
    return [np.asarray(t) for t in (out,) + vjp(do)]


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_sharded_matches_plain(sp, tmp_path_factory):
    """Forward and grads of ring_attention_sharded at sp = 2 and 4, causal
    and not, against the port's plain form and the JAX package's."""
    qkvdo = _qkvdo(sp)
    res = _spawn(sp, "sc_ring", {"qkvdo": qkvdo}, tmp_path_factory)
    for causal in (False, True):
        jref = _jax_ring_plain(qkvdo, causal)
        for r in res:
            for got, ref, jr in zip(r[causal], r[("plain", causal)], jref):
                np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
                np.testing.assert_allclose(got, jr, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_chunks_match_whole_sequence(causal):
    """The per-step path over 4 chunks in one process against flash
    attention on the whole sequence (the chip's check, on the plain
    versions)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parallel.ring_attention import (ring_backward_chunks,
                                                          ring_forward_chunks)

    q, k, v, do = (torch.from_numpy(a) for a in _qkvdo(9, t=32))
    scale = q.shape[-1] ** -0.5
    out, lse = fa.flash_forward(q, k, v, causal, scale)
    dq, dk, dv = fa.flash_backward(q, k, v, out, lse, do, causal, scale)
    qs, ks, vs, dos = (list(x.chunk(4, dim=2)) for x in (q, k, v, do))
    fwd = ring_forward_chunks(qs, ks, vs, causal, scale)
    outs, lses = [o for o, _ in fwd], [s for _, s in fwd]
    np.testing.assert_allclose(torch.cat(outs, 2).numpy(), out.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(torch.cat(lses, 2).numpy(), lse.numpy(), rtol=1e-5, atol=1e-5)
    gq, gk, gv = ring_backward_chunks(qs, ks, vs, outs, lses, dos, causal, scale)
    for got, ref in ((gq, dq), (gk, dk), (gv, dv)):
        got = torch.cat(got, 2)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(ref.abs().max()))


def test_ring_attention_op_single_device_matches_jax():
    """The ring_attention op without an sp mesh: the plain attention and
    its grad, as the JAX lowering."""
    from paddle_tpu_torch.ops import registry as preg

    qkvdo = _qkvdo(5)
    for causal in (False, True):
        ins = {s: [torch.from_numpy(a)] for s, a in zip("QKV", qkvdo[:3])}
        ctx = preg.LowerCtx("cpu")
        out = preg.get("ring_attention").lower(ctx, ins, {"causal": causal})["Out"][0]
        g = preg.get("ring_attention_grad").lower(
            ctx, dict(ins, **{"Out": [out], "Out@GRAD": [torch.from_numpy(qkvdo[3])]}),
            {"causal": causal})
        jref = _jax_ring_plain(qkvdo, causal)
        got = [out] + [g[s + "@GRAD"][0] for s in "QKV"]
        for a, b in zip(got, jref):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the row-sharded embedding
# ---------------------------------------------------------------------------


def test_deepfm_distributed_matches_dense(tmp_path_factory):
    """use_distributed=True at ep = 2 (row-sharded tables, SelectedRows
    grads, per-shard updates) against dense DeepFM on one device
    (tests/test_deepfm.py:124-155), and the sharded save_sharded /
    load_sharded round trip."""
    batches = R.deepfm_batches()
    init, jdense = _jax_run(lambda f: R.build_deepfm(f, jmodels, False), batches)
    main, startup, loss = R.build_deepfm(fluid, pmodels, False)
    scope = R.port_state(fluid, startup, init)
    exe = fluid.Executor(fluid.CPUPlace())
    dense = [float(exe.run(main, feed=f, fetch_list=[loss.name], scope=scope)[0].reshape(-1)[0])
             for f in batches]
    ckpt = str(tmp_path_factory.mktemp("dfm_ckpt"))
    res = _spawn(2, "sc_deepfm", {"init": init, "dir": ckpt}, tmp_path_factory)
    _ranks_agree(res)
    np.testing.assert_allclose(res[0]["losses"], dense, rtol=0, atol=1e-6)
    np.testing.assert_allclose(res[0]["losses"], jdense, rtol=1e-5, atol=1e-6)
    for n in ("fm_emb", "fm_first"):
        np.testing.assert_allclose(res[0]["tables"][n], scope.vars[n].numpy(), rtol=0, atol=1e-6)
    assert res[0]["shard_rows"] == {"fm_emb": 256, "fm_first": 256}
    assert res[0]["tables"]["roundtrip_equal"] and res[1]["tables"]["roundtrip_equal"]
    assert res[0]["tables"]["manifest_shards"] == 2


def test_deepfm_distributed_at_ep1_equals_dense_bit_for_bit():
    """With no ep axis the distributed lookup and its sparse update are the
    single-device ones: use_distributed=True equals the sparse local build
    bit for bit (the chip's 2^20 x 32 check, at a small size)."""
    batches = R.deepfm_batches(3)
    losses = {}
    for dist_ in (False, True):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            ids = fluid.layers.data(name="ids", shape=[R.DFM_FIELDS, 1], dtype="int64")
            label = fluid.layers.data(name="label", shape=[1], dtype="float32")
            loss = pmodels.deepfm.deepfm(ids, label, num_features=R.DFM_ROWS,
                                         num_fields=R.DFM_FIELDS, embedding_size=R.DFM_DIM,
                                         layer_sizes=(16,), is_sparse=True,
                                         use_distributed=dist_)[0]
            fluid.optimizer.Adam(learning_rate=1e-2).minimize(loss)
        scope = R.port_state(fluid, startup, None)
        pe = fluid.ParallelExecutor(loss_name=loss.name, main_program=main, scope=scope)
        losses[dist_] = [pe.run([loss.name], feed=f)[0] for f in batches] + [
            scope.vars["fm_emb"].numpy().copy()]
    for a, b in zip(losses[True], losses[False]):
        np.testing.assert_array_equal(a, b)


def test_embedding_engine_checkpoint_roundtrip(tmp_path):
    """save_sharded writes the table and its Adam moments as row-range
    shards with the JAX package's manifest; load_sharded reassembles them
    exactly."""
    from paddle_tpu_torch.embedding import EmbeddingEngine

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[4, 1], dtype="int64")
        eng = EmbeddingEngine("ck_tbl", 64, 8, is_sparse=True)
        loss = fluid.layers.mean(eng.lookup(ids))
        fluid.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    scope = R.port_state(fluid, startup, None)
    exe = fluid.Executor(fluid.CPUPlace())
    rng = np.random.RandomState(0)
    for _ in range(3):
        exe.run(main, feed={"ids": rng.randint(0, 64, (16, 4, 1)).astype("int64")},
                fetch_list=[loss.name], scope=scope)
    names = eng.state_var_names(main)
    assert eng.table.name in names and len(names) == 3, names
    saved = {n: scope.vars[n].clone() for n in names}
    manifest = eng.save_sharded(scope, str(tmp_path), num_shards=4, program=main)
    assert manifest["num_shards"] == 4 and manifest["row_ranges"][0] == [0, 16]
    assert set(manifest["arrays"].values()) == {"float32"}
    for n in names:
        scope.vars[n] = torch.zeros_like(saved[n])
    eng.load_sharded(scope, str(tmp_path))
    for n in names:
        assert torch.equal(scope.vars[n], saved[n]), n
    # the row layout is the program's sharding rule (as in the JAX
    # package), over the table and its accumulators
    rules = main._sharding_rules
    assert all(rules.match(n) == ("ep", None) for n in names)
    assert fluid.embedding.engines_of(main) == [eng]


# ---------------------------------------------------------------------------
# gradient merge, parallel_do
# ---------------------------------------------------------------------------


def _gm_build(pkg, merge_k=None, optimizer="sgd", lr_scale=None):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="gm_x", shape=[4], dtype="float32")
        y = pkg.layers.data(name="gm_y", shape=[1], dtype="float32")
        attr = pkg.ParamAttr(learning_rate=lr_scale) if lr_scale else None
        pred = pkg.layers.fc(input=x, size=1, param_attr=attr)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(input=pred, label=y))
        opt = pkg.optimizer.Adam(learning_rate=0.1) if optimizer == "adam" else \
            pkg.optimizer.SGD(learning_rate=0.1)
        opt.minimize(loss)
    if merge_k:
        pkg.transpiler.gradient_merge_transpile(main, startup, merge_k)
    return main, startup, loss


@pytest.mark.parametrize("case", ["big_batch", "per_param_lr", "adam_beta_pow"])
def test_gradient_merge(case):
    """The JAX package's TestGradientMerge cases on the port: k = 2
    merged micro-batches update like one step on both (SGD and Adam, the
    beta pows advancing on the apply step only), and a per-param lr scale
    runs before the conditional apply; the merged weights equal the JAX
    package's."""
    rng = np.random.RandomState(11)
    xs, ys = rng.rand(8, 4).astype("float32"), rng.rand(8, 1).astype("float32")
    opt = "adam" if case == "adam_beta_pow" else "sgd"
    k = 1 if case == "per_param_lr" else 2
    lr_scale = 2.0 if case == "per_param_lr" else None

    def merged(pkg, exe, scope, guard):
        main, startup, _ = _gm_build(pkg, merge_k=k, optimizer=opt, lr_scale=lr_scale)
        with guard(scope):
            exe.run(startup)
            w0 = np.asarray(scope.find_var("fc_0.w_0")).copy()
            mids = []
            for i in range(k):
                exe.run(main, feed={"gm_x": xs[i * 4:(i + 1) * 4] if k > 1 else xs[:4],
                                    "gm_y": ys[i * 4:(i + 1) * 4] if k > 1 else ys[:4]},
                        fetch_list=[])
                mids.append(np.asarray(scope.find_var("fc_0.w_0")).copy())
        return w0, mids

    w0, mids = merged(fluid, fluid.Executor(fluid.CPUPlace()),
                      fluid.Scope(seed=1, place=fluid.CPUPlace()), fluid.scope_guard)
    jw0, jmids = merged(jfluid, jfluid.Executor(jfluid.CPUPlace()), JScope(seed=1),
                        jscope_guard)
    # the JAX startup draws other numbers: carry its weights over for the
    # parity leg below, and hold each package to its own contract here
    assert not np.allclose(mids[-1], w0)
    if k == 2:
        np.testing.assert_array_equal(mids[0], w0)  # micro-batch 1 applies nothing
        main, startup, loss = _gm_build(fluid, optimizer=opt)
        scope = fluid.Scope(seed=1, place=fluid.CPUPlace())
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(scope):
            exe.run(startup)
            np.testing.assert_array_equal(scope.find_var("fc_0.w_0").numpy(), w0)
            exe.run(main, feed={"gm_x": xs, "gm_y": ys}, fetch_list=[])
            big = scope.find_var("fc_0.w_0").numpy()
        np.testing.assert_allclose(mids[-1], big, rtol=1e-4, atol=1e-6)
    # parity: the JAX merged update from the JAX start, the port's from the same
    main, startup, _ = _gm_build(fluid, merge_k=k, optimizer=opt, lr_scale=lr_scale)
    jmain, jstartup, _ = _gm_build(jfluid, merge_k=k, optimizer=opt, lr_scale=lr_scale)
    jscope = JScope(seed=1)
    with jscope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(jstartup)
        init = {n: np.asarray(jscope.vars[n]).copy() for n in convert.persistable_names(jmain)}
    scope = R.port_state(fluid, startup, init)
    exe = fluid.Executor(fluid.CPUPlace())
    for i in range(k):
        exe.run(main, feed={"gm_x": xs[i * 4:(i + 1) * 4], "gm_y": ys[i * 4:(i + 1) * 4]},
                fetch_list=[], scope=scope)
    np.testing.assert_allclose(scope.vars["fc_0.w_0"].numpy(), jmids[-1], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(init["fc_0.w_0"], jw0)


def test_parallel_do_runs_sub_block_once():
    """parallel_do lowers to one run of its sub-block over the rank's rows
    (the JAX package's TestParallelDo program)."""
    from paddle_tpu_torch import framework

    main = framework.Program()
    blk = main.global_block()
    x = np.random.RandomState(0).rand(6, 4).astype("float32")
    blk.create_var(name="pd_x", shape=x.shape, dtype="float32")
    blk.create_var(name="pd_out", shape=None, dtype=None)
    sub = main._create_block()
    sub.create_var(name="pd_x_inner", shape=[6, 4], dtype="float32")
    sub.create_var(name="pd_out_inner", shape=None, dtype=None)
    sub.append_op(type="scale", inputs={"X": ["pd_x_inner"]}, outputs={"Out": ["pd_out_inner"]},
                  attrs={"scale": 3.0})
    main._rollback()
    blk.append_op(type="parallel_do", inputs={"X": ["pd_x"]}, outputs={"Out": ["pd_out"]},
                  attrs={"sub_block": sub, "x_names": ["pd_x_inner"],
                         "out_names": ["pd_out_inner"]})
    exe = fluid.Executor(fluid.CPUPlace())
    (out,) = exe.run(main, feed={"pd_x": x}, fetch_list=["pd_out"],
                     scope=fluid.Scope(place=fluid.CPUPlace()))
    np.testing.assert_allclose(out, x * 3.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# the mesh and the collectives
# ---------------------------------------------------------------------------


def test_mesh_config_resolution():
    from paddle_tpu.parallel.mesh import MeshConfig as JMeshConfig

    for kw, n in [({}, 8), ({"dp": 2, "sp": -1}, 8), ({"dp": -1, "ep": 4}, 8),
                  ({"dp": 2, "sp": 2, "ep": 2}, 8), ({"dp": 1}, 1)]:
        assert MeshConfig(**kw).resolve(n) == JMeshConfig(**kw).resolve(n)
    for kw, n in [({"dp": -1, "sp": -1}, 4), ({"dp": 3}, 4), ({"sp": 3}, 8)]:
        with pytest.raises(ValueError):
            MeshConfig(**kw).resolve(n)
        with pytest.raises(ValueError):
            JMeshConfig(**kw).resolve(n)
    mesh = make_mesh(MeshConfig(), device="cpu")
    assert mesh.shape == {"dp": 1, "fsdp": 1, "tp": 1, "sp": 1, "ep": 1, "pp": 1}
    assert mesh.device_mesh is None and mesh.group("dp") is None and mesh.index("sp") == 0
    # fsdp, tp and pp take any extent the devices allow; on one device an
    # extent of 2 is refused as any axis's is
    for axis in ("fsdp", "tp", "pp"):
        with pytest.raises(ValueError, match="needs 2 devices"):
            make_mesh(MeshConfig(dp=1, **{axis: 2}), device="cpu")
        assert make_mesh(MeshConfig(dp=1, **{axis: 1}), device="cpu").axis_size(axis) == 1


def test_collective_wrappers(tmp_path_factory):
    """all_reduce / all_gather / reduce_scatter / ppermute_shift / broadcast
    over each axis of a dp=2 x sp=2 mesh (rank = dp index * 2 + sp index)."""
    res = _spawn(4, "sc_collectives", {}, tmp_path_factory)
    x = [np.arange(4, dtype="float32").reshape(4, 1) + 10 * r for r in range(4)]
    for r, got in enumerate(res):
        dp, sp = divmod(r, 2)
        assert got["coords"] == (dp, sp, 2, 2)
        peers_dp = [x[sp], x[2 + sp]]
        peers_sp = [x[2 * dp], x[2 * dp + 1]]
        np.testing.assert_array_equal(got["sum_dp"], peers_dp[0] + peers_dp[1])
        np.testing.assert_array_equal(got["max_sp"], np.maximum(*peers_sp))
        np.testing.assert_array_equal(got["mean_dp"], (peers_dp[0] + peers_dp[1]) / 2)
        np.testing.assert_array_equal(got["gather_sp"], np.concatenate(peers_sp, 0))
        np.testing.assert_array_equal(got["gather_sp_1"], np.concatenate(peers_sp, 1))
        np.testing.assert_array_equal(got["stack_dp"], np.stack(peers_dp))
        np.testing.assert_array_equal(got["scatter_dp"],
                                      (peers_dp[0] + peers_dp[1])[2 * dp:2 * dp + 2])
        np.testing.assert_array_equal(got["shift_sp"], peers_sp[(sp - 1) % 2])
        np.testing.assert_array_equal(got["bcast_dp"], peers_dp[1])
