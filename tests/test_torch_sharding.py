"""The port's sharding rules (paddle_tpu_torch/parallel/sharding_rules.py)
against the JAX package's on the CPU: the rule engine and the Resolver on
every rule case of tests/test_sharding_rules.py; Megatron tp and FSDP at
world 4 (gloo, spawned ranks, tests/torch_parallel_ranks.py) against the
JAX single-device Executor on the same weights, loss for loss, with the
placed parameters and their moments stored as 1/extent pieces; the FSDP
checkpoint across a change of topology; the fused families' decline; the
embedding engine's ep rule; the small flash Transformer at dp2 x tp2 with
its local head count reaching flash_attention.

Tolerance: the JAX tests' rtol 2e-3 / atol 2e-4 (float sums in another
order across ranks)."""

import re

import jax
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu.models.transformer  # noqa: F401
import paddle_tpu_torch.fluid as fluid
import paddle_tpu_torch.models.transformer  # noqa: F401
import torch_parallel_ranks as R
from paddle_tpu import models as jmodels
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.executor import scope_guard as jscope_guard
from paddle_tpu.parallel import sharding_rules as J
from paddle_tpu_torch import convert
from paddle_tpu_torch.parallel import sharding_rules as P
from paddle_tpu_torch.parallel.mesh import AXES, Mesh

_RTOL, _ATOL = 2e-3, 2e-4
_SPAWNED = {}

# fc params: fc_0.w_0 (16, 32), fc_0.b_0 (32,), fc_1.w_0 (32, 4), fc_1.b_0 (4,)
_TP_RULES = [
    (r"^fc_0\.w_0$", (None, "tp")),
    (r"^fc_0\.b_0$", ("tp",)),
    (r"^fc_1\.w_0$", ("tp", None)),
]
_FSDP_RULES = [(r"^fc_\d+\.(w|b)_0$", ("fsdp",))]


def _spawn(world, scenario, payload, tmp_path_factory, key):
    k = (scenario, key)
    if k not in _SPAWNED:
        _SPAWNED[k] = R.spawn(world, scenario, payload,
                              tmp_path_factory.mktemp("%s_%s" % (scenario, key)))
    return _SPAWNED[k]


def _port_mesh(**kw):
    """A mesh of these extents as the Resolver sees it (its shape)."""
    sizes = {a: 1 for a in AXES}
    sizes.update(kw)
    return Mesh(sizes, {}, {}, "cpu")


def _jax_mesh(**kw):
    from paddle_tpu.parallel import MeshConfig, make_mesh

    return make_mesh(MeshConfig(**kw))


def _jax_losses(build, batches):
    """(init arrays, losses) of the JAX Executor on one device: the single
    device program over the global batch."""
    main, startup, loss = build(jfluid)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = JScope(seed=3)
    out = []
    with jscope_guard(scope):
        exe.run(startup)
        init = {n: np.asarray(scope.vars[n]).copy() for n in convert.persistable_names(main)}
        for feed in batches:
            (val,) = exe.run(main, feed=feed, fetch_list=[loss.name])
            out.append(float(np.asarray(val).reshape(-1)[0]))
    return init, out


def _mlp_adam(f):
    return R.build_mlp(f, "adam")


def _agree(results):
    for r in results[1:]:
        assert r["losses"] == results[0]["losses"]


# ---------------------------------------------------------------------------
# the rule engine and the Resolver against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["fc_0.w_0", "fc_1.w_0", "fc_0.b_0", "fc_2.w_0", "x"])
def test_rules_last_match_wins_as_jax(name):
    rules = [(r"\.w_0$", ("fsdp", None)), (r"^fc_1\.w_0$", ("tp", None)),
             (r"^fc_2\.w_0$", None)]
    assert P.ShardingRules(rules).match(name) == J.ShardingRules(rules).match(name)


@pytest.mark.parametrize("name", ["emb_table", "emb_table_moment1_acc_0", "emb_table@GRAD",
                                  "other"])
def test_rules_unanchored_cover_derived_names_as_jax(name):
    rules = [("emb_table", ("ep", None))]
    assert P.ShardingRules(rules).match(name) == J.ShardingRules(rules).match(name)


@pytest.mark.parametrize("spec", [("dp2",), ("model",), (("tp", "tp"), None)])
def test_rules_bad_axis_raises_as_jax(spec):
    with pytest.raises(ValueError):
        J.ShardingRules([("w", spec)])
    with pytest.raises(ValueError):
        P.ShardingRules([("w", spec)])


@pytest.mark.parametrize("name,shape", [("a", (8, 8)), ("b", (3, 8)), ("b", (8, 8)),
                                        ("c", (4,)), ("d", ()), ("z", (8, 8)),
                                        ("e", (8, 6)), ("e", (8, 8))])
def test_resolver_pruning_as_jax(name, shape):
    """tests/test_sharding_rules.py::test_resolver_pruning's mesh (dp2 x tp2
    x sp2) and rules, plus a combined (tp, sp) dim: pruning, degrading,
    rank mismatch and scalars resolve as in the JAX Resolver."""
    rules = [("a", ("fsdp", "tp")), ("b", ("tp", None)), ("c", ("tp", "dp")), ("d", ("tp",)),
             ("e", (None, ("tp", "sp")))]
    jr = J.Resolver(_jax_mesh(dp=2, tp=2, sp=2), rules=J.ShardingRules(rules))
    pr = P.Resolver(_port_mesh(dp=2, tp=2, sp=2), rules=P.ShardingRules(rules))
    assert pr.rule_spec(name, shape) == jr.rule_spec(name, shape)
    assert pr.spec(name, shape) == jr.spec(name, shape)
    assert pr.degraded == jr.degraded


def test_resolver_aliases_zero1_and_legacy_attr_as_jax():
    """Accumulators resolve through their parameter (the alias layer), the
    legacy sharding_spec attribute sits under the rules, the ZeRO-1 tier
    under both; the dead-rule audit names the same patterns."""
    def build(f):
        main, startup, loss = R.build_mlp(f, "adam")
        return main

    rules = [(r"^fc_0\.w_0$", (None, "tp")), (r"^nothing$", ("tp",))]
    jmain, pmain = build(jfluid), build(fluid)
    for main, mod in ((jmain, jfluid), (pmain, fluid)):
        mod.parallel.shard_parameter(main.global_block().var("fc_1.w_0"), ("tp", None))
    out = []
    for main, mod, mesh in ((jmain, J, _jax_mesh(dp=4, tp=2)),
                            (pmain, P, _port_mesh(dp=4, tp=2))):
        blk = main.global_block()
        res = mod.Resolver(mesh, rules=mod.ShardingRules(rules),
                           var_lookup=lambda n, b=blk: b._var_recursive(n)
                           if b.has_var_recursive(n) else None)
        res.add_aliases(blk.ops)
        res.set_zero1("dp", ["fc_1.b_0"])
        names = sorted(blk.vars)
        out.append(({n: res.spec(n, tuple(blk.var(n).shape)) for n in names
                     if blk.var(n).shape is not None and -1 not in blk.var(n).shape},
                    sorted(res.aliases.items()), res.audit(names)))
    assert out[0] == out[1]
    specs = out[1][0]
    assert specs["fc_0.w_0"] == (None, "tp") and specs["fc_1.w_0"] == ("tp", None)
    assert specs["fc_1.b_0"] == ("dp",)
    assert [specs[n] for n in specs if n.startswith("fc_0.w_0_moment")] == [(None, "tp")] * 2


def test_spec_layout_and_transformer_rules_as_jax():
    for mod in (J, P):
        layout = mod.SpecLayout()
        rules = layout.transformer_rules(column=[r"_up\.w$"], row=[r"_down\.w$"],
                                         vector=[r"\.b$"], embedding=[r"^embed"])
        assert rules.match("blk0_up.w") == ("fsdp", "tp")
        assert rules.match("blk0_down.w") == ("tp", "fsdp")
        assert rules.match("blk0_up.b") == ("fsdp",)
        assert rules.match("embed_table") == (("fsdp", "tp"), None)
    assert (P.SpecLayout().transformer_rules(column=["q"]).fingerprint()
            == J.SpecLayout().transformer_rules(column=["q"]).fingerprint())
    main = fluid.Program()
    assert P.program_rules(main) is P.program_rules(main) and len(P.program_rules(main)) == 0


def test_fused_families_decline_where_jax_declines():
    """ops/fused._rules_sharded against pallas_kernels._rules_sharded on
    every op of the fused MLP program, over the tp and fsdp rules at meshes
    where they place and where they prune away."""
    from paddle_tpu.ops import pallas_kernels as pk
    from paddle_tpu_torch.ops import fused

    main, _, _ = R.build_mlp(fluid, "adam")
    ops = main.global_block().ops

    class Ctx:
        pass

    for rules, axis in ((_TP_RULES, "tp"), (_FSDP_RULES, "fsdp")):
        for kw in ({"dp": 4, "tp": 2}, {"dp": 2, "fsdp": 4}, {"dp": 8}):
            jc, pc = Ctx(), Ctx()
            jc.sharding = J.Resolver(_jax_mesh(**kw), rules=J.ShardingRules(rules))
            pc.sharding = P.Resolver(_port_mesh(**kw), rules=P.ShardingRules(rules))
            got = [fused._rules_sharded(pc, [op]) for op in ops]
            assert got == [pk._rules_sharded(jc, [op]) for op in ops]
            assert any(got) == (axis in kw)


# ---------------------------------------------------------------------------
# tp and fsdp at world 4 against the JAX single-device Executor
# ---------------------------------------------------------------------------


def _pieces_ok(stored, rules_axis, names):
    """Each placed parameter and each of its moments stored as its 1/extent
    piece under its layout."""
    for n in names:
        assert n in stored, n
        moments = [m for m in stored if m.startswith(n + "_moment")]
        assert len(moments) == 2, (n, sorted(stored))
        for m in [n] + moments:
            shape, spec = stored[m]
            assert spec == stored[n][1] and rules_axis in spec, (m, spec)


@pytest.mark.parametrize("case", ["dp2_tp2", "fsdp4"])
def test_rules_match_jax_single_device(case, tmp_path_factory):
    """The MLP under Adam: Megatron tp over dp2 x tp2 and FSDP over fsdp4
    reproduce the JAX Executor's trajectory; every rank agrees; the placed
    weights and their Adam moments (the Resolver's accumulator alias) are
    stored as pieces: fc_0.w_0 (16, 32) -> (16, 16) under tp, (4, 32)
    under fsdp4."""
    batches = R.mlp_batches(6, 1)
    init, single = _jax_losses(_mlp_adam, batches)
    mesh, rules = {"dp2_tp2": ({"dp": 2, "tp": 2}, _TP_RULES),
                   "fsdp4": ({"dp": 1, "fsdp": 4}, _FSDP_RULES)}[case]
    res = _spawn(4, "sc_rules", {"init": init, "seed": 1, "mesh": mesh, "rules": rules},
                 tmp_path_factory, case)
    _agree(res)
    np.testing.assert_allclose(res[0]["losses"], single, rtol=_RTOL, atol=_ATOL)
    stored = res[0]["stored"]
    if case == "dp2_tp2":
        _pieces_ok(stored, "tp", ["fc_0.w_0", "fc_0.b_0", "fc_1.w_0"])
        assert stored["fc_0.w_0"][0] == (16, 16) and stored["fc_1.w_0"][0] == (16, 4)
        assert "fc_1.b_0" not in stored  # no rule: replicated
        # one all-reduce over tp a forward (the row-parallel product's)
        assert res[0]["collectives"]["all_reduce_fwd:tp"] == len(batches)
        assert res[0]["device_count"] == 2
    else:
        _pieces_ok(stored, "fsdp", ["fc_0.w_0", "fc_0.b_0", "fc_1.w_0", "fc_1.b_0"])
        assert stored["fc_0.w_0"][0] == (4, 32) and stored["fc_1.b_0"][0] == (1,)
        # gathered where used, the gradient reduce-scattered back
        assert res[0]["collectives"]["all_gather:fsdp"] > 0
        assert res[0]["collectives"]["reduce_scatter:fsdp"] == 4 * len(batches)
        assert res[0]["device_count"] == 4


def test_fused_kernels_decline_under_tp(tmp_path_factory):
    """training_fused under the tp rules: the GEMM epilogue and multi-Adam
    groups decline (every fc weight is placed), and the trajectory matches
    the JAX Executor's."""
    batches = R.mlp_batches(4, 5)
    init, single = _jax_losses(_mlp_adam, batches)
    res = _spawn(4, "sc_rules", {"init": init, "seed": 5, "steps": 4,
                                 "mesh": {"dp": 2, "tp": 2}, "rules": _TP_RULES, "fuse": True},
                 tmp_path_factory, "fused_tp")
    _agree(res)
    assert "gemm_epilogue" not in res[0]["dispatches"], res[0]["dispatches"]
    assert "multi_adam" not in res[0]["dispatches"], res[0]["dispatches"]
    np.testing.assert_allclose(res[0]["losses"], single, rtol=_RTOL, atol=_ATOL)


def test_fsdp_checkpoint_roundtrip_topology_change(tmp_path_factory):
    """3 steps under dp2 x fsdp2, save_persistables (the pieces gathered,
    rank 0 writes whole variables), a fresh scope on fsdp4 with
    load_persistables (resharded): the trajectory equals the uninterrupted
    JAX single-device run's."""
    batches = R.mlp_batches(6, 11)
    init, full = _jax_losses(_mlp_adam, batches)
    ckpt = tmp_path_factory.mktemp("fsdp_ckpt")
    res = _spawn(4, "sc_rules_ckpt", {"init": init, "seed": 11, "dir": str(ckpt),
                                      "mesh": {"dp": 2, "fsdp": 2},
                                      "mesh2": {"dp": 1, "fsdp": 4}, "rules": _FSDP_RULES},
                 tmp_path_factory, "ckpt")
    _agree(res)
    np.testing.assert_allclose(res[0]["losses"], full, rtol=_RTOL, atol=_ATOL)
    assert res[0]["head_stored"]["fc_0.w_0"][0] == (8, 32)
    assert res[0]["tail_stored"]["fc_0.w_0"][0] == (4, 32)
    saved = np.load(str(ckpt / "fc_0.w_0.npy"))
    assert saved.shape == (16, 32)


def _jax_transformer(batches):
    return _jax_losses(lambda f: R.build_transformer_flash(f, jmodels), batches)


@pytest.mark.parametrize("case", ["dp2_tp2", "fsdp4"])
def test_transformer_rules_match_jax_single_device(case, tmp_path_factory):
    """The small flash Transformer (2 layers, 4 heads of 8) with
    SpecLayout's Megatron rules (tools.profile_training.tp_rules: Q / K / V
    and FFN-up column parallel, attention-out and FFN-down row parallel):
    under dp2 x tp2 flash_attention runs on each rank's 2 heads and the
    forward all-reduces once a row-parallel product (10 a step); under
    fsdp4, where tp prunes away, the weights are gathered where used. Both
    reproduce the JAX Executor's trajectory."""
    batches = R.transformer_batches()
    init, single = _jax_transformer(batches)
    mesh = {"dp2_tp2": {"dp": 2, "tp": 2}, "fsdp4": {"dp": 1, "fsdp": 4}}[case]
    res = _spawn(4, "sc_transformer_tp", {"init": init, "mesh": mesh}, tmp_path_factory, case)
    _agree(res)
    np.testing.assert_allclose(res[0]["losses"], single, rtol=_RTOL, atol=_ATOL)
    colls = res[0]["collectives"]
    if case == "dp2_tp2":
        assert res[0]["heads"] == [2]
        assert colls["all_reduce_fwd:tp"] == 10 * len(batches)
        assert all(spec in ((None, "tp"), ("tp", None)) for _, spec in res[0]["stored"].values())
    else:
        assert res[0]["heads"] == [4]
        assert colls["reduce_scatter:fsdp"] == 32 * len(batches)
        # column (fsdp, tp) and row (tp, fsdp) with tp pruned away
        assert {spec for _, spec in res[0]["stored"].values()} == {("fsdp", None),
                                                                   (None, "fsdp")}


# ---------------------------------------------------------------------------
# the embedding engine's rule, the analysis binding, world 1
# ---------------------------------------------------------------------------


def test_embedding_engine_registers_its_ep_rule():
    """The EmbeddingEngine declares its row layout as a program rule, as in
    the JAX package: the table and its accumulators match ("ep", None), a
    Resolver at ep > 1 places the table and aliases its moments."""
    got = []
    for mod in (jfluid, fluid):
        main, startup = mod.Program(), mod.Program()
        with mod.unique_name.guard(), mod.program_guard(main, startup):
            tok = mod.layers.data(name="tok", shape=[-1, 8, 1], dtype="int64",
                                  append_batch_size=False)
            lbl = mod.layers.data(name="lbl", shape=[-1, 1], dtype="int64",
                                  append_batch_size=False)
            emb = mod.layers.distributed_embedding(tok, size=[64, 16])
            logits = mod.layers.fc(mod.layers.reduce_mean(emb, dim=[1]), size=4)
            loss = mod.layers.mean(mod.layers.softmax_with_cross_entropy(logits, lbl))
            mod.optimizer.Adam(0.01).minimize(loss)
        table = next(p.name for p in main.global_block().all_parameters()
                     if tuple(p.shape) == (64, 16))
        rules = main._sharding_rules
        accs = sorted(n for n in main.global_block().vars
                      if n.startswith(table + "_") and "_acc" in n)
        got.append((rules.match(table), [rules.match(n) for n in accs]))
    assert got[0] == got[1]
    assert got[1][0] == ("ep", None)
    res = P.Resolver(_port_mesh(dp=2, ep=2), rules=main._sharding_rules)
    assert res.rule_spec(table, (64, 16)) == ("ep", None)


def test_analysis_binds_the_resolver():
    """analyze_program with a mesh binds the rules into a Resolver: each
    fact carries the JAX analyzer's layout, and the sharding-rules checker
    warns of a dim the mesh does not divide in both packages."""
    from paddle_tpu.analysis import analyze_program as janalyze
    from paddle_tpu.analysis import run_checkers as jrun
    from paddle_tpu_torch.analysis import analyze_program, run_checkers

    rules = [(r"^fc_0\.w_0$", (None, "tp")), (r"^fc_1\.w_0$", (None, "tp"))]
    specs, warns = [], []
    for mod, analyze, run, mesh, sr in (
            (jfluid, janalyze, jrun, _jax_mesh(dp=1, tp=8), J.ShardingRules),
            (fluid, analyze_program, run_checkers, _port_mesh(tp=8), P.ShardingRules)):
        main, _, loss = R.build_mlp(mod)
        a = analyze(main, ["x", "y"], [loss.name], mesh=mesh, rules=sr(rules))
        specs.append({n: a.facts[n].spec for n in ("fc_0.w_0", "fc_1.w_0")})
        warns.append(sorted(f.var for f in run(a, checks=["sharding-rules"])
                            if "not divisible" in f.message))
    assert specs[0] == specs[1] == {"fc_0.w_0": (None, "tp"), "fc_1.w_0": None}
    assert warns[0] == warns[1] == ["fc_1.w_0"]


def test_rules_at_world1_prune_and_keep_the_kernels():
    """At world 1 every rule prunes to nothing: the ParallelExecutor with the
    Megatron rules over the small flash Transformer under training_fused
    stores nothing in pieces, dispatches the fused families as the Executor
    does and equals it bit for bit."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.ops import fused
    from paddle_tpu_torch.tools import profile_training

    batches = R.transformer_batches()[:3]
    out = {}
    for use_pe in (False, True):
        main, startup, loss = R.build_transformer_flash(fluid, R._port()[1])
        scope = R.port_state(fluid, startup, None)
        fused.reset_stats()
        if use_pe:
            s = fluid.BuildStrategy()
            s.pass_pipeline = "training_fused"
            s.sharding_rules = profile_training.tp_rules(main)
            pe = fluid.ParallelExecutor(loss_name=loss.name, main_program=main, scope=scope,
                                        build_strategy=s)
            vals = [pe.run(fetch_list=[loss.name], feed=f)[0] for f in batches]
            assert not pe._stored and len(s.sharding_rules) == 32
        else:
            flags.set_flags({"pass_pipeline": "training_fused"})
            try:
                exe = fluid.Executor(fluid.CPUPlace())
                vals = [exe.run(main, feed=f, fetch_list=[loss.name], scope=scope)[0]
                        for f in batches]
            finally:
                flags.set_flags({"pass_pipeline": ""})
        out[use_pe] = (vals, dict(fused.stats()["dispatches"]))
    assert out[True][1] == out[False][1] and out[True][1].get("gemm_epilogue")
    for a, b in zip(out[True][0], out[False][0]):
        np.testing.assert_array_equal(a, b)


def test_tp_rules_name_the_megatron_pairs():
    """tools.profile_training.tp_rules over either package's Transformer:
    30 row-parallel weights at Transformer base's depth (6 encoder layers x
    2, 6 decoder layers x 3), each Q / K / V and FFN-up column parallel."""
    from paddle_tpu_torch.tools import profile_training

    for mod, models in ((jfluid, jmodels), (fluid, R._port()[1])):
        main, _, _ = R.build_transformer_flash(mod, models, n_layer=6, n_head=8)
        rules = list(profile_training.tp_rules(main))
        assert sum(spec == ("tp", "fsdp") for _, spec in rules) == 30
        assert sum(spec == ("fsdp", "tp") for _, spec in rules) == 6 * 4 + 6 * 7
        assert all(re.match(r"\^fc_\d+\\\.w_0\$", p) for p, _ in rules)


def test_layout_collectives_forward_and_backward(tmp_path_factory):
    """The layout collectives at dp2 x tp2 (rank = dp index * 2 + tp index):
    gather_dim puts the pieces together in the order of its axes (the
    first outermost) and reduce-scatters its gradient; scatter_dim keeps
    this rank's piece and all-gathers its gradient; copy_to_axes is the
    identity with an all-reduced gradient, reduce_from_axes the mirror;
    send_recv pairs a send with its peer's receive."""
    res = _spawn(4, "sc_layout_collectives", {}, tmp_path_factory, "layout")
    xs = [np.arange(6, dtype="float32").reshape(2, 3) + 10 * r for r in range(4)]

    def weights(shape):
        return 1 + np.arange(int(np.prod(shape)), dtype="float32").reshape(shape)

    for r, got in enumerate(res):
        dp, tp = divmod(r, 2)
        assert got["coords"] == (dp, tp, r, tp * 2 + dp)
        tp_peers = [xs[2 * dp], xs[2 * dp + 1]]
        y, g = got["gather_tp"]
        np.testing.assert_array_equal(y, np.concatenate(tp_peers, 1))
        # each tp rank's loss weighs the whole; the piece's gradient sums them
        np.testing.assert_array_equal(g, 2 * weights((2, 6))[:, 3 * tp:3 * tp + 3])
        y, g = got["gather_dptp"]
        np.testing.assert_array_equal(y, np.concatenate(xs, 0))
        np.testing.assert_array_equal(g, 4 * weights((8, 3))[2 * r:2 * r + 2])
        y, _ = got["gather_tpdp"]
        np.testing.assert_array_equal(y, np.concatenate([xs[0], xs[2], xs[1], xs[3]], 0))
        y, g = got["scatter_tp"]
        np.testing.assert_array_equal(y, xs[r][tp:tp + 1])
        want = np.zeros((2, 3), "float32")
        want[0:1] = weights((1, 3))
        want[1:2] = weights((1, 3))
        np.testing.assert_array_equal(g, want)
        y, g = got["copy_tp"]
        np.testing.assert_array_equal(y, xs[r])
        np.testing.assert_array_equal(g, 2 * weights((2, 3)))
        y, g = got["reduce_tp"]
        np.testing.assert_array_equal(y, tp_peers[0] + tp_peers[1])
        np.testing.assert_array_equal(g, weights((2, 3)))
        np.testing.assert_array_equal(got["send_recv"], 2 * xs[2 * (1 - dp) + tp])


def test_pass_pipeline_carries_the_program_rules():
    """A program rewritten by the pass pipeline shares its source's rule
    set (the JAX package's executor does the same), so a placement
    survives training_fused."""
    from paddle_tpu_torch.executor import _apply_pass_pipeline

    main, _, loss = R.build_mlp(fluid, "adam")
    P.program_rules(main).add(r"^fc_0\.w_0$", (None, "tp"))
    scope = fluid.Scope(place=fluid.CPUPlace())
    out = _apply_pass_pipeline(main, scope, ["x", "y"], [loss.name], pipeline="training_fused")
    assert out is not main and out._sharding_rules is main._sharding_rules
    assert out._sharding_rules.match("fc_0.w_0") == (None, "tp")
