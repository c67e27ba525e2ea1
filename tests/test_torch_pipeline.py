"""The port's pipeline (paddle_tpu_torch/parallel/partition.py, pipeline.py
and executor._PipelinedBlock) against the JAX package on the CPU: the
partitioner's pure functions on the same weights and legal cuts; the
schedules' order and the activations they keep alive; training through the
ParallelExecutor at pp4 and dp2 x pp2 (gloo, spawned ranks, tests/
torch_parallel_ranks.py) under GPipe and 1F1B, with ZeRO-1, against the JAX
single-device Executor on the same weights loss for loss; the device_guard
override, the checkpoint round trip and the refusals of tests/
test_pp_program.py; the small flash Transformer under a pipeline with the
fused families in each stage's autograd.

Tolerance: the JAX tests' rtol 2e-3 / atol 2e-4. The JAX pipeline's own
parity check passes on the reference (its failing check in the seed is
the loss-monotonicity one), so the port takes the parity alone."""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as fluid
import torch_parallel_ranks as R
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.executor import scope_guard as jscope_guard
from paddle_tpu.framework import PIPELINE_STAGE_ATTR
from paddle_tpu.parallel import partition as JP
from paddle_tpu_torch import convert
from paddle_tpu_torch.parallel import partition as PP
from paddle_tpu_torch.parallel import pipeline

_RTOL, _ATOL = 2e-3, 2e-4
_SPAWNED = {}
_RUNS = [("gpipe", 4, "sgd", False), ("1f1b", 4, "sgd", False),
         ("gpipe", 4, "momentum", True), ("1f1b", 8, "momentum", True)]


def _jax(build, batches):
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


def _pp_runs(mesh, tmp_path_factory):
    """The sc_pp scenario at `mesh` once a module: every run of _RUNS, from
    the JAX startup state."""
    key = tuple(sorted(mesh.items()))
    if key not in _SPAWNED:
        batches = R.mlp_batches(6, 0)
        init, ref = {}, {}
        for opt in ("sgd", "momentum"):
            init[opt], ref[opt] = _jax(lambda f, o=opt: R.build_pp_mlp(f, o), batches)
        res = R.spawn(4, "sc_pp", {"init": init, "seed": 0, "mesh": mesh, "runs": _RUNS},
                      tmp_path_factory.mktemp("pp_%d_%d" % (mesh["dp"], mesh["pp"])))
        _SPAWNED[key] = (res, ref)
    return _SPAWNED[key]


# ---------------------------------------------------------------------------
# partition.py against the JAX package's
# ---------------------------------------------------------------------------


class _Op:
    def __init__(self, stage=None):
        self.type = "fake"
        self.attrs = {} if stage is None else {PIPELINE_STAGE_ATTR: stage}


class _Aval:
    def __init__(self, shape, dtype="float32"):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)


@pytest.mark.parametrize("w,legal,n", [
    ([1.0, 1.0, 10.0, 1.0, 1.0, 1.0], range(5), 3),
    ([5.0, 5.0, 5.0, 5.0], [0, 2], 3),
    ([2.0, 1.0, 1.0], range(2), 1),
    ([1.0, 2.0, 3.0, 4.0], range(3), 4),
])
def test_balanced_partition_as_jax(w, legal, n):
    """tests/test_pp_program.py's cases (and the edges of one stage and one
    op a stage): the same cuts as the JAX package's."""
    assert PP.balanced_partition(w, legal, n) == JP.balanced_partition(w, legal, n)


@pytest.mark.parametrize("seed", range(4))
def test_balanced_partition_bottleneck_no_worse_than_jax(seed):
    """On random weights the port's cut never has a heavier stage than the
    JAX package's: the JAX greedy accepts a bound its last stage exceeds,
    so its search can end with most ops in the last stage; the port's
    checks that stage too."""
    rng = np.random.RandomState(seed)
    n_ops, n = 30, 4
    w = list(rng.rand(n_ops))
    legal = sorted(rng.choice(n_ops - 1, 20, replace=False))

    def bottleneck(stages):
        return max(sum(wi for wi, s in zip(w, stages) if s == k) for k in range(n))

    got, ref = PP.balanced_partition(w, legal, n), JP.balanced_partition(w, legal, n)
    assert got == sorted(got) and set(got) == set(range(n))
    assert bottleneck(got) <= bottleneck(ref) + 1e-12
    for k in range(n_ops - 1):
        if got[k + 1] != got[k]:
            assert k in legal


def test_balanced_partition_raises_as_jax():
    for mod in (JP, PP):
        with pytest.raises(ValueError, match="legal cut"):
            mod.balanced_partition([5.0] * 4, legal_cuts=[1], n_stages=3)
        with pytest.raises(ValueError):
            mod.balanced_partition([1.0], [], 0)


@pytest.mark.parametrize("stages,n", [((None, None), 2), ((0, None, 1, None), 2),
                                      ((1, 0), 2), ((5,), 2), ((None, 2, None, 3), 4)])
def test_stages_from_attrs_as_jax(stages, n):
    ops = [_Op(s) for s in stages]
    out = []
    for mod in (JP, PP):
        try:
            out.append(mod.stages_from_attrs(ops, n))
        except ValueError as e:
            out.append(str(e))
    assert out[0] == out[1]


@pytest.mark.parametrize("op_type,ins,outs", [
    ("mul", {"X": [(1024, 4096)], "Y": [(4096, 4096)]}, {"Out": [(1024, 4096)]}),
    ("matmul", {"X": [(8, 64, 32)], "Y": [(8, 32, 16)]}, {"Out": [(8, 64, 16)]}),
    ("conv2d", {"Input": [(8, 3, 32, 32)], "Filter": [(16, 3, 3, 3)]},
     {"Output": [(8, 16, 30, 30)]}),
    ("lstm", {"Input": [(16, 32)]}, {"Hidden": [(16, 8)]}),
    ("elementwise_add", {"X": [(1024, 4096)], "Y": [(1024, 4096)]}, {"Out": [(1024, 4096)]}),
])
def test_analytic_op_flops_bytes_as_jax(op_type, ins, outs):
    """The counting model is the JAX package's; the time divides it by the
    card's peaks (a matmul of these sizes is FLOP-bound, an equal-bytes add
    is byte-bound) in place of the TPU's."""
    ia = {k: [_Aval(s) for s in v] for k, v in ins.items()}
    oa = {k: [_Aval(s) for s in v] for k, v in outs.items()}
    assert PP.analytic_op_flops_bytes(op_type, ia, oa) == JP.analytic_op_flops_bytes(
        op_type, ia, oa)
    flops, nbytes = PP.analytic_op_flops_bytes(op_type, ia, oa)
    assert PP.analytic_op_time_us(op_type, ia, oa) == max(flops / 67.0e6, nbytes / 3.35e6)


def test_analytic_bubble_as_jax():
    from paddle_tpu.observability.stepstats import analytic_bubble

    for pp in (2, 4, 8):
        for m in (1, 4, 8, 32):
            assert pipeline.analytic_bubble(pp, m) == analytic_bubble(pp, m)
    assert pipeline.analytic_bubble(4, 8) == 3.0 / 11.0


# ---------------------------------------------------------------------------
# the schedules
# ---------------------------------------------------------------------------


class _Trace:
    """A stage that records its steps and the activations it keeps."""

    def __init__(self):
        self.log, self.alive, self.peak = [], set(), 0

    def recv_fwd(self, i):
        self.log.append(("rf", i))
        return "x%d" % i

    def fwd(self, i, x):
        self.log.append(("F", i))
        self.alive.add(i)
        self.peak = max(self.peak, len(self.alive))
        return "y%d" % i

    def send_fwd(self, y):
        self.log.append(("sf", y))

    def recv_bwd(self, i):
        self.log.append(("rb", i))
        return "g%d" % i

    def bwd(self, i, g):
        self.log.append(("B", i))
        self.alive.discard(i)
        return "gx%d" % i

    def send_bwd(self, gx):
        self.log.append(("sb", gx))

    def send_fwd_recv_bwd(self, y, i):
        self.log.append(("sf+rb", y, i))
        return "g%d" % i

    def send_bwd_recv_fwd(self, gx, i):
        self.log.append(("sb+rf", gx, i))
        return "x%d" % i


@pytest.mark.parametrize("pp,m", [(4, 8), (4, 2), (2, 5), (3, 3)])
def test_schedules_order_and_liveness(pp, m):
    """GPipe: all m forwards, then the m backwards, in microbatch order, m
    activations alive. 1F1B: pp - 1 - stage warm-up forwards, then a
    forward and a backward in turn, at most pp - stage alive; every
    microbatch forwarded before it is differentiated, each exactly once."""
    for stage in range(pp):
        g = _Trace()
        pipeline.gpipe_schedule(g, m, pp, stage)
        fb = [e for e in g.log if e[0] in ("F", "B")]
        assert fb == [("F", i) for i in range(m)] + [("B", i) for i in range(m)]
        assert g.peak == m
        t = _Trace()
        pipeline.one_f_one_b_schedule(t, m, pp, stage)
        fb = [e for e in t.log if e[0] in ("F", "B")]
        assert sorted(fb) == sorted([("F", i) for i in range(m)] + [("B", i) for i in range(m)])
        warm = min(pp - 1 - stage, m)
        assert fb[:warm] == [("F", i) for i in range(warm)]
        for i in range(m):
            assert fb.index(("F", i)) < fb.index(("B", i))
        assert t.peak <= min(pp - stage, m)


# ---------------------------------------------------------------------------
# the homogeneous tier (tests/test_pipeline_parallel.py)
# ---------------------------------------------------------------------------

_GPIPE_CASES = [(4, 4), (2, 2), (4, 2)]


def test_gpipe_matches_sequential_and_jax(tmp_path_factory):
    """gpipe over 8 stacked stages at pp4 (4 and 2 microbatches) and dp2 x
    pp2 (each dp rank pipelines its rows; one spawn for every case, so one
    test): the output equals the stages applied in turn and the JAX
    package's gpipe on the same stack, on every rank; the backward pipeline
    gives every rank the whole stack's gradients, those of the stages in
    turn; 8 SGD steps through it drive the loss down; a stack that does not
    divide over pp raises ValueError."""
    import jax.numpy as jnp

    from paddle_tpu.parallel import MeshConfig, make_mesh
    from paddle_tpu.parallel.pipeline import gpipe as jgpipe

    rng = np.random.RandomState(0)
    p = {"params": {"w": (rng.randn(8, 16, 16) * 0.3).astype("float32"),
                    "b": (rng.randn(8, 16) * 0.1).astype("float32")},
         "x": rng.randn(16, 16).astype("float32"),
         "tgt": rng.randn(16, 16).astype("float32"), "cases": _GPIPE_CASES}
    res = R.spawn(4, "sc_gpipe", p, tmp_path_factory.mktemp("gpipe"))
    for pp, n_micro in _GPIPE_CASES:
        jy = jgpipe(lambda q, x: jnp.tanh(x @ q["w"] + q["b"]),
                    {k: jnp.asarray(v) for k, v in p["params"].items()}, jnp.asarray(p["x"]),
                    n_micro=n_micro, mesh=make_mesh(MeshConfig(dp=-1, pp=pp)))
        for r in res:
            got = r[(pp, n_micro)]
            assert got["mesh"]["pp"] == pp and got["mesh"]["dp"] == 4 // pp
            np.testing.assert_allclose(got["y"], got["seq"], rtol=2e-5, atol=2e-6)
            np.testing.assert_allclose(got["y"], np.asarray(jy), rtol=2e-5, atol=2e-6)
            for k, g in got["seq_grads"].items():
                np.testing.assert_allclose(got["grads"][k], g, rtol=5e-5, atol=1e-6)
    losses = res[0]["train"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0] * 0.9
    assert all(r["train"] == losses for r in res)
    assert "not divisible over pp" in res[0]["indivisible"]


# ---------------------------------------------------------------------------
# training through the ParallelExecutor against the JAX Executor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", [{"dp": 1, "pp": 4}, {"dp": 2, "pp": 2}], ids=["pp4",
                                                                            "dp2_pp2"])
def test_pp_program_matches_single_device(mesh, tmp_path_factory):
    """The heterogeneous-width MLP of tests/test_pp_program.py under GPipe
    and 1F1B (SGD; Momentum under ReduceStrategy.Reduce, ZeRO-1 over dp;
    4 and 8 microbatches) reproduces the JAX Executor's trajectory, every
    rank agreeing, every stage holding ops; a fetch computed before the
    last stage raises ValueError and steps_per_run > 1 raises
    NotImplementedError, as in the JAX package. (One spawn a mesh, so one
    test a mesh.)"""
    res, ref = _pp_runs(mesh, tmp_path_factory)
    for run in _RUNS:
        for r in res:
            assert r[run]["losses"] == res[0][run]["losses"]
        np.testing.assert_allclose(res[0][run]["losses"], ref[run[2]], rtol=_RTOL, atol=_ATOL)
        plan = res[0][run]["plan"]
        assert len(plan["stages"]) == mesh["pp"] and all(plan["stages"])
        assert plan["schedule"] == run[0] and plan["n_micro"] == run[1]
    raised = res[0]["raised"]
    assert raised["fetch"][0] == "ValueError" and "LAST pipeline stage" in raised["fetch"][1]
    assert raised["multistep"][0] == "NotImplementedError"
    assert "steps_per_run" in raised["multistep"][1]


def test_device_guard_override_controls_partition(tmp_path_factory):
    """Explicit device_guard("pp:k") annotations win over the analytic
    partition: one fc a stage, each stage owning its w and b, and the
    trajectory the JAX Executor's."""
    batches = R.mlp_batches(6, 0)
    init, ref = _jax(lambda f: R.build_pp_mlp(f, guard=True), batches)
    res = R.spawn(4, "sc_pp", {"init": {"sgd": init}, "seed": 0, "mesh": {"dp": 1, "pp": 4},
                               "runs": [("gpipe", 4, "sgd", False)], "guard": True},
                  tmp_path_factory.mktemp("pp_guard"))
    got = res[0][("gpipe", 4, "sgd", False)]
    np.testing.assert_allclose(got["losses"], ref, rtol=_RTOL, atol=_ATOL)
    assert [sorted(s) for s in got["plan"]["stage_params"]] == [
        sorted(["fc_%d.w_0" % k, "fc_%d.b_0" % k]) for k in range(4)]


def test_pp_checkpoint_save_resume_and_stages_knob(tmp_path_factory):
    """BuildStrategy.pipeline_stages = 4 builds the pp mesh without a
    MeshConfig; save_persistables mid-training (every rank holds every
    parameter, rank 0 writes), load into a fresh scope of another seed: the
    resumed trajectory continues exactly, and both equal the JAX run."""
    batches = R.mlp_batches(6, 4)
    init, ref = _jax(R.build_pp_mlp, batches)
    res = R.spawn(4, "sc_pp_ckpt", {"init": init, "dir": str(tmp_path_factory.mktemp("ck"))},
                  tmp_path_factory.mktemp("pp_ckpt"))
    for r in res:
        assert r["mesh"]["pp"] == 4
        np.testing.assert_array_equal(r["resumed"], r["full"][3:])
    np.testing.assert_allclose(res[0]["full"], ref, rtol=_RTOL, atol=_ATOL)


def test_transformer_pipeline_with_fused_families(tmp_path_factory):
    """The small flash Transformer at pp4 (8 microbatches) under
    training_fused: GPipe and 1F1B equal the port's single-device Executor
    under the same preset, with the GEMM epilogue, layer_norm and flash
    forms differentiated through their autograd Functions in each stage."""
    fl, models = R._port()
    from paddle_tpu_torch import flags

    main, startup, loss = R.build_transformer_flash(fl, models)
    scope = R.port_state(fl, startup, None)
    init = convert.scope_to_numpy(scope, convert.persistable_names(main))
    flags.set_flags({"pass_pipeline": "training_fused"})
    try:
        exe = fl.Executor(fl.CPUPlace())
        ref = [float(exe.run(main, feed=f, fetch_list=[loss.name], scope=scope)[0][0])
               for f in R.transformer_batches()]
    finally:
        flags.set_flags({"pass_pipeline": ""})
    res = R.spawn(4, "sc_transformer_pp", {
        "init": init, "mesh": {"dp": 1, "pp": 4}, "n_micro": 8,
        "schedules": ["gpipe", "1f1b"], "pipeline": "training_fused"},
        tmp_path_factory.mktemp("tf_pp"))
    for schedule in ("gpipe", "1f1b"):
        got = res[0][schedule]
        np.testing.assert_allclose(got["losses"], ref, rtol=_RTOL, atol=_ATOL)
        assert len(got["plan"]["stages"]) == 4 and all(got["plan"]["stages"])


def test_fused_autograd_forms_match_plain_autograd():
    """The GEMM epilogue's and layer_norm's autograd Functions (a pipeline
    stage's forms) give the gradients torch.autograd gives through their
    plain versions."""
    from paddle_tpu_torch.ops import fused, gemm_epilogue, layer_norm

    g = torch.Generator().manual_seed(0)
    x, w, b = (torch.randn(s, generator=g, dtype=torch.float64).float()
               for s in ((6, 5), (5, 7), (1, 7)))
    dz, dy = torch.randn(6, 7, generator=g), torch.randn(6, 7, generator=g)
    for act in ("relu", "gelu", "tanh", "sigmoid"):
        got, want = [], []
        for fn, out in ((lambda a, c, d: fused._GemmBiasAct.apply(a, c, d, act), got),
                        (lambda a, c, d: gemm_epilogue.gemm_bias_act_plain(a, c, d, act), want)):
            leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
            z, y = fn(*leaves)
            torch.autograd.backward([z, y], [dz, dy])
            out.extend(t.grad for t in leaves)
        for a, c in zip(got, want):
            torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5)
    s, r = torch.randn(4, 8, generator=g), torch.randn(4, 8, generator=g)
    sc, bi = torch.randn(8, generator=g), torch.randn(8, generator=g)
    dy = torch.randn(4, 8, generator=g)
    got, want = [], []
    for fn, out in ((lambda *a: fused._LayerNorm.apply(*a, 1e-5), got),
                    (lambda *a: layer_norm.fused_layer_norm_plain(*a, 1e-5), want)):
        leaves = [t.clone().requires_grad_(True) for t in (s, r, sc, bi)]
        _, y, _, _ = fn(*leaves)
        y.backward(dy)
        out.extend(t.grad for t in leaves)
    for a, c in zip(got, want):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-5)
