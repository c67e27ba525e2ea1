"""The serving and fp8 paths exported in the port (executor.export_block under
inference.export_compiled, train_export.export_train_step and
GenerationEngine.export_variant) on the CPU, held against the JAX package:

- (i) int8 deployment: the QAT -> freeze_program -> convert_to_int8
  ResNet-8 of tests/test_torch_deploy.py, saved by both packages from the
  JAX package's trained state. The port's export_compiled graph holds one
  paddle_tpu_torch::quant_gemm_bias_act node per int8_conv2d the kernel
  takes (groups == 1); its load_compiled equals its Predictor bit for bit,
  and is within INT8_TOL of the JAX package's load_compiled.
- (ii) fp8 training: the small Transformer of tests/torch_transformer_case.py
  under FLAGS_fp8_matmul and training_fused. The exported step holds the
  fp8_matmul and fp8_matmul_grads nodes; the runner equals the port's
  Executor.run bit for bit for 3 steps; its first loss is within
  tests/test_torch_fp8.py's FP8_RTOL of the JAX package's Executor.run
  from the same state, and its 3 losses within the JAX package's
  fused-vs-unfused bar of the JAX Executor.run's and TrainStepRunner's.
- (iii) paged decode and prefill: a small GPTDecoder's decode program and
  one prefill-chunk program, exported with the KV pools as written state,
  for f32 and int8 pools: one paddle_tpu_torch::paged_flash_attention node
  a layer; a prefill chunk and 3 decode steps equal the port engine's
  op-by-op calls bit for bit (logits and pools), and the logits are within
  tests/test_torch_generation.py's bar of the JAX engine's, whose variants
  are its aot_serve_lowering(..., return_state=True).
"""

import os
import sys

import numpy as np
import pytest

import jax

import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, flags, inference
from paddle_tpu_torch.executor import _ExportedRun
from paddle_tpu_torch.serving import compile_cache
from paddle_tpu_torch.train_export import TrainStepRunner, export_train_step

# QAT_RTOL: the JAX package's fused-vs-unfused bar
from test_torch_deploy import INT8_TOL, QAT_RTOL as FUSED_RTOL, _np_state, _put, _resnet8_qat
from test_torch_deploy import _transpiler
from test_torch_fp8 import FP8_RTOL
from torch_rnn_cases import build, exe_scope

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

PACKAGES = ("paddle_tpu", "paddle_tpu_torch")
GEN_ATOL = GEN_RTOL = 1e-4  # tests/test_torch_generation.py's bar
DECODE_STEPS = 3


def _targets(program, name):
    return [n for n in program.graph.nodes
            if str(n.target) == "paddle_tpu_torch.%s.default" % name]


# --------------------------------------------------------------------------
# (i) int8 deployment
# --------------------------------------------------------------------------


def test_int8_resnet_artifact_holds_the_quant_gemm_op(tmp_path):
    """(i): the frozen int8 ResNet-8, saved by both packages from one
    trained state, exported by each package's export_compiled."""
    from paddle_tpu import inference as jinference
    from paddle_tpu_torch.ops.quant_ops import int8_conv2d_path_taken

    rng = np.random.RandomState(4)
    feeds = [{"img": rng.randn(4, 3, 32, 32).astype(np.float32),
              "label": rng.randint(0, 10, (4, 1)).astype(np.int64)} for _ in range(2)]
    test_feed = {"img": rng.randn(3, 3, 32, 32).astype(np.float32)}
    dirs, trained, taken = {}, None, 0
    for p in PACKAGES:
        main, startup, (loss, logits) = build(p, _resnet8_qat)
        qt = _transpiler(p).QuantizeTranspiler()
        qt.training_transpile(main, startup)
        exe, scope, guard = exe_scope(p, seed=3)
        with guard(scope):
            exe.run(startup)
            names = convert.persistable_names(main)
            if trained is None:
                for f in feeds:
                    exe.run(main, feed=f, fetch_list=[loss.name])
                trained = _np_state(p, scope, names)
            else:
                _put(p, scope, trained)
            infer = main.clone(for_test=True)
            qt.freeze_program(infer, scope)
            qt.convert_to_int8(infer, scope)
            dirs[p] = str(tmp_path / p)
            io = __import__(p + ".io", fromlist=["io"])
            io.save_inference_model(dirs[p], ["img"], [logits], exe, main_program=infer)
        if p == "paddle_tpu_torch":
            taken = sum(op.type == "int8_conv2d"
                        and int8_conv2d_path_taken(op.attrs.get("groups", 1) or 1)
                        for op in infer.global_block().ops)
    assert taken == 9
    path = inference.export_compiled(dirs["paddle_tpu_torch"], test_feed, str(tmp_path / "art"),
                                     place=pt.CPUPlace())
    program = compile_cache.read_artifact(path)["program"]
    assert len(_targets(program, "quant_gemm_bias_act")) == taken
    (want,) = inference.Predictor(dirs["paddle_tpu_torch"], place=pt.CPUPlace()).run(test_feed)
    art = inference.load_compiled(path)
    for _ in range(2):
        (got,) = art.run(test_feed)
        np.testing.assert_array_equal(got, want)
    jpath = jinference.export_compiled(dirs["paddle_tpu"], test_feed, str(tmp_path / "jart"))
    (jgot,) = jinference.load_compiled(jpath).run(test_feed)
    assert got.shape == jgot.shape == (3, 10)
    np.testing.assert_allclose(got, jgot, rtol=INT8_TOL, atol=INT8_TOL)


# --------------------------------------------------------------------------
# (ii) fp8 training
# --------------------------------------------------------------------------


def test_fp8_transformer_step_exports_the_fp8_ops(tmp_path):
    """(ii): the small Transformer under FLAGS_fp8_matmul, exported by
    each package from the JAX package's startup state. The port's runner
    equals its Executor.run bit for bit. Against the JAX package: the first
    loss (one forward at the shared state) within tests/test_torch_fp8.py's
    FP8_RTOL of the JAX Executor.run's; all 3 losses within the JAX
    package's fused-vs-unfused bar (FUSED_RTOL) of its Executor.run's and
    of its TrainStepRunner's. After a step the weights carry fp8 gradients,
    where a sum in another order moves a value by a whole e4m3 step (2^-3
    of it); and the JAX runner's own first loss differs from its
    Executor.run's by more than FP8_RTOL (its export compiles the step
    apart), so the exact bar holds against the Executor only."""
    import paddle_tpu.fluid as jfluid
    from paddle_tpu import flags as jflags
    from paddle_tpu.executor import Scope as JScope
    from paddle_tpu.executor import scope_guard as jscope_guard
    from paddle_tpu.models import transformer as jtransformer
    from paddle_tpu.train_export import TrainStepRunner as JRunner
    from paddle_tpu.train_export import export_train_step as jexport

    from torch_transformer_case import SMALL, build as tbuild, make_batch

    from paddle_tpu_torch.models import transformer as ptransformer

    def first(v):
        return float(np.asarray(v[0]).reshape(-1)[0])

    batches = [make_batch(SMALL, s) for s in range(3)]
    jsaved = jflags.get_flags(["pass_pipeline", "fp8_matmul"])
    jflags.set_flags({"pass_pipeline": "training_fused", "fp8_matmul": True})
    try:
        jmain, jstartup, jloss = tbuild(jfluid, jtransformer, SMALL)
        jscope, jexe = JScope(seed=7), jfluid.Executor(jfluid.CPUPlace())
        with jscope_guard(jscope):
            jexe.run(jstartup)
            names = convert.persistable_names(jmain)
            init = {n: np.array(np.asarray(jscope.vars[n])) for n in names}
            jpath = jexport(str(tmp_path / "jstep"), batches[0], [jloss], program=jmain,
                            scope=jscope)
            jax_exe = [first(jexe.run(jmain, feed=b, fetch_list=[jloss.name])) for b in batches]
        jr = JRunner.load(jpath)
        jax_runner = [first(jr.run(b)) for b in batches]
    finally:
        jflags.set_flags(jsaved)
    saved = flags.get_flags(["pass_pipeline", "fp8_matmul"])
    flags.set_flags({"pass_pipeline": "training_fused", "fp8_matmul": True})
    try:
        main, startup, loss = tbuild(pt, ptransformer, SMALL)
        exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope(seed=7)
        with pt.scope_guard(scope):
            exe.run(startup)
            convert.load_into_scope(scope, init, names)
            path = export_train_step(str(tmp_path / "step"), batches[0], [loss], program=main,
                                     scope=scope)
            runner = TrainStepRunner.load(path)
            want = [first(exe.run(main, feed=b, fetch_list=[loss.name])) for b in batches]
    finally:
        flags.set_flags(saved)
    program = compile_cache.read_artifact(path)["program"]
    assert _targets(program, "fp8_matmul") and _targets(program, "fp8_matmul_grads")
    got = [first(runner.run(b)) for b in batches]
    assert got == want
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:1], jax_exe[:1], rtol=FP8_RTOL)
    np.testing.assert_allclose(got, jax_exe, rtol=FUSED_RTOL)
    np.testing.assert_allclose(got, jax_runner, rtol=FUSED_RTOL)


# --------------------------------------------------------------------------
# (iii) paged decode and prefill
# --------------------------------------------------------------------------

MODEL_KW = dict(vocab_size=24, n_layer=2, n_head=2, d_model=16, d_inner=32, max_context=16)
ENGINE_KW = dict(max_slots=3, page_size=4, max_context=16)
PROMPT = [3, 7, 11, 2, 9]
NO_EOS = 999


def _recorded(engine):
    """Wrap engine._call: each call's (variant kind, feeds, fetches, pools
    after) in a list."""
    calls = []
    inner = engine._call

    def call(variant, np_feeds):
        kind = next(k for k, v in engine._variants.items() if v is variant)
        feeds = {n: np.array(np_feeds[n]) for n in variant.feed_names}
        out = inner(variant, np_feeds)
        pools = {n: engine._state[n].clone() for n in variant.mut_names}
        calls.append((kind, feeds, [np.array(o) for o in out], pools))
        return out

    engine._call = call
    return calls


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_paged_programs_export_with_the_pools_as_state(kv_dtype):
    """(iii): the port engine's decode and prefill-chunk programs exported,
    run on copies of its pools against its own op-by-op calls and the JAX
    engine's logits."""
    from paddle_tpu.models.gpt_decoder import GPTDecoder as JaxGPTDecoder
    from paddle_tpu.serving import GenerationEngine as JaxEngine
    from paddle_tpu.serving import GenRequest as JaxGenRequest
    from paddle_tpu_torch.models import GPTDecoder
    from paddle_tpu_torch.serving import GenerationEngine, GenRequest

    jeng = JaxEngine(JaxGPTDecoder(kv_dtype=kv_dtype, **MODEL_KW), name="xp_jax_" + kv_dtype,
                     cache_dir=None, **ENGINE_KW)
    model = GPTDecoder(kv_dtype=kv_dtype, **MODEL_KW)
    peng = GenerationEngine(model, name="xp_port_" + kv_dtype, place=pt.CPUPlace(),
                            **ENGINE_KW)
    arrays = {n: np.asarray(jeng.scope.vars[n]) for n in model.param_names()}
    convert.load_into_scope(peng.scope, arrays, model.param_names())
    peng.warmup()
    chunk = "prefill:%d" % peng.prefill_bucket(len(PROMPT))
    start = {n: t.clone() for n, t in peng._state.items()}
    calls = _recorded(peng)
    run = peng.start(GenRequest(PROMPT, max_new_tokens=DECODE_STEPS + 1, eos_id=NO_EOS))
    for _ in range(DECODE_STEPS):
        peng.decode_step([run])
    slot = run.slot
    peng.finish(run)
    assert [c[0] for c in calls] == [chunk] + ["decode"] * DECODE_STEPS

    exported = {}
    for kind in (chunk, "decode"):
        feeds = next(c[1] for c in calls if c[0] == kind)
        program, ro, mut_names, dtypes = peng.export_variant(kind, feeds)
        assert len(_targets(program, "paged_flash_attention")) == MODEL_KW["n_layer"], kind
        exported[kind] = (_ExportedRun(program.module(), dtypes, peng.device), ro, mut_names)
    pools = {n: t.clone() for n, t in start.items()}
    rows = []
    for kind, feeds, want, want_pools in calls:
        fn, ro, mut_names = exported[kind]
        mut = {n: pools[n] for n in mut_names}
        got = [o.numpy() for o in fn(feeds, ro, mut)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=kind)
        for n in mut_names:
            assert pools[n].equal(want_pools[n]), (kind, n)
        rows.append(got[0][0] if kind == chunk else got[0][slot])

    jrun = jeng.start(JaxGenRequest(PROMPT, max_new_tokens=DECODE_STEPS + 1, eos_id=NO_EOS))
    jrows = [np.array(jeng.last_prefill_logits)]
    for _ in range(DECODE_STEPS):
        jeng.decode_step([jrun])
        jrows.append(np.array(jeng.last_logits[jrun.slot]))
    jeng.finish(jrun)
    for step, (g, w) in enumerate(zip(rows, jrows)):
        np.testing.assert_allclose(g, w, atol=GEN_ATOL, rtol=GEN_RTOL, err_msg="call %d" % step)
