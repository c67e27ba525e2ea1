"""Calibrated int8 serving in the torch port (paddle_tpu_torch
ops/quant_gemm.py, ops/quant_ops.py, io.py, analysis/, passes/quant.py,
ops/fused.py gemm_int8, serving/engine.py) against the JAX package, at the
small sizes of tests/test_quant.py (the 256 -> 256 -> 128 fc stack), and —
on a CUDA card — the quant GEMM kernel against its plain version.

Tolerances, each with its reason:
- quant GEMM plain vs JAX quant_gemm_bias_act (interpret mode): int8 with
  act none / relu 1e-6 relative (exact integer sums on both sides, the
  dequant epilogue one f32 rounding on both sides); fp8 1e-5 relative (f32
  sums in another order). fp8 inputs stay within +-448, where the two
  frameworks' casts agree.
- quant ops op by op: the same elementwise f32 expressions, bit for bit.
- io round trips: ops, feeds, fetches and arrays bit for bit.
- inference_int8 on one saved model: op types and var dtypes equal op for
  op; frozen int8 weights and every scale const bit for bit; calibrated
  ranges of activations the model computes within 1e-6 relative (f32
  matmuls summed in another order), of fed ones bit for bit; int8
  ServingEngine outputs within 1e-5; gemm_int8 dispatches equal.
- on the card: int8 none / relu bit for bit against the plain version,
  gelu / tanh / sigmoid 1e-5, fp8 rtol 1e-5 of the largest |z|.

The JAX package is imported inside a fixture, so that on the card, where
JAX is not installed, the `cuda` cases run alone
(`python -m pytest --noconftest tests/test_torch_quant.py -m cuda`)."""

import json
import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch import CPUPlace, flags as pt_flags
from paddle_tpu_torch.ops import fused, quant_gemm as qg
from paddle_tpu_torch.ops.gemm_epilogue import ACT_F32
from paddle_tpu_torch.ops import registry as pt_registry

D_IN, HIDDEN, CLASSES = 256, 256, 128


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's modules the comparisons need."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    import paddle_tpu.fluid as fluid
    from paddle_tpu import flags, framework
    from paddle_tpu.executor import Scope, scope_guard
    from paddle_tpu.ops import pallas_kernels, registry
    from paddle_tpu.serving import ServingEngine

    class Ref:
        pass

    ref = Ref()
    ref.jax, ref.jnp, ref.fluid, ref.flags, ref.framework = (jax, jax.numpy, fluid, flags,
                                                             framework)
    ref.Scope, ref.scope_guard, ref.pk, ref.registry = Scope, scope_guard, pallas_kernels, registry
    ref.ServingEngine = ServingEngine
    return ref


@pytest.fixture
def restore_flags(jax_ref):
    jkeep = jax_ref.flags.get_flags(["quantized_gemm"])
    pkeep = pt_flags.get_flags(["quantized_gemm"])
    yield
    jax_ref.flags.set_flags(jkeep)
    pt_flags.set_flags(pkeep)


def _save_jax_fc_stack(ref, model_dir, seed=7):
    main, startup = ref.framework.Program(), ref.framework.Program()
    with ref.fluid.unique_name.guard(), ref.fluid.program_guard(main, startup):
        x = ref.fluid.layers.data(name="qx", shape=[D_IN], dtype="float32")
        h = ref.fluid.layers.fc(x, size=HIDDEN, act="relu")
        y = ref.fluid.layers.fc(h, size=CLASSES)
    exe = ref.fluid.Executor(ref.fluid.CPUPlace())
    with ref.scope_guard(ref.Scope(seed=seed)):
        exe.run(startup)
        ref.fluid.io.save_inference_model(model_dir, ["qx"], [y], exe, main_program=main)
    return main


def _calib(rng, n=4):
    return [{"qx": rng.randn(8, D_IN).astype("float32")} for _ in range(n)]


# ------------------------------------------------------------ quant GEMM


def _gemm_operands(form, m, k, n, seed):
    rng = np.random.RandomState(seed)
    if form == "int8":
        x = rng.randint(-127, 128, (m, k)).astype(np.int8)
        w = rng.randint(-127, 128, (k, n)).astype(np.int8)
        scale = np.float32(0.02 / 127) * np.float32(0.05 / 127)
    else:
        x = np.clip(rng.randn(m, k) * 8, -448, 448).astype(np.float32)
        w = np.clip(rng.randn(k, n), -448, 448).astype(np.float32)
        scale = np.float32(0.125)
    bias = rng.randn(n).astype(np.float32)
    return x, w, scale, bias


def _port_operands(form, x, w, scale, bias, device="cpu"):
    dt = torch.int8 if form == "int8" else torch.float8_e4m3fn
    xt = torch.from_numpy(x).to(device).to(dt)
    wt = torch.from_numpy(w).to(device).to(dt)
    return xt, wt, torch.tensor(scale, device=device), torch.from_numpy(bias).to(device)


@pytest.mark.parametrize("form,act", [("int8", None), ("int8", "relu"), ("int8", "gelu"),
                                      ("fp8", None), ("fp8", "relu")])
def test_quant_gemm_plain_matches_jax_kernel(jax_ref, restore_flags, form, act):
    jnp = jax_ref.jnp
    x, w, scale, bias = _gemm_operands(form, 64, 256, 128, seed=len(str(act)) + len(form))
    jax_ref.flags.set_flags({"quantized_gemm": "on"})
    jdt = jnp.int8 if form == "int8" else jnp.float8_e4m3fn
    before = jax_ref.pk.KERNEL_DISPATCHES.get("gemm_" + form, 0)
    jz, jy = jax_ref.pk.quant_gemm_bias_act(
        jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt), scale, jnp.asarray(bias),
        act=act, interpret=True,
    )
    assert jax_ref.pk.KERNEL_DISPATCHES.get("gemm_" + form, 0) == before + 1  # the kernel ran
    z, y = qg.quant_gemm_bias_act(*_port_operands(form, x, w, scale, bias), act=act)
    rtol = 1e-6 if form == "int8" and act in (None, "relu") else 1e-5
    for got, want in ((z, jz), (y, jy)):
        if want is None:
            assert got is None
            continue
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                                   atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("m,n,k", [(64, 128, 256), (250, 2048, 2048), (256, 16, 2048),
                                   (1024, 2048, 2048), (48, 128, 128), (100, 384, 256),
                                   (32, 128, 96)])
@pytest.mark.parametrize("mode", ["on", "off"])
def test_quant_gemm_path_taken_matches_jax(jax_ref, restore_flags, m, n, k, mode):
    """The port's "auto" takes the shapes the JAX package's "on" takes (and
    "off" declines in both), so both run the same chains through their
    kernels."""
    jax_ref.flags.set_flags({"quantized_gemm": mode})
    pt_flags.set_flags({"quantized_gemm": "auto" if mode == "on" else "off"})
    for jdt, pdt in ((jax_ref.jnp.int8, torch.int8),
                     (jax_ref.jnp.float8_e4m3fn, torch.float8_e4m3fn),
                     (jax_ref.jnp.float32, torch.float32)):
        assert (fused.quant_gemm_path_taken(m, n, k, pdt)
                == jax_ref.pk.quant_gemm_path_taken(m, n, k, jdt))


def _fp8_values(m, k, n, seed):
    """e4m3 operands as the smoke run makes them (x ~ 8 N(0, 1), w ~ N(0,
    1), rounded to e4m3), as float64 tensors."""
    x, w, _, _ = _gemm_operands("fp8", m, k, n, seed)
    f8 = torch.float8_e4m3fn
    return torch.from_numpy(x).to(f8).double(), torch.from_numpy(w).to(f8).double()


def _keep_13_bits(v):
    """v (f64) rounded to f32, then cut to 13 mantissa bits (truncation)."""
    return (v.float().view(torch.int32) & ~((1 << 10) - 1)).view(torch.float32).double()


@pytest.mark.parametrize("k", [2048, 8192])
def test_e4m3_stage_sums_hold_the_quant_tolerance(k):
    """An emulation of the e4m3 form's summation argument in plain torch:
    it runs no port kernel and guards none (the `cuda` cases below hold the
    kernel). The kernel widens e4m3 operands to f16 (exact), so each
    product is exact, sums each 64-deep stage from 0 in f32 and adds it to
    an f32 accumulator: against the f64 product that stays within rtol
    1e-5 and atol 1e-5 of max |z|. wgmma's own e4m3 product keeps about 13
    mantissa bits in its sums; emulated as a cut to 13 bits after every
    32-deep step, with every 128-deep stage summed from 0 and added in f32,
    it misses that tolerance, which is why the kernel does not use it."""
    x, w = _fp8_values(128, k, 128, seed=k)
    exact = x @ w
    tol = 1e-5 * float(exact.abs().max())
    acc = torch.zeros(128, 128, dtype=torch.float32)
    for k0 in range(0, k, 64):
        acc = acc + x[:, k0:k0 + 64].float() @ w[k0:k0 + 64].float()
    torch.testing.assert_close(acc.double(), exact, rtol=1e-5, atol=tol)
    short = torch.zeros(128, 128, dtype=torch.float32)
    for k0 in range(0, k, 128):
        part = torch.zeros(128, 128, dtype=torch.float64)
        for k1 in range(k0, k0 + 128, 32):
            part = _keep_13_bits(part + x[:, k1:k1 + 32] @ w[k1:k1 + 32])
        short = short + part.float()
    assert not torch.allclose(short.double(), exact, rtol=1e-5, atol=tol)


def test_quant_gemm_cpu_tensors_take_the_plain_version_uncounted():
    x, w, scale, bias = _gemm_operands("int8", 32, 64, 48, seed=3)
    args = _port_operands("int8", x, w, scale, bias)
    before = qg.kernel_launches()
    z, y = qg.quant_gemm_bias_act(*args, act="relu")
    zp, yp = qg.quant_gemm_bias_act_plain(*args, act="relu")
    assert torch.equal(z, zp) and torch.equal(y, yp)
    assert qg.kernel_launches() == before


# ------------------------------------------------------------- quant ops

_X = np.linspace(-2.0, 2.0, 64, dtype=np.float32).reshape(8, 8)
OP_CASES = {
    "fake_quantize_abs_max": ({"X": [_X]}, {"bit_length": 8}),
    "fake_quantize_range_abs_max_train": (
        {"X": [_X], "InScale": [np.array([2.5], np.float32)]}, {"bit_length": 8}),
    "fake_quantize_range_abs_max_test": (
        {"X": [_X], "InScale": [np.array([1.5], np.float32)]}, {"bit_length": 8, "is_test": True}),
    "fake_dequantize_max_abs": (
        {"X": [np.round(_X * 60)], "Scale": [np.array([1.7], np.float32)]}, {"max_range": 127.0}),
    "quantize_abs_max": ({"X": [_X * 3]}, {"bit_length": 8}),
    # absmax 2 > the frozen scale 1.5: the tails saturate
    "quantize_static": ({"X": [_X], "Scale": [np.array([1.5], np.float32)]}, {"bit_length": 8}),
    "quantize_static_zero_scale": (
        {"X": [_X], "Scale": [np.zeros(1, np.float32)]}, {"bit_length": 8}),
    "int8_mul": (
        {"X": [np.arange(-60, 60, dtype=np.int8).reshape(2, 3, 20)],
         "Y": [np.arange(-100, 100, dtype=np.int8).reshape(20, 10)]},
        {"x_num_col_dims": 2, "y_num_col_dims": 1}),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_quant_op_matches_jax(jax_ref, case):
    ins, attrs = OP_CASES[case]
    op_type = case.replace("_train", "").replace("_test", "").replace("_zero_scale", "")
    jctx = jax_ref.registry.LowerCtx(jax_ref.jax.random.key(0), is_test=True)
    want = jax_ref.registry.get(op_type).lower(
        jctx, {k: [jax_ref.jnp.asarray(a) for a in v] for k, v in ins.items()}, attrs)
    pctx = pt_registry.LowerCtx("cpu", is_test=True)
    got = pt_registry.get(op_type).lower(
        pctx, {k: [torch.from_numpy(np.array(a)) for a in v] for k, v in ins.items()}, attrs)
    assert sorted(got) == sorted(want)
    for slot in want:
        for g, w in zip(got[slot], want[slot]):
            w = np.asarray(w)
            assert str(g.dtype).replace("torch.", "") == str(w.dtype), slot
            np.testing.assert_array_equal(g.numpy(), w)


def test_quantize_static_op_semantics():
    """Saturating symmetric int8 levels from a frozen scale; a zero scale
    does not divide by zero; the fake_dequantize round trip is within half
    a level of the clipped input."""
    ctx = pt_registry.LowerCtx("cpu", is_test=True)
    x = torch.from_numpy(np.linspace(-2.0, 2.0, 64, dtype=np.float32))
    scale = torch.tensor([1.5])
    (q,) = pt_registry.get("quantize_static").lower(
        ctx, {"X": [x], "Scale": [scale]}, {"bit_length": 8})["Out"]
    assert q.dtype == torch.int8
    assert int(q.max()) == 127 and int(q.min()) == -127
    (dq,) = pt_registry.get("fake_dequantize_max_abs").lower(
        ctx, {"X": [q.float()], "Scale": [scale]}, {"max_range": 127.0})["Out"]
    clipped = np.clip(x.numpy(), -1.5, 1.5)
    assert np.abs(dq.numpy() - clipped).max() <= 1.5 / 127.0 + 1e-6
    (q0,) = pt_registry.get("quantize_static").lower(
        ctx, {"X": [x], "Scale": [torch.zeros(1)]}, {"bit_length": 8})["Out"]
    assert torch.isfinite(q0.float()).all()


def test_percentile_matches_numpy():
    from paddle_tpu_torch.passes.quant import percentile

    a = np.abs(np.random.RandomState(5).randn(1001).astype(np.float32))
    for q in (0.0, 50.0, 99.9, 100.0):
        assert percentile(torch.from_numpy(a), q) == pytest.approx(
            float(np.percentile(a, q)), rel=1e-6)


# ------------------------------------------------------------------- io


def _program_view(program):
    return [(op.type, {k: list(v) for k, v in op.inputs.items()},
             {k: list(v) for k, v in op.outputs.items()})
            for op in program.global_block().ops]


def _saved_arrays(model_dir):
    return {f[:-4]: np.load(os.path.join(model_dir, f)) for f in sorted(os.listdir(model_dir))
            if f.endswith(".npy")}


def test_io_reads_what_jax_writes(jax_ref, tmp_path):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io as pio

    md = str(tmp_path / "jax_model")
    _save_jax_fc_stack(jax_ref, md)
    scope = pt.Scope(place=CPUPlace())
    with pt.scope_guard(scope):
        prog, feeds, fetches = pio.load_inference_model(md, pt.Executor(CPUPlace()))
    with open(os.path.join(md, "__model__")) as f:
        doc = json.load(f)
    jprog = jax_ref.framework.Program.from_dict(doc)
    assert _program_view(prog) == _program_view(jprog)
    assert feeds == ["qx"] and [v.name for v in fetches] == doc["fetch_var_names"]
    arrays = _saved_arrays(md)
    assert sorted(arrays) == sorted(n for n in scope.vars)
    for name, arr in arrays.items():
        np.testing.assert_array_equal(scope.vars[name].numpy(), arr)
    from paddle_tpu import io as jio

    assert pio.inference_model_fingerprint(md) == jio.inference_model_fingerprint(md)


def test_jax_reads_what_io_writes(jax_ref, tmp_path):
    """A model built, initialised and saved by the port loads in the JAX
    package; a bf16 var and the combined-file form round-trip too."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io as pio
    from paddle_tpu import io as jio

    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="qx", shape=[D_IN], dtype="float32")
        h = pt.layers.fc(x, size=HIDDEN, act="relu")
        y = pt.layers.fc(h, size=CLASSES)
    scope = pt.Scope(seed=3, place=CPUPlace())
    exe = pt.Executor(CPUPlace())
    md = str(tmp_path / "port_model")
    with pt.scope_guard(scope):
        exe.run(startup)
        pio.save_inference_model(md, ["qx"], [y], exe, main_program=main)
    jscope = jax_ref.Scope()
    with jax_ref.scope_guard(jscope):
        jprog, jfeeds, jfetches = jio.load_inference_model(md, jax_ref.fluid.Executor())
    pprog = pt.Program.from_dict(json.load(open(os.path.join(md, "__model__"))))
    assert _program_view(jprog) == _program_view(pprog)
    assert jfeeds == ["qx"] and [v.name for v in jfetches] == [y.name]
    for name in _saved_arrays(md):
        np.testing.assert_array_equal(np.asarray(jscope.vars[name]), scope.vars[name].numpy())
    # bf16 and the combined file, port -> JAX -> port
    bf = torch.from_numpy(np.linspace(-3, 3, 12, dtype=np.float32)).to(torch.bfloat16)
    scope.vars["bf"] = bf
    with pt.scope_guard(scope):
        pio.save_vars(exe, str(tmp_path / "c"), main, vars=["bf", "fc_0.w_0"], filename="all")
    with jax_ref.scope_guard(jscope):
        jio.load_vars(None, str(tmp_path / "c"), None, vars=["bf", "fc_0.w_0"], filename="all")
    assert str(jscope.vars["bf"].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(jscope.vars["bf"], np.float32), bf.float().numpy())
    back = pt.Scope(place=CPUPlace())
    with pt.scope_guard(back):
        pio.load_vars(None, str(tmp_path / "c"), main, vars=["bf"], filename="all")
    assert back.vars["bf"].dtype == torch.bfloat16 and torch.equal(back.vars["bf"], bf)


# --------------------------------------------------------- inference_int8


@pytest.fixture(scope="module")
def int8_engines(jax_ref, tmp_path_factory):
    """The JAX and port int8 ServingEngines over one JAX-saved fc stack,
    calibrated on the same feeds, both with their quant GEMM path on (the
    JAX kernel in interpret mode)."""
    from paddle_tpu_torch.serving import ServingEngine

    md = str(tmp_path_factory.mktemp("int8") / "qmlp")
    _save_jax_fc_stack(jax_ref, md)
    calib = _calib(np.random.RandomState(0))
    jkeep, pkeep = jax_ref.flags.get_flags(["quantized_gemm"]), pt_flags.get_flags(
        ["quantized_gemm"])
    jax_ref.flags.set_flags({"quantized_gemm": "on"})
    pt_flags.set_flags({"quantized_gemm": "auto"})
    try:
        je = jax_ref.ServingEngine(md, name="tq_jax_i8", cache_dir=None, precision="int8",
                                   calibration_feeds=calib)
        pe = ServingEngine(md, name="tq_port_i8", place=CPUPlace(), precision="int8",
                           calibration_feeds=calib)
        pf32 = ServingEngine(md, name="tq_port_f32", place=CPUPlace())
    finally:
        jax_ref.flags.set_flags(jkeep)
        pt_flags.set_flags(pkeep)
    return je, pe, pf32


def test_inference_int8_preset_matches_jax(jax_ref):
    from paddle_tpu.passes import manager as jmanager
    from paddle_tpu_torch.passes import manager as pmanager

    assert pmanager.PRESETS["inference_int8"] == jmanager.PRESETS["inference_int8"]


def test_inference_int8_rewrites_like_jax(int8_engines):
    je, pe, _ = int8_engines
    jops, pops = je.program.global_block().ops, pe.program.global_block().ops
    assert [(op.type, op.input_arg_names, op.output_arg_names) for op in pops] == [
        (op.type, op.input_arg_names, op.output_arg_names) for op in jops]
    assert [op.attrs.get("__pallas_group__") for op in pops] == [
        op.attrs.get("__pallas_group__") for op in jops]
    jvars, pvars = je.program.global_block().vars, pe.program.global_block().vars
    assert sorted(jvars) == sorted(pvars)
    for name in jvars:
        assert str(pvars[name].dtype) == str(jvars[name].dtype), name
    assert pe.stats()["quant"] == je.stats()["quant"] == {
        "quantized_muls": 2, "weights_frozen": 2, "fused_groups": 2,
        "calibrated_ranges": je.stats()["quant"]["calibrated_ranges"]}
    for key in ("quantize_serving", "fuse_quant_gemm"):
        assert pe.quant_results[key] == je.quant_results[key]
    assert pe.quant_results["calibrate"]["feeds_run"] == je.quant_results["calibrate"]["feeds_run"]


def test_inference_int8_freezes_like_jax(int8_engines):
    """Frozen int8 weights and both scale consts of every quantized mul are
    bit for bit; the calibrated ranges agree (fed activations exactly)."""
    je, pe, _ = int8_engines
    frozen = je.quant_results["quantize_serving"]["weights_frozen"]
    consts = [n for n in je.scope.vars if n.endswith(".scale.frozen") or n.endswith(".calib.scale")]
    assert len(consts) == 4
    for name in list(frozen) + consts:
        want = np.asarray(je.scope.vars[name])
        got = pe.scope.vars[name].numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    jr = je.quant_results["calibrate"]["ranges"]
    pr = pe.quant_results["calibrate"]["ranges"]
    assert sorted(jr) == sorted(pr)
    assert pr["qx"] == jr["qx"]
    for name in jr:
        assert pr[name] == pytest.approx(jr[name], rel=1e-6), name


def test_int8_serving_engine_matches_jax(jax_ref, int8_engines, restore_flags):
    je, pe, pf32 = int8_engines
    jax_ref.flags.set_flags({"quantized_gemm": "on"})
    x = np.random.RandomState(1).randn(32, D_IN).astype("float32")
    before = jax_ref.pk.KERNEL_DISPATCHES.get("gemm_int8", 0)
    (want,) = je.run({"qx": x})
    jdisp = jax_ref.pk.KERNEL_DISPATCHES.get("gemm_int8", 0) - before
    fused.reset_stats()
    (got,) = pe.run({"qx": x})
    assert fused.stats()["dispatches"].get("gemm_int8", 0) == jdisp == 2
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(want)).max())
    (ref,) = pf32.run({"qx": x})
    assert np.abs(got - ref).max() / np.abs(ref).max() < 0.05


def test_gemm_int8_family_matches_per_op_lowering(int8_engines, restore_flags):
    """The fused family (one combined scale, epilogue on the wide sums)
    against the same program lowered op by op (quantized_gemm off)."""
    from paddle_tpu_torch.executor import aot_serve_lowering, scope_guard

    _, pe, _ = int8_engines
    x = np.random.RandomState(2).randn(16, D_IN).astype("float32")
    pt_flags.set_flags({"quantized_gemm": "off"})
    with scope_guard(pe.scope):
        serve, ro, mut = aot_serve_lowering(pe.program, pe.feed_names, pe.fetch_names, pe.scope,
                                            pass_pipeline="off")
    fused.reset_stats()
    (per_op,) = serve({"qx": x}, ro, mut)
    assert fused.stats()["dispatches"] == {}
    pt_flags.set_flags({"quantized_gemm": "auto"})
    (fused_out,) = serve({"qx": x}, ro, mut)
    np.testing.assert_allclose(fused_out.numpy(), per_op.numpy(), rtol=1e-5,
                               atol=1e-5 * float(per_op.abs().max()))


def test_engine_buckets_pad_and_slice(int8_engines):
    """Rows pad to the bucket and slice back; an oversize batch chunks
    through the largest bucket; warmup builds one variant per bucket and
    the hot path builds none."""
    _, pe, pf32 = int8_engines
    n = pf32.warmup()
    assert n == len(pf32.batch_buckets)
    x = np.random.RandomState(4).randn(70, D_IN).astype("float32")
    (whole,) = pf32.run({"qx": x})
    assert whole.shape == (70, CLASSES) and pf32.traces == n
    (part,) = pf32.run({"qx": x[:5]})
    np.testing.assert_allclose(part, whole[:5], rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        pf32.run({"qy": x})


def test_engine_set_params_hot_swaps(tmp_path, jax_ref):
    """set_params replaces parameter values without a rebuild: the output
    follows the new weights, the version advances, a shape change raises."""
    from paddle_tpu_torch.serving import ServingEngine

    md = str(tmp_path / "m")
    _save_jax_fc_stack(jax_ref, md)
    eng = ServingEngine(md, name="tq_swap", place=CPUPlace())
    x = np.random.RandomState(6).randn(4, D_IN).astype("float32")
    (before,) = eng.run({"qx": x})
    traces = eng.traces
    bias = eng.scope.vars["fc_1.b_0"].numpy()
    assert eng.set_params({"fc_1.b_0": bias + 1.0, "not_a_param": np.zeros(3)}) == 1
    (after,) = eng.run({"qx": x})
    np.testing.assert_allclose(after, before + 1.0, rtol=1e-6, atol=1e-6)
    assert eng.model_version == 1 and eng.traces == traces
    with pytest.raises(ValueError, match="hot swap"):
        eng.set_params({"fc_1.b_0": np.zeros(CLASSES + 1, np.float32)})


def test_analysis_facts_match_jax(jax_ref, tmp_path):
    from paddle_tpu.analysis import analyze_program as janalyze
    from paddle_tpu_torch.analysis import analyze_program as panalyze

    jprog = _save_jax_fc_stack(jax_ref, str(tmp_path / "m"))
    import paddle_tpu_torch as pt

    pprog = pt.Program.from_dict(jprog.to_dict())
    jrep = janalyze(jprog, feed_names=["qx"], mode="inference")
    prep = panalyze(pprog, feed_names=["qx"], mode="inference")
    assert sorted(jrep.facts) == sorted(prep.facts)
    for name, jf in jrep.facts.items():
        pf = prep.facts[name]
        assert (pf.kind, pf.dtype, pf.concrete_shape()) == (
            jf.kind, jf.dtype, jf.concrete_shape()), name
    assert [r.note for r in prep.records] == [r.note for r in jrep.records]


def test_int8_engine_requires_calibration_feeds(tmp_path, jax_ref):
    from paddle_tpu_torch.serving import ServingEngine

    md = str(tmp_path / "m")
    _save_jax_fc_stack(jax_ref, md)
    with pytest.raises(ValueError):
        ServingEngine(md, place=CPUPlace(), precision="int8")
    with pytest.raises(NotImplementedError):
        ServingEngine(md, place=CPUPlace(), cache_dir=str(tmp_path / "cache"))


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the quant GEMM kernel has no CPU form")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("form,act", [("int8", None), ("int8", "relu"), ("int8", "gelu"),
                                      ("int8", "tanh"), ("int8", "sigmoid"), ("fp8", None),
                                      ("fp8", "relu")])
@pytest.mark.parametrize("m,k,n", [(256, 2048, 2048), (100, 48, 80)])
def test_cuda_quant_gemm_matches_plain(cuda_device, form, act, m, k, n):
    x, w, scale, bias = _gemm_operands(form, m, k, n, seed=m + len(form))
    args = _port_operands(form, x, w, scale, bias, cuda_device)
    key = "quant_gemm_" + form
    before = qg.kernel_launches()[key]
    z, y = qg.quant_gemm_bias_act(*args, act=act)
    torch.cuda.synchronize()
    assert qg.kernel_launches()[key] == before + 1
    zp, yp = qg.quant_gemm_bias_act_plain(*args, act=act)
    if form == "int8":
        assert torch.equal(z, zp)
        if act == "relu":
            assert torch.equal(y, yp)
        elif act:
            torch.testing.assert_close(y, yp, rtol=1e-5, atol=1e-5)
    else:
        tol = 1e-5 * float(zp.abs().max())
        torch.testing.assert_close(z, zp, rtol=1e-5, atol=tol)
        if act:
            torch.testing.assert_close(y, yp, rtol=1e-5, atol=tol)


# the kernel's edges: one row, a ragged row tile, path B's batch and single
# shot; k from one 16-byte step past a ring stage (2064) to the long e4m3
# sum (8192); n one 16-column group, or 16 past a 128-column tile
EDGE_M = [1, 17, 250, 1024]
EDGE_K = [16, 48, 2064, 8192]
EDGE_N = [16, 2064]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["int8", "fp8"])
@pytest.mark.parametrize("m,k,n", [(m, k, n) for m in EDGE_M for k in EDGE_K for n in EDGE_N]
                         + [(1000, 2064, 2064)])
def test_cuda_quant_gemm_edges(cuda_device, form, m, k, n):
    """Every act at an edge shape against the plain version (int8 z bit for
    bit, y bit for bit at relu; e4m3 within rtol 1e-5 of max |z|), each
    call repeated bit for bit. The kernel takes 64-row CTA tiles where
    128-row ones would be at most 66, so m = 1024 and the ragged m = 1000
    at n = 2064 reach its 128-row tile and every other shape its 64-row
    one."""
    x, w, scale, bias = _gemm_operands(form, m, k, n, seed=m * 7 + k + n)
    args = _port_operands(form, x, w, scale, bias, cuda_device)
    zp, _ = qg.quant_gemm_bias_act_plain(*args)
    tol = 1e-5 * float(zp.abs().max())
    for act in (None, "relu", "gelu", "tanh", "sigmoid"):
        yp = ACT_F32[act](zp) if act else None
        z, y = qg.quant_gemm_bias_act(*args, act=act)
        z2, y2 = qg.quant_gemm_bias_act(*args, act=act)
        torch.cuda.synchronize()
        assert torch.equal(z, z2) and (act is None or torch.equal(y, y2))
        if form == "int8":
            assert torch.equal(z, zp)
            if act == "relu":
                assert torch.equal(y, yp)
            elif act:
                torch.testing.assert_close(y, yp, rtol=1e-5, atol=1e-5)
        else:
            torch.testing.assert_close(z, zp, rtol=1e-5, atol=tol)
            if act:
                torch.testing.assert_close(y, yp, rtol=1e-5, atol=tol)


def test_fc_head_fitted_by_port_serves_int8_like_jax(jax_ref, restore_flags, tmp_path):
    """Path B at a small width: the fc head of the JAX package's int8 bench
    (bench.py:2031-2064; 3 x fc(relu) + a 16-wide head) fitted by the
    port's Executor + Adam, saved by the port's io, then served int8 by
    both packages from that directory on the same calibration feeds. The
    16-wide head declines the quant GEMM path in both (bn % 128), so a
    250-row call takes it on the 3 hidden layers in both; outputs within
    1e-5; top-1 against the f32 engine within the bench's 0.005."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.serving import ServingEngine

    d_model, classes = 256, 16
    means = np.random.RandomState(101).randn(classes, d_model)

    def batch(rng, bs):
        y = rng.randint(0, classes, (bs, 1)).astype("int64")
        return (means[y.reshape(-1)] + 0.7 * rng.randn(bs, d_model)).astype("float32"), y

    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.layers.data(name="img", shape=[d_model], dtype="float32")
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        h = img
        for _ in range(3):
            h = pt.layers.fc(h, size=d_model, act="relu")
        logits = pt.layers.fc(h, size=classes)
        loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(logits, label))
        pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    exe, scope = pt.Executor(CPUPlace()), pt.Scope(seed=11, place=CPUPlace())
    rng = np.random.RandomState(11)
    md = str(tmp_path / "fc_head")
    losses = []
    with pt.scope_guard(scope):
        exe.run(startup)
        for _ in range(8):
            x, y = batch(rng, 64)
            losses.append(float(exe.run(main, feed={"img": x, "label": y},
                                        fetch_list=[loss.name])[0]))
        pt.io.save_inference_model(md, ["img"], [logits], exe, main_program=main)
    assert losses[-1] < losses[0]
    rng = np.random.RandomState(3)
    calib = [{"img": batch(rng, 16)[0]} for _ in range(8)]
    jax_ref.flags.set_flags({"quantized_gemm": "on"})
    je = jax_ref.ServingEngine(md, name="tq_head_jax", cache_dir=None, batch_buckets=(256,),
                               precision="int8", calibration_feeds=calib)
    pe = ServingEngine(md, name="tq_head_port", place=CPUPlace(), batch_buckets=(256,),
                       precision="int8", calibration_feeds=calib)
    p32 = ServingEngine(md, name="tq_head_f32", place=CPUPlace(), batch_buckets=(256,))
    assert pe.stats()["quant"] == je.stats()["quant"]
    assert pe.stats()["quant"]["fused_groups"] == 4
    x, y = batch(rng, 250)
    before = jax_ref.pk.KERNEL_DISPATCHES.get("gemm_int8", 0)
    (want,) = je.run({"img": x})
    jdisp = jax_ref.pk.KERNEL_DISPATCHES.get("gemm_int8", 0) - before
    fused.reset_stats()
    (got,) = pe.run({"img": x})
    assert fused.stats()["dispatches"]["gemm_int8"] == jdisp == 3
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    (ref,) = p32.run({"img": x})
    yy = y.reshape(-1)
    delta = abs(int((ref.argmax(-1) == yy).sum()) - int((got.argmax(-1) == yy).sum())) / 250
    assert delta <= 0.005
