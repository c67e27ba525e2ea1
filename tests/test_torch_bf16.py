"""bf16 mixed precision and FLAGS_fp8_matmul in the torch port, on the CPU:

- the four TestBf16Transpiler cases of tests/test_transpiler.py in the
  port (train mode's f32 masters and w@BF16 casts with its convergence
  gate, an island inside a While sub-block, the retyped fill_constant
  seeds, freeze mode for inference);
- the rewritten Program of a small ResNet (resnet_cifar10, depth 8), a
  small stacked LSTM and a small Transformer equal to the JAX package's:
  every op's type, inputs, outputs and dtype attrs, and every var's dtype,
  in every block;
- 3 bf16 steps of each model under training_fused from the JAX package's
  startup state against the port's own f32 run from the same state, within
  the JAX package's bf16 bar (rtol 5e-2, atol 2e-2,
  tests/test_transpiler.py:515); masters and moments stay f32; the fused
  families dispatch the same runs as the JAX package's on the bf16
  Program (the GEMM chains' block rule is dtype-blind, and multi_adam's
  dtype groups are the same);
- fp8_matmul: the flag test of tests/test_quant.py:304-328 in the port;
  the plain version against the JAX function at 2-D, ragged, batched and
  broadcast shapes, f32 and bf16 operands, values past e4m3's 448 (NaN
  where the JAX function gives NaN), within rtol 1e-6 of max |out|; the
  e4m3 rounding against ml_dtypes bit for bit; the gradient against
  jax.vjp of the JAX function;
- every optimizer lowering over an f32 master and a bf16 grad (train
  mode's inputs) against the JAX lowering, its outputs f32.
"""

import importlib

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import pallas_kernels as jpk
from paddle_tpu.transpiler.bf16_transpiler import Bf16Transpiler as JBf16
from paddle_tpu_torch import convert
from paddle_tpu_torch.ops import fused, quant_gemm
from paddle_tpu_torch.tools import profile_rnn as rnn
from paddle_tpu_torch.transpiler import Bf16Transpiler

from torch_rnn_cases import PACKAGES, build, exe_scope
from torch_transformer_case import SMALL as TRANSFORMER_SMALL
from torch_transformer_case import make_batch as transformer_batch

BF16_RTOL, BF16_ATOL = 5e-2, 2e-2
FP8_RTOL = 1e-6  # of max |out|: the same e4m3 values, f32 sums in another order
LSTM_SMALL = dict(dict_dim=50, emb_dim=16, hid_dim=16, stacked_num=2, class_num=2, batch=4,
                  seq_len=7, lr=2e-3)


def _fluid(pkg):
    return importlib.import_module(pkg + ".fluid")


def _bf16(pkg):
    return JBf16 if pkg == "paddle_tpu" else Bf16Transpiler


# ---------------------------------------------------------------------------
# tests/test_transpiler.py TestBf16Transpiler, in the port
# ---------------------------------------------------------------------------


def test_train_mode_master_weights():
    """f32 masters in the scope, w@BF16 casts and bf16 activations in the
    Program, 20 Adam steps that halve the loss, state dtypes stable."""
    import paddle_tpu_torch.fluid as fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="bx", shape=[8], dtype="float32")
        y = fluid.layers.data(name="by", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, size=32, act="relu")
        logits = fluid.layers.fc(h, size=4)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.Adam(learning_rate=5e-2).minimize(loss)
    rng = np.random.RandomState(0)
    xb = rng.randn(16, 8).astype(np.float32)
    yb = rng.randint(0, 4, (16, 1)).astype(np.int64)
    exe, scope, guard = exe_scope("paddle_tpu_torch", seed=7)
    with guard(scope):
        exe.run(startup)
        Bf16Transpiler().transpile(main)
        gb = main.global_block()
        w = [n for n in gb.vars if n.endswith(".w_0")][0]
        assert gb.var(w).dtype == "float32"
        assert gb.has_var(w + "@BF16") and gb.var(w + "@BF16").dtype == "bfloat16"
        assert gb.var(h.name).dtype == "bfloat16"
        losses = []
        for _ in range(20):
            (lv,) = exe.run(main, feed={"bx": xb, "by": yb}, fetch_list=[loss.name])
            losses.append(float(np.asarray(lv).ravel()[0]))
        assert losses[-1] < losses[0] * 0.5, losses
        assert scope.find_var(w).dtype == torch.float32
        m1 = [n for n in scope.vars if "moment1" in n]
        assert m1 and all(scope.find_var(n).dtype == torch.float32 for n in m1)


def test_train_mode_island_in_sub_block():
    import paddle_tpu_torch.fluid as fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="wx", shape=[4], dtype="float32")
        h = fluid.layers.fc(x, size=4)
        i = fluid.layers.fill_constant(shape=[1], dtype="int64", value=0)
        n = fluid.layers.fill_constant(shape=[1], dtype="int64", value=2)
        cond = fluid.layers.less_than(x=i, y=n)
        acc = fluid.layers.fill_constant(shape=[1], dtype="float32", value=0.0)
        w = fluid.layers.While(cond=cond)
        with w.block():
            sm = fluid.layers.softmax(h)
            s = fluid.layers.mean(sm)
            fluid.layers.assign(fluid.layers.sums([acc, s]), acc)
            i2 = fluid.layers.increment(i, value=1, in_place=True)
            fluid.layers.less_than(x=i2, y=n, cond=cond)
        loss = fluid.layers.mean(h) + 0.0 * acc
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    Bf16Transpiler().transpile(main)
    exe, scope, guard = exe_scope("paddle_tpu_torch")
    with guard(scope):
        exe.run(startup)
        (lv,) = exe.run(main, feed={"wx": np.ones((2, 4), np.float32)}, fetch_list=[loss.name])
    assert np.isfinite(np.asarray(lv, np.float32)).all()


def test_train_mode_fill_constant_retyped():
    import paddle_tpu_torch.fluid as fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="fx", shape=[4], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.fc(x, size=1))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    Bf16Transpiler().transpile(main)
    gb = main.global_block()
    seeds = [op for op in gb.ops if op.type == "fill_constant"
             and any(n.endswith("@GRAD") for ns in op.outputs.values() for n in ns)]
    assert seeds
    for op in seeds:
        out = [n for ns in op.outputs.values() for n in ns][0]
        assert gb.var(out).dtype == "bfloat16"
        assert str(op.attrs["dtype"]) == "bfloat16"


def test_inference_bf16():
    import paddle_tpu_torch.fluid as fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[32], dtype="float32")
        h = fluid.layers.fc(x, size=64, act="relu")
        prob = fluid.layers.softmax(fluid.layers.fc(h, size=10))
    infer = main.clone(for_test=True)
    xb = np.random.RandomState(4).randn(8, 32).astype(np.float32)
    exe, scope, guard = exe_scope("paddle_tpu_torch", seed=13)
    with guard(scope):
        exe.run(startup)
        (before,) = exe.run(infer, feed={"x": xb}, fetch_list=[prob])
        Bf16Transpiler().transpile(infer, scope=scope)
        assert infer.global_block().var(h.name).dtype == "bfloat16"
        assert all(scope.find_var(p.name).dtype == torch.bfloat16
                   for p in infer.global_block().all_parameters())
        (after,) = exe.run(infer, feed={"x": xb}, fetch_list=[prob])
    np.testing.assert_allclose(before, after, rtol=0.05, atol=0.02)


# ---------------------------------------------------------------------------
# the rewritten Programs of three models, and 3 bf16 steps of each
# ---------------------------------------------------------------------------


def _resnet_fn(fluid):
    pkg = fluid.__name__.split(".")[0]
    resnet = importlib.import_module(pkg + ".models.resnet")
    img = fluid.layers.data(name="img", shape=[3, 16, 16], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    loss, _, _ = resnet.resnet_cifar10(img, label, depth=8, class_num=10)
    fluid.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
    return [loss]


def _resnet_feeds(n):
    rng = np.random.RandomState(21)
    return [{"img": rng.randn(4, 3, 16, 16).astype(np.float32),
             "label": rng.randint(0, 10, (4, 1)).astype(np.int64)} for _ in range(n)]


def _lstm_fn(fluid):
    pkg = fluid.__name__.split(".")[0]
    stacked = importlib.import_module(pkg + ".models.stacked_lstm")
    cfg = LSTM_SMALL
    words = fluid.layers.data(name="words", shape=[1], dtype="int64", lod_level=1)
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    loss, _, _ = stacked.stacked_lstm_net(
        words, label, cfg["dict_dim"], emb_dim=cfg["emb_dim"], hid_dim=cfg["hid_dim"],
        stacked_num=cfg["stacked_num"], class_num=cfg["class_num"])
    fluid.optimizer.Adam(learning_rate=cfg["lr"]).minimize(loss)
    return [loss]


def _lstm_feeds(n):
    return [rnn.lstm_feed(LSTM_SMALL, 5 + i, ragged=True) for i in range(n)]


def _transformer_fn(fluid):
    from torch_transformer_case import build as tbuild

    pkg = fluid.__name__.split(".")[0]
    transformer = importlib.import_module(pkg + ".models.transformer")
    main, startup, loss = tbuild(importlib.import_module(pkg), transformer, TRANSFORMER_SMALL)
    return main, startup, [loss]


def _transformer_feeds(n):
    return [transformer_batch(TRANSFORMER_SMALL, s) for s in range(n)]


MODELS = {
    "resnet": (_resnet_fn, _resnet_feeds),
    "lstm": (_lstm_fn, _lstm_feeds),
    "transformer": (_transformer_fn, _transformer_feeds),
}


def _build_model(pkg, name):
    fn = MODELS[name][0]
    if name == "transformer":
        return fn(_fluid(pkg))
    return build(pkg, fn)


def _program_signature(program):
    ops, dtypes = [], {}
    for blk in program.blocks:
        for op in blk.ops:
            ops.append((blk.idx, op.type, {k: list(v) for k, v in op.inputs.items()},
                        {k: list(v) for k, v in op.outputs.items()},
                        {k: str(op.attrs[k]) for k in ("dtype", "in_dtype", "out_dtype")
                         if k in op.attrs}))
        for n, v in blk.vars.items():
            dtypes[(blk.idx, n)] = str(v.dtype)
    return ops, dtypes


@pytest.mark.parametrize("name", sorted(MODELS))
def test_transpiled_program_matches_jax(name):
    sigs = []
    for pkg in PACKAGES:
        main = _build_model(pkg, name)[0]
        _bf16(pkg)().transpile(main)
        sigs.append(_program_signature(main))
    (jops, jdt), (pops, pdt) = sigs
    assert len(pops) == len(jops)
    for i, (p, j) in enumerate(zip(pops, jops)):
        assert p == j, (i, p, j)
    assert pdt == jdt
    assert any(t == "cast" for _, t, _, _, _ in pops)
    assert "bfloat16" in set(pdt.values())
    # the lookup_table island reads the f32 master table (no w@BF16 cast
    # of the whole table) and its output comes back down through a cast
    for _, t, ins, outs, _ in pops:
        if t == "lookup_table":
            assert not ins["W"][0].endswith("@BF16"), ins
            assert outs["Out"][0].endswith(".f32out"), outs


def _run(pkg, name, steps, bf16, init=None):
    """(losses, final state, dispatches, persistable names, initial state) of
    `steps` steps of `name` in `pkg` under training_fused, from `init` (the
    JAX package's startup state) where given."""
    main, startup, fetch = _build_model(pkg, name)
    feeds = MODELS[name][1](steps)
    names = convert.persistable_names(main)
    flags = importlib.import_module(pkg + ".flags")
    flags.set_flags({"pass_pipeline": "training_fused"})
    jpk.KERNEL_DISPATCHES.clear()
    fused.reset_stats()
    exe, scope, guard = exe_scope(pkg, seed=3)
    try:
        with guard(scope):
            exe.run(startup)
            if pkg == "paddle_tpu":
                init = {n: np.asarray(scope.vars[n]) for n in names}
            else:
                convert.load_into_scope(scope, init, names)
            if bf16:
                _bf16(pkg)().transpile(main)
            losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[fetch[0].name])[0],
                                       np.float32).reshape(-1)[0]) for f in feeds]
            if pkg == "paddle_tpu":
                final = {n: np.asarray(scope.vars[n]) for n in names}
                disp = dict(jpk.KERNEL_DISPATCHES)
            else:
                final = {n: scope.vars[n] for n in names}
                disp = fused.stats()["dispatches"]
    finally:
        flags.set_flags({"pass_pipeline": ""})
    return np.asarray(losses), final, disp, names, init


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bf16_steps_close_to_f32(name):
    """3 bf16 steps against the port's f32 steps from the same weights;
    masters and moments stay f32; each family dispatches a step what the
    JAX package's dispatches on the same bf16 Program."""
    jl, _, jdisp, names, init = _run("paddle_tpu", name, 3, True)
    bl, bstate, bdisp, _, _ = _run("paddle_tpu_torch", name, 3, True, init)
    fl, _, _, _, _ = _run("paddle_tpu_torch", name, 3, False, init)
    np.testing.assert_allclose(bl, fl, rtol=BF16_RTOL, atol=BF16_ATOL)
    assert np.isfinite(jl).all()
    for n in names:
        assert bstate[n].dtype in (torch.float32, torch.int32, torch.int64), (n, bstate[n].dtype)
    # the JAX package counts a family's dispatches once per compile, the
    # port once per run
    assert jdisp and bdisp == {k: 3 * v for k, v in jdisp.items()}


# ---------------------------------------------------------------------------
# fp8_matmul
# ---------------------------------------------------------------------------


def test_fp8_matmul_flag_casts_and_dispatches():
    """tests/test_quant.py:304-328 in the port: with FLAGS_fp8_matmul the fc
    product dispatches matmul_fp8 and stays within e4m3 resolution of the
    f32 product."""
    import paddle_tpu_torch.fluid as fluid

    rng = np.random.RandomState(0)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        a = fluid.layers.data(name="fa", shape=[64], dtype="float32")
        y = fluid.layers.fc(a, size=32)
    x = rng.randn(16, 64).astype("float32")
    outs = []
    for flag in (False, True):
        fluid.set_flags({"fp8_matmul": flag})
        try:
            before = fused.KERNEL_DISPATCHES.get("matmul_fp8", 0)
            exe, scope, guard = exe_scope("paddle_tpu_torch", seed=3)
            with guard(scope):
                exe.run(startup)
                outs.append(exe.run(main, feed={"fa": x}, fetch_list=[y.name])[0])
            moved = fused.KERNEL_DISPATCHES.get("matmul_fp8", 0) - before
            assert (moved > 0) == flag
        finally:
            fluid.set_flags({"fp8_matmul": False})
    ref, got = outs
    rel = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)
    assert 0 < rel < 0.1, rel


def _jax_fp8(x, y):
    out = jpk.fp8_matmul(jnp.asarray(x), jnp.asarray(y))
    return np.asarray(out.astype(jnp.float32))


def _as(a, dtype):
    """(numpy for the JAX function, torch tensor) of `a` in `dtype`."""
    if dtype == "bfloat16":
        a = a.astype(ml_dtypes.bfloat16)
        return a, torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return a, torch.from_numpy(a)


FP8_CASES = {
    "aligned": ((64, 128), (128, 48)),
    "ragged": ((17, 37), (37, 5)),
    "one_row": ((1, 300), (300, 7)),
    "batched": ((16, 8, 32, 24), (16, 8, 24, 40)),
    "broadcast_w": ((3, 9, 20), (20, 11)),
    "broadcast_partial": ((2, 1, 6, 10), (1, 3, 10, 4)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FP8_CASES))
def test_fp8_matmul_plain_matches_jax(case, dtype):
    xs, ys = FP8_CASES[case]
    rng = np.random.RandomState(17)
    x = (rng.randn(*xs) * 60).astype(np.float32)
    y = (rng.randn(*ys) * 60).astype(np.float32)
    # values past e4m3's 448 give NaN in both, a row or column of NaN out
    # (where the operand has a second row or column to keep finite), and
    # 463 rounds to 448
    if xs[-2] > 1:
        x[..., 0, 0] = 500.0
        x[..., -1, -1] = -1e4
    if ys[-1] > 1:
        y[..., 0, -1] = 1e4
    y.reshape(-1)[5::61] = 463.0
    xj, xt = _as(x, dtype)
    yj, yt = _as(y, dtype)
    want = _jax_fp8(xj, yj)
    got = quant_gemm.fp8_matmul(xt, yt)
    assert got.dtype == xt.dtype and tuple(got.shape) == want.shape
    got = got.float().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert ok.any()
    scale = np.abs(want[ok]).max()
    if dtype == "float32":
        np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=FP8_RTOL * scale)
    else:
        # one bf16 rounding of f32 sums within FP8_RTOL of each other
        np.testing.assert_allclose(got[ok], want[ok], rtol=2 ** -8, atol=FP8_RTOL * scale)


def test_e4m3_rounding_matches_ml_dtypes():
    """e4m3_round_plain against ml_dtypes' float8_e4m3fn over every e4m3
    value, the midpoints between neighbours, their neighbours in f32,
    subnormals, zeros, inf, NaN and the band past 448."""
    codes = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn).astype(np.float32)
    fin = np.sort(codes[np.isfinite(codes)])
    mids = (fin[1:] + fin[:-1]) / 2
    vals = np.concatenate([fin, mids, np.nextafter(mids, np.inf, dtype=np.float32),
                           np.nextafter(mids, -np.inf, dtype=np.float32),
                           np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 448.0, 449.0, 463.99,
                                     464.0, 464.01, 480.0, 1e30, -500.0, 2.0 ** -10, 2.0 ** -12,
                                     1e-40], np.float32),
                           np.random.RandomState(0).randn(4096).astype(np.float32) * 100])
    want = vals.astype(ml_dtypes.float8_e4m3fn).astype(np.float32)
    got = quant_gemm.e4m3_round_plain(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_fp8_matmul_grad_matches_jax():
    """The gradient of fp8_matmul (the autograd Function the generic grads
    differentiate through) against jax.vjp of the JAX function."""
    rng = np.random.RandomState(9)
    x = rng.randn(6, 20).astype(np.float32)
    y = rng.randn(20, 5).astype(np.float32)
    g = rng.randn(6, 5).astype(np.float32)
    _, vjp = jax.vjp(jpk.fp8_matmul, jnp.asarray(x), jnp.asarray(y))
    jdx, jdy = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    quant_gemm.fp8_matmul(xt, yt).backward(torch.from_numpy(g))
    for got, want in ((xt.grad.numpy(), jdx), (yt.grad.numpy(), jdy)):
        np.testing.assert_allclose(got, want, rtol=0, atol=FP8_RTOL * np.abs(want).max())
    # through torch.func.vjp, as the port's generic grads run it
    _, pvjp = torch.func.vjp(quant_gemm.fp8_matmul, torch.from_numpy(x), torch.from_numpy(y))
    fdx, _ = pvjp(torch.from_numpy(g))
    np.testing.assert_array_equal(fdx.numpy(), xt.grad.numpy())


# ---------------------------------------------------------------------------
# the optimizer lowerings under bf16 grads with f32 masters (_opt_f32)
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "sgd": ((), {}),
    "momentum": (("Velocity",), {"mu": 0.9}),
    "lars_momentum": (("Velocity",), {"mu": 0.9}),
    "adam": (("Moment1", "Moment2", "Beta1Pow", "Beta2Pow"), {}),
    "adagrad": (("Moment",), {}),
    "decayed_adagrad": (("Moment",), {}),
    "rmsprop": (("MeanSquare", "Moment"), {}),
    "adadelta": (("AvgSquaredGrad", "AvgSquaredUpdate"), {}),
    "adamax": (("Moment", "InfNorm", "Beta1Pow"), {}),
    "ftrl": (("SquaredAccumulator", "LinearAccumulator"), {}),
}


@pytest.mark.parametrize("op_type", sorted(OPTIMIZERS))
def test_optimizer_lowering_bf16_grad_f32_master(op_type):
    """Each optimizer lowering over an f32 master, f32 state and a bf16 grad
    (train mode's inputs) in both packages: every output keeps its input's
    dtype (f32) and matches the JAX lowering within rtol 1e-5, atol 1e-6
    (the same f32 expressions over the same bf16-rounded grad, rounded in
    another order by XLA's fusions: ftrl's sigma divides a difference of
    square roots by lr = 0.01, which moves its last bits)."""
    from paddle_tpu.ops import registry as jreg
    from paddle_tpu_torch.ops import registry as preg

    states, attrs = OPTIMIZERS[op_type]
    rng = np.random.RandomState(13)
    shape = (6, 5)
    f32 = {"Param": rng.randn(*shape), "LearningRate": np.array([0.01])}
    for slot in states:
        f32[slot] = (np.array([0.9 ** 3]) if slot.endswith("Pow")
                     else np.abs(rng.randn(*shape)) + 0.1)
    f32 = {k: v.astype(np.float32) for k, v in f32.items()}
    grad = (rng.randn(*shape) * 0.1).astype(np.float32).astype(ml_dtypes.bfloat16)
    jins = {k: [jnp.asarray(v)] for k, v in f32.items()}
    jins["Grad"] = [jnp.asarray(grad)]
    pins = {k: [torch.from_numpy(v)] for k, v in f32.items()}
    pins["Grad"] = [torch.from_numpy(grad.astype(np.float32)).to(torch.bfloat16)]
    want = jreg.get(op_type).lower(jreg.LowerCtx(jax.random.key(0)), jins, dict(attrs))
    got = preg.get(op_type).lower(preg.LowerCtx("cpu"), pins, dict(attrs))
    assert sorted(got) == sorted(want)
    for slot in want:
        g, w = got[slot][0], np.asarray(want[slot][0])
        assert g.dtype == torch.float32 and w.dtype == np.float32, (slot, g.dtype, w.dtype)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6, err_msg=slot)
