"""The deployment passes and transpilers of the torch port
(paddle_tpu_torch/passes/ports.py, transpiler/inference_transpiler.py,
memory_optimization_transpiler.py, quantize_transpiler.py) against the JAX
package's, on the CPU: the same program is built in both packages, the JAX
package's startup state is carried into the port by name, and each rewrite
must give the same program and the same fetches.

- fold_batch_norm (InferenceTranspiler) on conv2d -> batch_norm and
  conv2d -> elementwise_add -> batch_norm: the same op list, the same folded
  weights within 1e-6, and fetches within the JAX package's own bar (rtol
  1e-4, atol 1e-5; tests/test_transpiler.py:310), before and after;
- memory_optimize: the same {renamed: buffer} mapping, and every fetch bit
  for bit with the program left unrenamed, on an inference CNN and on the
  training program of tests/test_transpiler.py:247 (3 SGD steps);
- quantization-aware training on a small ResNet (resnet_cifar10, depth 8,
  3 x 32 x 32, 10 classes): training_transpile's op list; 2 SGD steps'
  losses within the fused-vs-unfused bar (rtol 2e-3, atol 2e-4); after the
  JAX package's trained state is carried over, freeze_program's int8
  payloads and scales exactly, convert_to_int8's op list, and the int8
  program's logits within 1e-4 (tests/test_transpiler.py:397's bar).
"""

import importlib

import numpy as np
import pytest

import jax

import paddle_tpu_torch as pt
from paddle_tpu_torch import convert

from torch_rnn_cases import build, exe_scope

jax.config.update("jax_platforms", "cpu")

PACKAGES = ("paddle_tpu", "paddle_tpu_torch")
FOLD_RTOL, FOLD_ATOL = 1e-4, 1e-5
FOLD_W_TOL = 1e-6
QAT_RTOL, QAT_ATOL = 2e-3, 2e-4
INT8_TOL = 1e-4


def _listing(prog):
    return [(op.type, sorted(op.inputs.items()), sorted(op.outputs.items()),
             sorted((k, repr(v)) for k, v in op.attrs.items() if not k.startswith("op_")))
            for op in prog.global_block().ops]


def _transpiler(package):
    return importlib.import_module(package + ".transpiler")


def _np_state(package, scope, names):
    if package == "paddle_tpu":
        return {n: np.asarray(scope.vars[n]) for n in names}
    return convert.scope_to_numpy(scope, names)


def _put(package, scope, state):
    """Write {name: array} into the scope, new names included."""
    if package == "paddle_tpu":
        import jax.numpy as jnp

        for n, a in state.items():
            scope.vars[n] = jnp.asarray(a)
    else:
        for n, t in convert.params_from_jax(state, scope.device).items():
            scope.set_var(n, t)


def _fetch(exe, prog, feed, fetch):
    return [np.asarray(v) for v in exe.run(prog, feed=feed, fetch_list=fetch)]


# --------------------------------------------------------------------------
# fold_batch_norm
# --------------------------------------------------------------------------


def _conv_bn(with_bias):
    def program(fluid):
        img = fluid.layers.data(name="img", shape=[3, 8, 8], dtype="float32")
        conv = fluid.layers.conv2d(img, num_filters=4, filter_size=3,
                                   bias_attr=None if with_bias else False)
        conv = fluid.layers.conv2d(conv, num_filters=6, filter_size=3, padding=1, stride=2,
                                   bias_attr=None if with_bias else False)
        bn = fluid.layers.batch_norm(conv)
        return [fluid.layers.relu(bn)]

    return program


@pytest.mark.parametrize("with_bias", [False, True], ids=["conv_bn", "conv_add_bn"])
def test_fold_batch_norm_matches_jax(with_bias):
    rng = np.random.RandomState(2)
    xb = rng.randn(2, 3, 8, 8).astype(np.float32)
    progs = {p: build(p, _conv_bn(with_bias)) for p in PACKAGES}
    bn_op = next(o for o in progs["paddle_tpu"][0].global_block().ops if o.type == "batch_norm")
    stats = {bn_op.input(s)[0]: rng.uniform(lo, hi, (6,)).astype(np.float32)
             for s, lo, hi in (("Mean", -0.5, 0.5), ("Variance", 0.5, 2.0),
                               ("Scale", 0.5, 1.5), ("Bias", -0.3, 0.3))}
    shared, results = None, {}
    for p in PACKAGES:
        main, startup, fetch = progs[p]
        infer = main.clone(for_test=True)
        exe, scope, guard = exe_scope(p, seed=9)
        with guard(scope):
            exe.run(startup)
            names = convert.persistable_names(infer)
            if shared is None:
                _put(p, scope, stats)
                shared = _np_state(p, scope, names)
            else:
                _put(p, scope, shared)
            (before,) = _fetch(exe, infer, {"img": xb}, [fetch[0].name])
            _transpiler(p).InferenceTranspiler().transpile(infer, scope=scope)
            (after,) = _fetch(exe, infer, {"img": xb}, [fetch[0].name])
            folded = _np_state(p, scope, convert.persistable_names(infer))
        results[p] = (_listing(infer), before, after, folded)
    (jl, jb, ja, jw), (pl, pb, pa, pw) = results["paddle_tpu"], results["paddle_tpu_torch"]
    assert pl == jl
    assert "batch_norm" not in [t[0] for t in pl]
    assert sorted(pw) == sorted(jw)
    for n in jw:
        np.testing.assert_allclose(pw[n], jw[n], rtol=FOLD_W_TOL, atol=FOLD_W_TOL, err_msg=n)
    for got, want in ((pb, jb), (pa, ja), (pa, pb)):
        np.testing.assert_allclose(got, want, rtol=FOLD_RTOL, atol=FOLD_ATOL)


# --------------------------------------------------------------------------
# memory_optimize
# --------------------------------------------------------------------------


def _mlp_training(fluid):
    """tests/test_transpiler.py:223-237's program."""
    x = fluid.layers.data(name="x", shape=[32], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="int64")
    h = fluid.layers.fc(x, size=64, act="relu")
    h = fluid.layers.fc(h, size=64, act="relu")
    logits = fluid.layers.fc(h, size=10)
    loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(logits, y))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return [loss]


def _cnn_inference(fluid):
    from importlib import import_module

    models = import_module(fluid.__name__.split(".")[0] + ".models")
    img = fluid.layers.data(name="img", shape=[3, 32, 32], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    _, _, logits = models.resnet_cifar10(img, label, depth=8, class_num=10)
    return [logits]


MEMOPT = {
    "mlp_training": (_mlp_training, False, 3, lambda rng: {
        "x": rng.randn(8, 32).astype(np.float32),
        "y": rng.randint(0, 10, (8, 1)).astype(np.int64)}),
    "resnet8_inference": (_cnn_inference, True, 1, lambda rng: {
        "img": rng.randn(2, 3, 32, 32).astype(np.float32),
        "label": rng.randint(0, 10, (2, 1)).astype(np.int64)}),
}


@pytest.mark.parametrize("case", sorted(MEMOPT))
def test_memory_optimize_matches_jax(case):
    """The same mapping as the JAX package's on the same program, and the
    renamed program's fetches bit for bit with the unrenamed one's, from
    the same state (the backward of the training program reads renamed
    names)."""
    program_fn, for_test, steps, feed_fn = MEMOPT[case]
    feed = feed_fn(np.random.RandomState(1))
    mappings, shared = {}, None
    runs = {}
    for p in PACKAGES:
        for transform in (False, True):
            main, startup, fetch = build(p, program_fn)
            prog = main.clone(for_test=True) if for_test else main
            if transform:
                mappings[p] = _transpiler(p).memory_optimize(
                    prog, skip_opt_set={v.name for v in fetch})
            exe, scope, guard = exe_scope(p, seed=7)
            with guard(scope):
                exe.run(startup)
                names = convert.persistable_names(prog)
                if shared is None:
                    shared = _np_state(p, scope, names)
                _put(p, scope, shared)
                runs[p, transform] = [_fetch(exe, prog, feed, [v.name for v in fetch])
                                      for _ in range(steps)]
    assert mappings["paddle_tpu_torch"] == mappings["paddle_tpu"]
    assert mappings["paddle_tpu_torch"], "expected at least one reused buffer"
    base, renamed = runs["paddle_tpu_torch", False], runs["paddle_tpu_torch", True]
    for b, r in zip(base, renamed):
        for x, y in zip(b, r):
            assert x.tobytes() == y.tobytes()
    for j, q in zip(runs["paddle_tpu", True], renamed):
        for x, y in zip(j, q):
            np.testing.assert_allclose(y, x, rtol=1e-4, atol=1e-5)


def test_release_memory_is_a_no_op():
    main, _, _ = build("paddle_tpu_torch", _mlp_training)
    before = _listing(main)
    assert pt.transpiler.release_memory(main) is None
    assert _listing(main) == before


def test_registered_pass_names_match_jax():
    """tests/test_passes.py:195's battery, and the same registry in both
    packages."""
    import paddle_tpu.passes as jpasses
    import paddle_tpu_torch.passes as ppasses

    assert ppasses.registered_passes() == jpasses.registered_passes()
    for name in ("fold_batch_norm", "memory_optimize", "quantize_training"):
        assert name in ppasses.registered_passes()
    assert set(ppasses.PRESETS) == set(jpasses.PRESETS)


def test_deployment_names_and_signatures_match_api_spec():
    import inspect
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "paddle_tpu", "API.spec")
    with open(path) as f:
        spec = dict(ln.rstrip("\n").partition(" ")[::2] for ln in f if ln.strip())
    fluid = importlib.import_module("paddle_tpu_torch.fluid")
    tr = importlib.import_module("paddle_tpu_torch.transpiler")
    checks = {"paddle_tpu.fluid.InferenceTranspiler.transpile": fluid.InferenceTranspiler.transpile,
              "paddle_tpu.fluid.memory_optimize": fluid.memory_optimize,
              "paddle_tpu.fluid.release_memory": fluid.release_memory}
    for name in ("InferenceTranspiler.transpile", "memory_optimize", "release_memory",
                 "QuantizeTranspiler.__init__", "QuantizeTranspiler.training_transpile",
                 "QuantizeTranspiler.freeze_program", "QuantizeTranspiler.convert_to_int8"):
        obj = tr
        for part in name.split("."):
            obj = getattr(obj, part)
        checks["paddle_tpu.transpiler." + name] = obj
    for key, fn in checks.items():
        assert str(inspect.signature(fn)) == spec[key], key


# --------------------------------------------------------------------------
# quantization-aware training -> freeze -> int8 on a small ResNet
# --------------------------------------------------------------------------


def _resnet8_qat(fluid):
    from importlib import import_module

    models = import_module(fluid.__name__.split(".")[0] + ".models")
    img = fluid.layers.data(name="img", shape=[3, 32, 32], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    loss, _, logits = models.resnet_cifar10(img, label, depth=8, class_num=10)
    fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return [loss, logits]


def test_quantization_aware_training_round_trip():
    rng = np.random.RandomState(4)
    feeds = [{"img": rng.randn(4, 3, 32, 32).astype(np.float32),
              "label": rng.randint(0, 10, (4, 1)).astype(np.int64)} for _ in range(2)]
    test_feed = {"img": rng.randn(3, 3, 32, 32).astype(np.float32),
                 "label": np.zeros((3, 1), np.int64)}
    out = {}
    shared = trained = None
    for p in PACKAGES:
        main, startup, (loss, logits) = build(p, _resnet8_qat)
        qt = _transpiler(p).QuantizeTranspiler()
        qt.training_transpile(main, startup)
        exe, scope, guard = exe_scope(p, seed=3)
        with guard(scope):
            exe.run(startup)
            names = convert.persistable_names(main)
            if shared is None:
                shared = _np_state(p, scope, names)
            else:
                _put(p, scope, shared)
            losses = [float(_fetch(exe, main, f, [loss.name])[0].reshape(-1)[0]) for f in feeds]
            # the port freezes from the JAX package's trained state, so the
            # payloads can be compared exactly
            if trained is None:
                trained = _np_state(p, scope, names)
            else:
                _put(p, scope, trained)
            infer = main.clone(for_test=True)
            frozen = qt.freeze_program(infer, scope)
            frozen_listing = _listing(infer)
            (f_logits,) = _fetch(exe, infer, test_feed, [logits.name])
            qt.convert_to_int8(infer, scope)
            (i_logits,) = _fetch(exe, infer, test_feed, [logits.name])
            int8_dtypes = {n: str(np.asarray(_np_state(p, scope, [n])[n]).dtype) for n in frozen}
        out[p] = dict(qat=_listing(main), losses=losses, frozen=frozen,
                      frozen_listing=frozen_listing, int8=_listing(infer), f_logits=f_logits,
                      i_logits=i_logits, dtypes=int8_dtypes)
    j, q = out["paddle_tpu"], out["paddle_tpu_torch"]
    assert q["qat"] == j["qat"]
    assert sum(t[0] == "fake_quantize_abs_max" for t in q["qat"]) > 0
    np.testing.assert_allclose(q["losses"], j["losses"], rtol=QAT_RTOL, atol=QAT_ATOL)
    assert sorted(q["frozen"]) == sorted(j["frozen"])
    for n, (qw, scale) in j["frozen"].items():
        pqw, pscale = q["frozen"][n]
        assert pqw.dtype == np.int8 and np.array_equal(pqw, qw), n
        assert pscale == scale, n
    assert q["frozen_listing"] == j["frozen_listing"]
    assert q["int8"] == j["int8"]
    types = [t[0] for t in q["int8"]]
    assert types.count("int8_conv2d") == 9 and types.count("int8_mul") == 1
    assert set(q["dtypes"].values()) == {"int8"}
    np.testing.assert_allclose(q["f_logits"], j["f_logits"], rtol=INT8_TOL, atol=INT8_TOL)
    np.testing.assert_allclose(q["i_logits"], j["i_logits"], rtol=INT8_TOL, atol=INT8_TOL)
    np.testing.assert_allclose(q["i_logits"], q["f_logits"], rtol=INT8_TOL, atol=INT8_TOL)
