"""The CNN, metric, tensor and optimizer ops of the torch port
(paddle_tpu_torch/ops/core_ops.py) against the JAX package's lowerings, on
the CPU: each case builds the same one-op program in both packages from
seeded numpy feeds, differentiates `mean(out * dy)` by each package's
append_backward, and compares the fetched outputs and input grads; the
stateful ops (batch_norm's running statistics, the optimizers' moments)
also compare their persistable state.

Tolerances:
- forward: rtol = atol = 1e-5 (f32 both sides, sums in another order);
- grads: rtol 1e-4 with an absolute floor of 1e-5 of the grad's largest
  magnitude (cancelled entries carry no relative meaning);
- optimizers: 3 steps of a small fc model, losses and every persistable
  at rtol 1e-5, atol 1e-6 (the same f32 expressions in the same order).
"""

import importlib

import numpy as np
import pytest
import torch

import jax

from paddle_tpu_torch import convert
from paddle_tpu_torch.ops import registry

from torch_cnn_cases import BN_CASES, CONV_CASES, POOL_CASES, conv_attrs, pool_attrs

jax.config.update("jax_platforms", "cpu")

FWD_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
OPT_RTOL, OPT_ATOL = 1e-5, 1e-6
PACKAGES = ("paddle_tpu", "paddle_tpu_torch")


def _pkg(name):
    if name == "paddle_tpu":
        return importlib.import_module("paddle_tpu.fluid")
    return importlib.import_module("paddle_tpu_torch")


def _session(name):
    """(executor, scope, scope_guard) of one package on the CPU."""
    if name == "paddle_tpu":
        from paddle_tpu.executor import Executor, Scope, scope_guard

        return Executor(), Scope(seed=0), scope_guard
    import paddle_tpu_torch as pt

    return pt.Executor(pt.CPUPlace()), pt.Scope(seed=0, place=pt.CPUPlace()), pt.scope_guard


def _set_state(name, scope, state):
    if not state:
        return
    if name == "paddle_tpu":
        import jax.numpy as jnp

        for n, a in state.items():
            scope.vars[n] = jnp.asarray(a)
    else:
        convert.load_into_scope(scope, state, list(state))


def _state_of(name, scope, names):
    if name == "paddle_tpu":
        return {n: np.asarray(scope.vars[n]) for n in names}
    return convert.scope_to_numpy(scope, names)


def _run(name, build, feeds, fetch, steps=1, state=None, state_names=()):
    """Build with `build(pkg, helper_cls)` -> fetch names (plus `fetch`),
    run the startup program, load `state`, then `steps` runs over `feeds`
    (one dict, or one a step). Returns (fetches of every step, state)."""
    pkg = _pkg(name)
    helper_cls = importlib.import_module(name + ".layer_helper").LayerHelper
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        names = list(build(pkg, helper_cls)) + list(fetch)
    exe, scope, guard = _session(name)
    out = []
    with guard(scope):
        exe.run(startup)
        _set_state(name, scope, state)
        for i in range(steps):
            f = feeds[i] if isinstance(feeds, list) else feeds
            out.append([np.asarray(v) for v in exe.run(main, feed=f, fetch_list=names)])
        final = _state_of(name, scope, state_names)
    return out, final


def _both(build, feeds, fetch=(), **kw):
    return [_run(n, build, feeds, fetch, **kw) for n in PACKAGES]


def _close_fwd(got, want, what):
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _close_grad(got, want, what):
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL * max(float(np.abs(want).max()), 1e-30),
                               err_msg=what)


def _one_op(op_type, inputs, outputs, attrs=None, grad_slot=None):
    """A builder of one `op_type` op over data vars. `inputs`: slot ->
    [(name, array, needs_grad)]; `outputs`: slot -> dtype. With
    `grad_slot`, the loss mean(out * dy) of that output is appended with
    its backward, dy fed as "dy"."""

    def build(pkg, helper_cls):
        L = pkg.layers
        ins = {}
        for slot, items in inputs.items():
            ins[slot] = [
                L.data(name=n, shape=list(a.shape), dtype=str(a.dtype),
                       append_batch_size=False, stop_gradient=not g).name
                for n, a, g in items
            ]
        helper = helper_cls(op_type)
        outs = {slot: [helper.create_variable_for_type_inference(dt)] for slot, dt in outputs.items()}
        helper.append_op(type=op_type, inputs=ins,
                         outputs={s: [v.name for v in vs] for s, vs in outs.items()},
                         attrs=dict(attrs or {}))
        names = [vs[0].name for vs in outs.values()]
        if grad_slot is not None:
            out = outs[grad_slot][0]
            dy = L.data(name="dy", shape=list(out.shape), dtype="float32",
                        append_batch_size=False)
            pkg.append_backward(L.mean(L.elementwise_mul(out, dy)))
            names += [n + "@GRAD" for items in inputs.values() for n, _, g in items if g]
        return names

    return build


def _check_one_op(op_type, inputs, outputs, attrs=None, grad_slot=None, seed=0):
    feeds = {n: a for items in inputs.values() for n, a, _ in items}
    build = _one_op(op_type, inputs, outputs, attrs, grad_slot)
    if grad_slot is not None:
        # dy takes the forward output's shape (a dry build of the port's
        # program tells it)
        import paddle_tpu_torch as pt

        main = pt.Program()
        with pt.unique_name.guard(), pt.program_guard(main, pt.Program()):
            helper_cls = importlib.import_module("paddle_tpu_torch.layer_helper").LayerHelper
            out_name = _one_op(op_type, inputs, outputs, attrs)(pt, helper_cls)[
                list(outputs).index(grad_slot)]
            shape = main.global_block().var(out_name).shape
        feeds["dy"] = np.random.RandomState(seed + 1).randn(*shape).astype("float32")
    (j, _), (p, _) = _both(build, feeds)
    n_out = len(outputs)
    for i, (g, w) in enumerate(zip(p[0], j[0])):
        assert g.shape == w.shape, (op_type, i, g.shape, w.shape)
        if i < n_out:
            _close_fwd(g, w, "%s output %d" % (op_type, i))
        else:
            _close_grad(g, w, "%s grad %d" % (op_type, i - n_out))
    return p[0], j[0]


def _rand(shape, seed, lo=None):
    a = np.random.RandomState(seed).randn(*shape).astype("float32")
    return a if lo is None else np.abs(a) + lo


# --------------------------------------------------------------------------
# conv2d / depthwise_conv2d: strides, paddings, dilations, groups
# --------------------------------------------------------------------------





@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_and_grads(case):
    c = CONV_CASES[case]
    _check_one_op(c[0], {"Input": [("x", _rand(c[1], 1), True)],
                         "Filter": [("w", _rand(c[2], 2), True)]},
                  {"Output": "float32"}, conv_attrs(c), grad_slot="Output")


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_explicit_grad_matches_generic(case):
    """conv2d_grad's explicit lowering (one convolution_backward) against
    the generic vjp of the forward lowering, on the same inputs."""
    c = CONV_CASES[case]
    attrs = conv_attrs(c)
    x, w = torch.from_numpy(_rand(c[1], 1)), torch.from_numpy(_rand(c[2], 2))
    ctx = registry.LowerCtx("cpu")
    y = registry.get(c[0]).lower(ctx, {"Input": [x], "Filter": [w]}, attrs)["Output"][0]
    dy = torch.from_numpy(np.random.RandomState(3).randn(*y.shape).astype("float32"))
    ins = {"Input": [x], "Filter": [w], "Output": [y], "Output@GRAD": [dy]}
    gattrs = dict(attrs, **{registry.FWD_IN_SLOTS_ATTR: ["Input", "Filter"],
                            registry.FWD_OUT_SLOTS_ATTR: ["Output"]})
    explicit = registry.get(c[0] + "_grad").lower(ctx, ins, gattrs)
    generic = registry._make_generic_grad(registry.get(c[0]))(ctx, ins, gattrs)
    for slot in ("Input@GRAD", "Filter@GRAD"):
        want = generic[slot][0].numpy()
        _close_grad(explicit[slot][0].numpy(), want, slot)


def test_conv2d_grad_skips_an_input_without_grad():
    """A first layer's input carries no gradient: the grad op writes only
    Filter@GRAD, and its explicit lowering computes only that."""
    _check_one_op("conv2d", {"Input": [("x", _rand((2, 3, 8, 8), 1), False)],
                             "Filter": [("w", _rand((4, 3, 3, 3), 2), True)]},
                  {"Output": "float32"}, conv_attrs(CONV_CASES["3x3_s2_p1"]),
                  grad_slot="Output")


# --------------------------------------------------------------------------
# pool2d: max, avg, global, adaptive, exclusive with padding, ties
# --------------------------------------------------------------------------



@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool2d_and_grads(case):
    _check_one_op("pool2d", {"X": [("x", _rand((2, 3, 9, 9), 4), True)]}, {"Out": "float32"},
                  pool_attrs(case), grad_slot="Out")


@pytest.mark.parametrize("case", ["max_2x2_s2", "max_3x3_s2_p1", "max_global"])
def test_max_pool_tied_window_grad(case):
    """Windows of equal values (a relu's zeros, here 0/1 maps): the grad
    goes to one element of a tied window, the first in row-major order, in
    both packages (lax.reduce_window's select-and-scatter)."""
    x = np.random.RandomState(5).randint(0, 2, (2, 3, 9, 9)).astype("float32")
    x[0, 0] = 0.0  # a whole map tied
    p, _ = _check_one_op("pool2d", {"X": [("x", x, True)]}, {"Out": "float32"},
                         pool_attrs(case), grad_slot="Out")
    # one element of each window took the whole cotangent
    dx = p[1]
    assert np.count_nonzero(dx[0, 0]) <= p[0][0, 0].size


# --------------------------------------------------------------------------
# batch_norm: train (batch statistics, running stats updated with the biased
# variance), test and use_global_stats (running stats), NHWC
# --------------------------------------------------------------------------



@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batch_norm_and_running_stats(case):
    extra, shape, layout = BN_CASES[case]
    c = shape[1] if layout == "NCHW" else shape[-1]
    rng = np.random.RandomState(6)
    x = (rng.randn(*shape) * 2 + 1).astype("float32")
    dy = rng.randn(*shape).astype("float32")
    state = {"bn_scale": rng.rand(c).astype("float32") + 0.5,
             "bn_bias": rng.randn(c).astype("float32"),
             "bn_mean": rng.randn(c).astype("float32"),
             "bn_var": rng.rand(c).astype("float32") + 0.5}

    def build(pkg, helper_cls):
        L = pkg.layers
        xv = L.data(name="x", shape=list(shape), dtype="float32", append_batch_size=False,
                    stop_gradient=False)
        dyv = L.data(name="dy", shape=list(shape), dtype="float32", append_batch_size=False)
        y = L.batch_norm(xv, data_layout=layout, momentum=0.8,
                         param_attr=pkg.ParamAttr(name="bn_scale"),
                         bias_attr=pkg.ParamAttr(name="bn_bias"),
                         moving_mean_name="bn_mean", moving_variance_name="bn_var", **extra)
        op = [o for o in pkg.default_main_program().global_block().ops
              if o.type == "batch_norm"][0]
        pkg.append_backward(L.mean(L.elementwise_mul(y, dyv)))
        return [y.name, op.output("SavedMean")[0], op.output("SavedVariance")[0],
                "x@GRAD", "bn_scale@GRAD", "bn_bias@GRAD"]

    names = sorted(state)
    (j, js), (p, ps) = _both(build, {"x": x, "dy": dy}, steps=2, state=state,
                             state_names=names)
    for step in range(2):
        for i, (g, w) in enumerate(zip(p[step], j[step])):
            (_close_fwd if i < 3 else _close_grad)(g, w, "%s step %d fetch %d" % (case, step, i))
    for n in names:
        _close_fwd(ps[n], js[n], n)
    moved = not (extra.get("is_test") or extra.get("use_global_stats"))
    assert moved == (not np.array_equal(ps["bn_mean"], state["bn_mean"]))


def test_batch_norm_running_variance_is_biased():
    """The running variance moves toward the biased batch variance
    E[x^2] - E[x]^2 (torch.nn.functional.batch_norm would use n / (n - 1)
    times it), and SavedVariance is the inverse std."""
    x = np.random.RandomState(7).randn(3, 2, 2, 2).astype("float32")
    t = torch.from_numpy(x)
    c = torch.ones(2)
    out = registry.get("batch_norm").lower(
        registry.LowerCtx("cpu"),
        {"X": [t], "Scale": [c], "Bias": [c * 0], "Mean": [c * 0], "Variance": [c]},
        {"momentum": 0.0, "epsilon": 1e-5})
    xs = x.transpose(1, 0, 2, 3).reshape(2, -1).astype(np.float64)
    want = (xs ** 2).mean(1) - xs.mean(1) ** 2
    np.testing.assert_allclose(out["VarianceOut"][0].numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(out["SavedVariance"][0].numpy(), 1 / np.sqrt(want + 1e-5),
                               rtol=1e-5)


# --------------------------------------------------------------------------
# activations, elementwise, losses, tensor ops
# --------------------------------------------------------------------------

ACTS = {
    "relu": {}, "sigmoid": {}, "tanh": {}, "gelu": {}, "logsigmoid": {}, "tanh_shrink": {},
    "sqrt": {"positive": True}, "abs": {}, "ceil": {"no_grad": True},
    "floor": {"no_grad": True}, "cos": {}, "sin": {}, "round": {"no_grad": True},
    "reciprocal": {"positive": True}, "exp": {}, "log": {"positive": True}, "square": {},
    "softplus": {}, "softsign": {}, "softshrink": {"attrs": {"lambda": 0.3}},
    "hard_shrink": {"attrs": {"threshold": 0.4}}, "brelu": {"attrs": {"t_min": -0.5, "t_max": 1.0}},
    "leaky_relu": {"attrs": {"alpha": 0.1}}, "soft_relu": {"attrs": {"threshold": 1.5}},
    "elu": {"attrs": {"alpha": 0.7}}, "relu6": {"attrs": {"threshold": 1.2}},
    "pow": {"positive": True, "attrs": {"factor": 2.5}}, "stanh": {},
    "hard_sigmoid": {}, "swish": {"attrs": {"beta": 1.3}},
    "thresholded_relu": {"attrs": {"threshold": 0.2}}, "rsqrt": {"positive": True},
    "sign": {"no_grad": True},
}


@pytest.mark.parametrize("act", sorted(ACTS))
def test_activation(act):
    spec = ACTS[act]
    x = _rand((4, 7), 8, lo=0.2 if spec.get("positive") else None)
    grad = not spec.get("no_grad")
    _check_one_op(act, {"X": [("x", x, grad)]}, {"Out": "float32"}, spec.get("attrs"),
                  grad_slot="Out" if grad else None)


ELEMENTWISE = {
    "elementwise_max": (True, False),
    "elementwise_pow": (True, True),
    "elementwise_mod": (False, True),
    "elementwise_floordiv": (False, True),
}


@pytest.mark.parametrize("op", sorted(ELEMENTWISE))
def test_elementwise(op):
    grad, positive = ELEMENTWISE[op]
    x = _rand((3, 4, 5), 9, lo=0.5 if positive else None)
    y = _rand((4,), 10, lo=0.5 if positive else None)
    _check_one_op(op, {"X": [("x", x, grad)], "Y": [("y", y, grad)]}, {"Out": "float32"},
                  {"axis": 1}, grad_slot="Out" if grad else None)


def test_cross_entropy_hard_and_soft():
    rng = np.random.RandomState(11)
    prob = rng.rand(6, 5).astype("float32") + 0.05
    prob /= prob.sum(1, keepdims=True)
    label = rng.randint(0, 5, (6, 1)).astype("int64")
    _check_one_op("cross_entropy", {"X": [("x", prob, True)], "Label": [("label", label, False)]},
                  {"Y": "float32"}, {"soft_label": False}, grad_slot="Y")
    soft = rng.rand(6, 5).astype("float32")
    _check_one_op("cross_entropy", {"X": [("x", prob, True)], "Label": [("label", soft, False)]},
                  {"Y": "float32"}, {"soft_label": True}, grad_slot="Y")


def test_square_error_cost():
    _check_one_op("square_error_cost", {"X": [("x", _rand((5, 1), 12), True)],
                                        "Y": [("y", _rand((5, 1), 13), False)]},
                  {"Out": "float32"}, grad_slot="Out")


TENSOR_CASES = {
    "cast_f32_to_int32": ("cast", {"X": [("x", "f", False)]}, {"Out": "int32"},
                          {"in_dtype": "float32", "out_dtype": "int32"}, None),
    "cast_int_to_f32": ("cast", {"X": [("x", "i", False)]}, {"Out": "float32"},
                        {"in_dtype": "int32", "out_dtype": "float32"}, None),
    "shape": ("shape", {"Input": [("x", "f", False)]}, {"Out": "int32"}, {}, None),
    "fill_constant_batch_size_like": (
        "fill_constant_batch_size_like", {"Input": [("x", "f", False)]}, {"Out": "float32"},
        {"shape": [-1, 7], "dtype": "float32", "value": 2.5, "input_dim_idx": 1,
         "output_dim_idx": 0}, None),
    "concat": ("concat", {"X": [("x", "f", True), ("x2", "f", True)]}, {"Out": "float32"},
               {"axis": 1}, "Out"),
    "flatten2": ("flatten2", {"X": [("x", "f", True)]}, {"Out": "float32", "XShape": "float32"},
                 {"axis": 2}, "Out"),
    "one_hot": ("one_hot", {"X": [("x", "label", False)]}, {"Out": "float32"}, {"depth": 6},
                None),
    "increment": ("increment", {"X": [("x", "f", False)]}, {"Out": "float32"}, {"step": 2.0},
                  None),
    "clip": ("clip", {"X": [("x", "f", True)]}, {"Out": "float32"}, {"min": -0.5, "max": 0.7},
             "Out"),
    "clip_by_norm": ("clip_by_norm", {"X": [("x", "f", True)]}, {"Out": "float32"},
                     {"max_norm": 1.5}, "Out"),
    "squared_l2_norm": ("squared_l2_norm", {"X": [("x", "f", True)]}, {"Out": "float32"}, {},
                        "Out"),
    "top_k": ("top_k", {"X": [("x", "f", False)]}, {"Out": "float32", "Indices": "int32"},
              {"k": 2}, None),
    "arg_max": ("arg_max", {"X": [("x", "f", False)]}, {"Out": "int32"}, {"axis": 1}, None),
    "arg_min": ("arg_min", {"X": [("x", "f", False)]}, {"Out": "int32"}, {"axis": -1}, None),
    "argsort": ("argsort", {"X": [("x", "f", False)]}, {"Out": "float32", "Indices": "int32"},
                {"axis": -1}, None),
    "cumsum_exclusive_reverse": ("cumsum", {"X": [("x", "f", True)]}, {"Out": "float32"},
                                 {"axis": 1, "exclusive": True, "reverse": True}, "Out"),
    "log_softmax": ("log_softmax", {"X": [("x", "f", True)]}, {"Out": "float32"}, {}, "Out"),
    "reverse": ("reverse", {"X": [("x", "f", True)]}, {"Out": "float32"}, {"axis": [0, 2]},
                "Out"),
    "reduce_mean": ("reduce_mean", {"X": [("x", "f", True)]}, {"Out": "float32"},
                    {"dim": [1], "keep_dim": True}, "Out"),
    "reduce_max": ("reduce_max", {"X": [("x", "f", True)]}, {"Out": "float32"},
                   {"dim": [0, 2]}, "Out"),
    "reduce_prod": ("reduce_prod", {"X": [("x", "f", True)]}, {"Out": "float32"},
                    {"reduce_all": True}, "Out"),
}


@pytest.mark.parametrize("case", sorted(TENSOR_CASES))
def test_tensor_op(case):
    op, inputs, outputs, attrs, grad_slot = TENSOR_CASES[case]
    rng = np.random.RandomState(14)
    arrays = {
        "f": lambda: (rng.randn(3, 4, 5) * 2).astype("float32"),
        "i": lambda: rng.randint(-5, 5, (3, 4)).astype("int32"),
        "label": lambda: rng.randint(0, 6, (5, 1)).astype("int64"),
    }
    ins = {slot: [(n, arrays[kind](), g) for n, kind, g in items]
           for slot, items in inputs.items()}
    _check_one_op(op, ins, outputs, attrs, grad_slot=grad_slot)


def test_top_k_orders_ties_by_index():
    x = np.array([[1.0, 3.0, 3.0, 0.5, 3.0]], "float32")
    p, _ = _check_one_op("top_k", {"X": [("x", x, False)]},
                         {"Out": "float32", "Indices": "int32"}, {"k": 3})
    np.testing.assert_array_equal(p[1], [[1, 2, 4]])


# --------------------------------------------------------------------------
# metrics: accuracy (top_k's indices), streaming auc
# --------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3])
def test_accuracy(k):
    rng = np.random.RandomState(15)
    prob = rng.rand(16, 10).astype("float32")
    label = rng.randint(0, 10, (16, 1)).astype("int64")

    def build(pkg, helper_cls):
        L = pkg.layers
        x = L.data(name="x", shape=[10], dtype="float32")
        y = L.data(name="label", shape=[1], dtype="int64")
        correct = L.create_tensor(dtype="int32")
        total = L.create_tensor(dtype="int32")
        acc = L.accuracy(x, y, k=k, correct=correct, total=total)
        return [acc.name, correct.name, total.name]

    (j, _), (p, _) = _both(build, {"x": prob, "label": label})
    for g, w in zip(p[0], j[0]):
        assert g.dtype == w.dtype
        _close_fwd(g, w, "accuracy")
    assert p[0][0].dtype == np.float32 and p[0][1].dtype == np.int32


def test_auc_streams_over_batches():
    rng = np.random.RandomState(16)
    feeds = []
    for _ in range(3):
        prob = rng.rand(32, 1).astype("float32")
        feeds.append({"x": np.concatenate([1 - prob, prob], 1),
                      "label": (rng.rand(32, 1) < prob).astype("int64")})

    def build(pkg, helper_cls):
        L = pkg.layers
        x = L.data(name="x", shape=[2], dtype="float32")
        y = L.data(name="label", shape=[1], dtype="int64")
        auc, (_, sp, sn) = L.auc(x, y, num_thresholds=63)
        return [auc.name, sp.name, sn.name]

    (j, _), (p, _) = _both(build, feeds, steps=3)
    for step in range(3):
        for g, w in zip(p[step], j[step]):
            _close_fwd(g, w, "auc step %d" % step)
    assert 0.0 < float(p[2][0][0]) < 1.0


# --------------------------------------------------------------------------
# optimizers: 3 steps of a small fc model, the f32 lowerings and their casts
# --------------------------------------------------------------------------

OPTIMIZERS = {
    "sgd": lambda o: o.SGD(learning_rate=0.1),
    "momentum": lambda o: o.Momentum(learning_rate=0.05, momentum=0.9),
    "momentum_nesterov": lambda o: o.Momentum(learning_rate=0.05, momentum=0.9,
                                              use_nesterov=True),
    "lars_momentum": lambda o: o.LarsMomentum(learning_rate=0.1, momentum=0.9),
    "adagrad": lambda o: o.Adagrad(learning_rate=0.1),
    "decayed_adagrad": lambda o: o.DecayedAdagrad(learning_rate=0.1),
    "rmsprop": lambda o: o.RMSProp(learning_rate=0.01),
    "rmsprop_centered": lambda o: o.RMSProp(learning_rate=0.01, momentum=0.5, centered=True),
    "adadelta": lambda o: o.Adadelta(learning_rate=1.0),
    "adamax": lambda o: o.Adamax(learning_rate=0.05),
    "ftrl": lambda o: o.Ftrl(learning_rate=0.1, l1=0.01, l2=0.01),
    "ftrl_lr_power": lambda o: o.Ftrl(learning_rate=0.1, l1=0.01, lr_power=-0.7),
    "adam": lambda o: o.Adam(learning_rate=0.01),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_three_steps(name):
    rng = np.random.RandomState(17)
    w_true = rng.randn(6, 1).astype("float32")
    feeds = []
    for _ in range(3):
        xs = rng.randn(8, 6).astype("float32")
        feeds.append({"x": xs, "y": xs @ w_true})
    state_names = []

    def build(pkg, helper_cls):
        L = pkg.layers
        x = L.data(name="x", shape=[6], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        h = L.fc(x, size=4, act="tanh", param_attr=pkg.ParamAttr(name="w0"),
                 bias_attr=pkg.ParamAttr(name="b0"))
        pred = L.fc(h, size=1, param_attr=pkg.ParamAttr(name="w1"),
                    bias_attr=pkg.ParamAttr(name="b1"))
        loss = L.mean(L.square_error_cost(pred, y))
        OPTIMIZERS[name](pkg.optimizer).minimize(loss)
        state_names[:] = convert.persistable_names(pkg.default_main_program())
        return [loss.name]

    # the JAX package's startup values, carried into the port by name
    _, init = _run("paddle_tpu", build, feeds[0], (), steps=0,
                   state_names=_names_after(build))
    (j, js), (p, ps) = _both(build, feeds, steps=3, state=init, state_names=state_names)
    np.testing.assert_allclose([s[0] for s in p], [s[0] for s in j], rtol=OPT_RTOL,
                               atol=OPT_ATOL)
    for n in state_names:
        np.testing.assert_allclose(ps[n], js[n], rtol=OPT_RTOL, atol=OPT_ATOL, err_msg=n)


def _names_after(build):
    import paddle_tpu_torch as pt

    main = pt.Program()
    helper_cls = importlib.import_module("paddle_tpu_torch.layer_helper").LayerHelper
    with pt.unique_name.guard(), pt.program_guard(main, pt.Program()):
        build(pt, helper_cls)
    return convert.persistable_names(main)


def test_every_module_one_op_has_a_lowering():
    """Every op type this file holds against the JAX package is registered
    in the port, with the explicit conv grads."""
    types = {c[0] for c in CONV_CASES.values()} | {"pool2d", "batch_norm"} | set(ACTS)
    types |= set(ELEMENTWISE) | {c[0] for c in TENSOR_CASES.values()}
    types |= {"cross_entropy", "square_error_cost", "accuracy", "auc", "sgd", "momentum",
              "lars_momentum", "adagrad", "decayed_adagrad", "rmsprop", "adadelta", "adamax",
              "ftrl", "conv2d_grad", "depthwise_conv2d_grad"}
    assert {t for t in types if t not in registry.OPS} == set()
