"""Eager mode of the torch port (paddle_tpu_torch/imperative/) against the
JAX package's (paddle_tpu/imperative/), on the CPU.

- Each `nn` layer's forward and gradients (its parameters' and its input's)
  in both packages on the same inputs, made from a seed with numpy, the
  JAX layer's weights carried into the port's by convert.load_imperative:
  rtol / atol 1e-5 (conv and pool 1e-4, the JAX test's bar). BatchNorm's
  running statistics after two train steps and its eval output; the
  Embedding's zeroed padding rows; a max pool padded past half its window
  and an exclusive average pool.
- The tape's rules, a case each, in both packages: gradients accumulate
  over two backward() calls (the JAX tape walks a reached node again, so
  the second call adds twice the first's gradient), clear_gradient,
  stop_gradient inputs are no leaves, a node no cotangent reached is
  skipped, backward() raises outside guard() and on a non-scalar, a call
  outside guard() records nothing, a PyLayer with a stop_gradient input.
- The JAX test's eager LeNet (tests/test_imperative_nn.py) trained 5 steps
  in both packages from the same weights, with SGD and with Adam: losses
  rtol 2e-3, atol 2e-4.
- Layer.jit() (torch.compile; aot_eager on the CPU) equal to the plain
  forward, its gradients too.
- DataParallel: over 2 gloo ranks, each with its half-batch, the
  parameters after apply_collective_grads and 3 SGD steps equal the
  one-process full-batch run at rtol 1e-5 (tests/test_imperative_parallel.py's
  bar); at world 1 it is the plain layer bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import imperative as jimp
from paddle_tpu.imperative import nn as jnn
from paddle_tpu_torch import convert
from paddle_tpu_torch import imperative as timp
from paddle_tpu_torch.imperative import nn as tnn
from paddle_tpu_torch.place import CPUPlace

import torch_parallel_ranks as ranks

jax.config.update("jax_platforms", "cpu")

CPU = CPUPlace()
LOSS_RTOL, LOSS_ATOL = 2e-3, 2e-4


def _guard(pkg):
    return jimp.guard() if pkg is jimp else timp.guard(CPU)


def _weights(shape):
    """A fixed random weight of a loss over an output of `shape` (a plain
    sum of squares leaves some gradients at rounding noise, BatchNorm's
    shift's among them)."""
    return np.random.RandomState(99).randn(*shape).astype("float32")


class _JSumSq(jimp.Layer):
    def forward(self, t):
        return jnp.sum(t * t) + jnp.sum(t * _weights(t.shape))


class _TSumSq(timp.Layer):
    def forward(self, t):
        return (t * t).sum() + (t * torch.from_numpy(_weights(tuple(t.shape)))).sum()


def _sumsq(pkg):
    return _JSumSq() if pkg is jimp else _TSumSq()


def _seeded(fn, seed):
    """fn() with numpy's global state seeded (create_parameter draws from
    it), the caller's state restored after."""
    state = np.random.get_state()
    np.random.seed(seed)
    try:
        return fn()
    finally:
        np.random.set_state(state)


# each case: (make(nn) -> layer, [inputs], input has a gradient, tolerance)
def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype("float32")


LAYER_CASES = {
    "fc_relu": (lambda nn: nn.FC(size=6, input_dim=12, act="relu"),
                [_rand(4, 3, 4)], True, 1e-5),
    "fc_softmax": (lambda nn: nn.FC(size=5, input_dim=7, act="softmax"),
                   [_rand(3, 7, seed=1)], True, 1e-5),
    "conv2d_pad": (lambda nn: nn.Conv2D(num_channels=3, num_filters=4, filter_size=3,
                                        padding=1, act="relu"),
                   [_rand(2, 3, 8, 8, seed=2)], True, 1e-4),
    "conv2d_stride_groups": (lambda nn: nn.Conv2D(num_channels=4, num_filters=6, filter_size=3,
                                                  stride=2, groups=2),
                             [_rand(2, 4, 9, 9, seed=3)], True, 1e-4),
    "pool_max": (lambda nn: nn.Pool2D(pool_size=2, pool_type="max"),
                 [_rand(2, 3, 8, 8, seed=4)], True, 1e-4),
    "pool_max_wide_pad": (lambda nn: nn.Pool2D(pool_size=3, pool_type="max", pool_stride=2,
                                               pool_padding=2),
                          [_rand(2, 3, 7, 7, seed=5)], True, 1e-4),
    "pool_avg_exclusive": (lambda nn: nn.Pool2D(pool_size=3, pool_type="avg", pool_stride=1,
                                                pool_padding=2),
                           [_rand(2, 2, 5, 5, seed=6)], True, 1e-4),
    "pool_global": (lambda nn: nn.Pool2D(pool_type="avg", global_pooling=True),
                    [_rand(2, 3, 5, 5, seed=7)], True, 1e-4),
    "embedding_padding_idx": (lambda nn: nn.Embedding(size=[10, 6], padding_idx=0),
                              [np.array([[1, 0, 3], [4, 7, 0]], dtype="int64")], False, 1e-5),
    "layer_norm": (lambda nn: nn.LayerNorm(6), [_rand(4, 6, seed=8, scale=3.0)], True, 1e-5),
    "batch_norm": (lambda nn: nn.BatchNorm(5, momentum=0.5),
                   [_rand(8, 5, 3, 3, seed=9, scale=2.0) + 1.0], True, 1e-5),
}


def _run_layer(pkg, layer, inputs, with_grad):
    """(output, [param grads], input grad) of layer(*inputs) under a sum of
    squares plus a weighted sum, in package `pkg`."""
    with _guard(pkg):
        xs = [pkg.to_variable(a) for a in inputs]
        y = layer(*xs)
        _sumsq(pkg)(y).backward()
        grads = [p.gradient() for p in layer.parameters()]
        xg = xs[0].gradient() if with_grad else None
    return y.numpy(), grads, xg


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_nn_layer_matches_jax(case):
    make, inputs, with_grad, tol = LAYER_CASES[case]
    jl = _seeded(lambda: make(jnn), 11)
    with timp.guard(CPU):
        tl = make(tnn)
    convert.load_imperative(tl, [np.asarray(p.value) for p in jl.parameters()],
                            convert.running_stats(jl))
    steps = 2 if case == "batch_norm" else 1
    for _ in range(steps):
        jy, jg, jxg = _run_layer(jimp, jl, inputs, with_grad)
        ty, tg, txg = _run_layer(timp, tl, inputs, with_grad)
        np.testing.assert_allclose(ty, jy, rtol=tol, atol=tol)
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
        if with_grad:
            np.testing.assert_allclose(txg, jxg, rtol=tol, atol=tol)
    if case == "batch_norm":
        for (tm, tv), (jm, jv) in zip(convert.running_stats(tl), convert.running_stats(jl)):
            np.testing.assert_allclose(tm, jm, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)
        jl.eval()
        tl.eval()
        jy, _, _ = _run_layer(jimp, jl, inputs, with_grad)
        ty, _, _ = _run_layer(timp, tl, inputs, with_grad)
        np.testing.assert_allclose(ty, jy, rtol=tol, atol=tol)
    if case == "embedding_padding_idx":
        assert not ty[0, 1].any() and not ty[1, 2].any()


# ---------------------------------------------------------------- tape rules


class _JMul(jimp.Layer):
    def forward(self, a, b):
        return jnp.sum(a * b * a)


class _TMul(timp.Layer):
    def forward(self, a, b):
        return (a * b * a).sum()


def _tanh_pylayer(pkg):
    class TanhScale(pkg.PyLayer):
        """y = tanh(x) * s; the backward returns a grad for both inputs."""

        @staticmethod
        def forward(x, s):
            TanhScale.saved = (x, s)
            return np.tanh(x) * s

        @staticmethod
        def backward(dy):
            x, s = TanhScale.saved
            return dy * (1.0 - np.tanh(x) ** 2) * s, dy * np.tanh(x)

    return TanhScale


def _rule(pkg, case):
    """What the rule's case observes in package `pkg` (numpy or exception
    names), compared across the packages."""
    mul = _JMul if pkg is jimp else _TMul
    a0 = _rand(3, 4, seed=21)
    b0 = _rand(3, 4, seed=22)
    if case == "accumulate_two_backwards":
        with _guard(pkg):
            a, b = pkg.to_variable(a0), pkg.to_variable(b0)
            loss = mul()(a, b)
            loss.backward()
            first = a.gradient()
            loss.backward()
            return [first, a.gradient(), b.gradient()]
    if case == "clear_gradient":
        with _guard(pkg):
            a, b = pkg.to_variable(a0), pkg.to_variable(b0)
            mul()(a, b).backward()
            a.clear_gradient()
            b.clear_gradient()
            assert a.gradient() is None
            mul()(a, b).backward()
            return [a.gradient(), b.gradient()]
    if case == "stop_gradient_not_a_leaf":
        with _guard(pkg):
            a, b = pkg.to_variable(a0), pkg.to_variable(b0)
            b.stop_gradient = True
            mul()(a, b).backward()
            return [a.gradient(), b.gradient() is None]
    if case == "unreached_node_skipped":
        with _guard(pkg):
            make = jnn if pkg is jimp else tnn
            used, unused = make.FC(size=2, input_dim=4), make.FC(size=2, input_dim=4)
            x = pkg.to_variable(a0)
            unused(x)
            _sumsq(pkg)(used(x)).backward()
            return [unused.weight.gradient() is None, used.weight.gradient().shape]
    if case == "backward_outside_guard":
        with _guard(pkg):
            loss = mul()(pkg.to_variable(a0), pkg.to_variable(b0))
        try:
            loss.backward()
        except RuntimeError:
            return ["RuntimeError"]
        return ["no raise"]
    if case == "backward_non_scalar":
        with _guard(pkg):
            make = jnn if pkg is jimp else tnn
            y = make.FC(size=2, input_dim=4)(pkg.to_variable(a0))
            try:
                y.backward()
            except ValueError:
                return ["ValueError"]
        return ["no raise"]
    if case == "outside_guard_records_nothing":
        layer = _seeded(lambda: mul(), 0)
        with _guard(pkg):
            a, b = pkg.to_variable(a0), pkg.to_variable(b0)
        out = layer(a, b)  # no tape: a plain call
        with _guard(pkg):
            out2 = layer(a, b)
            out2.backward()
            return [out.numpy(), out2.numpy(), a.gradient(), b.gradient()]
    if case == "pylayer_stop_gradient_input":
        cls = _tanh_pylayer(pkg)
        with _guard(pkg):
            x, s = pkg.to_variable(a0), pkg.to_variable(b0)
            s.stop_gradient = True
            y = cls.apply(x, s)
            _sumsq(pkg)(y).backward()
            return [y.numpy(), x.gradient(), s.gradient() is None]
    raise KeyError(case)


TAPE_RULES = ("accumulate_two_backwards", "clear_gradient", "stop_gradient_not_a_leaf",
              "unreached_node_skipped", "backward_outside_guard", "backward_non_scalar",
              "outside_guard_records_nothing", "pylayer_stop_gradient_input")


@pytest.mark.parametrize("case", TAPE_RULES)
def test_tape_rule_matches_jax(case):
    got, want = _rule(timp, case), _rule(jimp, case)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
        else:
            assert g == w, (case, g, w)
    if case == "accumulate_two_backwards":
        # the second backward walks the node again with its held cotangent
        # plus the new one: first + 2 x first
        np.testing.assert_allclose(got[1], 3 * got[0], rtol=1e-6)


def test_outside_guard_keeps_no_graph():
    """A call outside guard() runs under torch.no_grad(): its value holds no
    autograd graph."""
    with timp.guard(CPU):
        a, b = timp.to_variable(_rand(2, 2)), timp.to_variable(_rand(2, 2, seed=1))
    out = _TMul()(a, b)
    assert out.value.grad_fn is None and not out.value.requires_grad


# ---------------------------------------------------------------- LeNet


def _lenet(pkg):
    """The JAX test's eager LeNet (tests/test_imperative_nn.py): conv 1 -> 4
    3x3 pad 1 relu, max pool 2, fc 64 -> 2, a log-softmax loss Layer."""
    nn = jnn if pkg is jimp else tnn

    class Loss(pkg.Layer):
        def forward(self, lg, yy):
            if pkg is jimp:
                p = jax.nn.log_softmax(lg)
                return -jnp.mean(jnp.sum(jax.nn.one_hot(yy, 2) * p, axis=-1))
            p = torch.log_softmax(lg, dim=-1)
            return -(torch.nn.functional.one_hot(yy.long(), 2).to(p.dtype) * p).sum(-1).mean()

    class LeNet(pkg.Layer):
        def __init__(self):
            super().__init__()
            self.conv = self.add_sublayer(nn.Conv2D(num_channels=1, num_filters=4, filter_size=3,
                                                    padding=1, act="relu"))
            self.pool = self.add_sublayer(nn.Pool2D(pool_size=2))
            self.fc = self.add_sublayer(nn.FC(size=2, input_dim=4 * 4 * 4))

        def __call__(self, x, y):
            logits = self.fc(self.pool(self.conv(x)))
            return Loss()(logits, pkg.Variable(y, stop_gradient=True))

    return LeNet


def _lenet_losses(pkg, net, opt_name, steps=5):
    """Losses of `steps` eager steps, a guard a step (a tape that lives
    across steps walks the earlier steps' nodes again: see the
    accumulate_two_backwards rule)."""
    nn = jnn if pkg is jimp else tnn
    rng = np.random.RandomState(0)
    losses = []
    opt = (nn.AdamOptimizer(net.parameters(), learning_rate=5e-3) if opt_name == "adam"
           else nn.SGDOptimizer(net.parameters(), learning_rate=0.05))
    for _ in range(steps):
        y = rng.randint(0, 2, 32)
        x = rng.randn(32, 1, 8, 8).astype("float32") + y[:, None, None, None] * 2.0
        with _guard(pkg):
            loss = net(x, y.astype("int32"))
            loss.backward()
            opt.step()
            opt.clear_gradients()
        losses.append(float(loss.numpy()))
    return losses


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_eager_lenet_trains_as_jax(opt_name):
    jnet = _seeded(lambda: _lenet(jimp)(), 0)
    with timp.guard(CPU):
        tnet = _lenet(timp)()
    convert.load_imperative(tnet, [np.asarray(p.value) for p in jnet.parameters()])
    want = _lenet_losses(jimp, jnet, opt_name)
    got = _lenet_losses(timp, tnet, opt_name)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert got[-1] < got[0]


# ---------------------------------------------------------------- jit


class _TMLP(timp.Layer):
    def __init__(self):
        super().__init__()
        self.w1 = self.create_parameter([4, 8])
        self.b1 = self.create_parameter([8], initializer=0.0)
        self.w2 = self.create_parameter([8, 1])

    def forward(self, x, w1, b1, w2):
        return (torch.relu(x @ w1 + b1) @ w2).mean()


def test_layer_jit_matches_plain_forward():
    x = _rand(3, 4, seed=6)

    def run(mlp):
        with timp.guard(CPU):
            loss = mlp(x)
            loss.backward()
            return float(loss.numpy()), [p.gradient() for p in mlp.parameters()]

    with timp.guard(CPU):
        mlp = _seeded(_TMLP, 6)
    plain, plain_g = run(mlp)
    for p in mlp.parameters():
        p.clear_gradient()
    mlp.jit()
    assert mlp._fn() is not mlp.forward
    jitted, jit_g = run(mlp)
    assert jitted == pytest.approx(plain, rel=1e-6)
    for a, b in zip(jit_g, plain_g):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- DataParallel


def _dp_mlp():
    return ranks.imperative_mlp(timp, tnn)


def test_parallel_env_without_a_group():
    env = timp.ParallelEnv()
    assert (env.nranks, env.local_rank, env.local_device_count,
            env.data_parallel_degree) == (1, 0, 1, 1)
    assert timp.prepare_context().nranks == 1
    assert timp.Env is timp.ParallelEnv


def test_dataparallel_world1_is_the_plain_layer():
    plain = ranks.imperative_dp_train(timp, tnn, CPU, parallel=False)
    wrapped = ranks.imperative_dp_train(timp, tnn, CPU, parallel=True)
    for a, b in zip(wrapped["params"], plain["params"]):
        np.testing.assert_array_equal(a, b)
    assert wrapped["losses"] == plain["losses"]


def test_dataparallel_two_gloo_ranks_match_the_full_batch(tmp_path):
    """Each rank trains on its half of every batch; after the all-reduce
    and 3 SGD steps the parameters equal the one-process run on the whole
    batch."""
    full = ranks.imperative_dp_train(timp, tnn, CPU, parallel=False)
    outs = ranks.spawn(2, "sc_imperative_dp", {}, tmp_path)
    assert [(o["nranks"], o["local_rank"]) for o in outs] == [(2, 0), (2, 1)]
    for out in outs:
        for a, b in zip(out["params"], full["params"]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
