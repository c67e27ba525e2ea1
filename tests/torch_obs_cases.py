"""Programs and runners shared by the observability tests of the port
(tests/test_torch_observability.py, tests/test_torch_opprof.py): each
takes the package (`paddle_tpu.fluid` or `paddle_tpu_torch`) as `pkg`, so
the same program runs through both executors. Imports no JAX."""

import numpy as np

from paddle_tpu_torch import convert


def fc_adam(pkg):
    """(main, startup, loss): fc(16 -> 8, relu) -> fc(8 -> 1), squared error,
    Adam."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[16], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        pred = pkg.layers.fc(pkg.layers.fc(x, 8, act="relu"), 1)
        diff = pred - y
        loss = pkg.layers.mean(diff * diff)
        pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return main, startup, loss


def conv_sgd(pkg):
    """(main, startup, loss): conv2d 1 -> 4 3x3 relu, max pool 2, fc 10,
    softmax cross entropy, SGD."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = pkg.layers.data(name="img", shape=[1, 8, 8], dtype="float32")
        label = pkg.layers.data(name="label", shape=[1], dtype="int64")
        h = pkg.layers.conv2d(img, num_filters=4, filter_size=3, act="relu")
        h = pkg.layers.pool2d(h, pool_size=2, pool_type="max", pool_stride=2)
        pred = pkg.layers.fc(h, 10, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, label))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def log_net(pkg):
    """(main, startup, out): log(x) -> fc 4 -> mean; a negative x makes the
    log op the first with a NaN output."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[6], dtype="float32")
        h = pkg.layers.fc(pkg.layers.log(x), 4, act="tanh")
        out = pkg.layers.mean(h)
    return main, startup, out


def fc_batch(step):
    rng = np.random.RandomState(100 + step)
    return {"x": rng.randn(4, 16).astype("float32"), "y": rng.randn(4, 1).astype("float32")}


def conv_batch(step):
    rng = np.random.RandomState(200 + step)
    return {"img": rng.randn(4, 1, 8, 8).astype("float32"),
            "label": rng.randint(0, 10, (4, 1)).astype("int64")}


def is_port(pkg):
    return pkg.__name__.startswith("paddle_tpu_torch")


class Run:
    """A program of one package prepared for steps on the CPU (or, for the
    port, on `place`): its own executor and scope, the startup run, and
    (for the port) the state carried in by name from the JAX package's
    startup (`init`)."""

    def __init__(self, pkg, build, init=None, place=None):
        self.pkg = pkg
        self.main, self.startup, self.loss = build(pkg)
        self.names = convert.persistable_names(self.main)
        place = place or pkg.CPUPlace()
        self.scope = pkg.Scope(place=place) if is_port(pkg) else pkg.Scope()
        self.exe = pkg.Executor(place)
        self.exe.run(self.startup, scope=self.scope)
        if init is not None:
            convert.load_into_scope(self.scope, init, self.names)

    def state(self):
        return {n: convert.scope_to_numpy(self.scope, [n])[n] if is_port(self.pkg)
                else np.array(np.asarray(self.scope.vars[n])) for n in self.names}

    def step(self, feed, fetch=None, **kw):
        return self.exe.run(self.main, feed=feed, fetch_list=fetch or [self.loss],
                            scope=self.scope, **kw)
