"""The fluid CNN training surface of the torch port against the JAX package,
on the CPU: the book script (tests/test_mnist.py's two scripts) through
`paddle_tpu_torch.fluid`, LeNet-5 and a ResNet trained 3 steps in both
packages from the same weights, the model builders' programs and the
training_fused pass's tags, the data pipeline (dataset streams, reader
decorators, batch, DataFeeder) and checkpoints written by one package and
loaded by the other.

Tolerances: losses and every persistable after 3 steps (parameters, Adam
moments, Momentum velocities, batch_norm's running statistics) at rtol
2e-3, atol 2e-4, the JAX package's fused-vs-unfused bar
(tests/test_fused_kernels.py:25-26); one forward on the same weights at
rtol = atol = 1e-5.
"""

import os
import random

import numpy as np
import pytest

import jax

import paddle_tpu.fluid as jfluid
from paddle_tpu import dataset as jdataset
from paddle_tpu import reader as jreader
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.executor import scope_guard as jscope_guard
from paddle_tpu.models import lenet as jlenet
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.ops import pallas_kernels as jpk
from paddle_tpu.passes import manager as jmanager

import paddle_tpu_torch as pt
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import convert
from paddle_tpu_torch.models import lenet as plenet
from paddle_tpu_torch.models import resnet as presnet
from paddle_tpu_torch.ops import fused
from paddle_tpu_torch.passes import manager as pmanager

jax.config.update("jax_platforms", "cpu")

RTOL, ATOL = 2e-3, 2e-4
FWD_TOL = 1e-5
STEPS = 3
TAGS = ("__pallas_group__", "__pallas_kernel__", "__fusion_group__")


def make_batch(rng, batch_size, num_classes=10):
    """tests/test_mnist.py's images: the top-left patch encodes the label."""
    labels = rng.randint(0, num_classes, (batch_size, 1)).astype("int64")
    imgs = rng.randn(batch_size, 1, 28, 28).astype("float32") * 0.1
    for i, l in enumerate(labels.flatten()):
        imgs[i, 0, :14, :14] += l / float(num_classes)
        imgs[i, 0, 14:, 14:] -= l / float(num_classes)
    return imgs, labels


# --------------------------------------------------------------------------
# the book script on the port (tests/test_mnist.py)
# --------------------------------------------------------------------------


def lenet(img, label):
    conv1 = fluid.layers.conv2d(img, num_filters=6, filter_size=5, padding=2, act="relu")
    pool1 = fluid.layers.pool2d(conv1, pool_size=2, pool_stride=2)
    conv2 = fluid.layers.conv2d(pool1, num_filters=16, filter_size=5, act="relu")
    pool2 = fluid.layers.pool2d(conv2, pool_size=2, pool_stride=2)
    fc1 = fluid.layers.fc(pool2, size=120, act="relu")
    fc2 = fluid.layers.fc(fc1, size=84, act="relu")
    logits = fluid.layers.fc(fc2, size=10)
    loss = fluid.layers.softmax_with_cross_entropy(logits, label)
    avg_loss = fluid.layers.mean(loss)
    acc = fluid.layers.accuracy(fluid.layers.softmax(logits), label)
    return avg_loss, acc


def test_mnist_lenet_converges():
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[1, 28, 28], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        avg_loss, acc = lenet(img, label)
        test_program = main.clone(for_test=True)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(avg_loss)

    exe = fluid.Executor(fluid.CPUPlace())
    rng = np.random.RandomState(7)
    with fluid.scope_guard(fluid.Scope(seed=7, place=fluid.CPUPlace())):
        exe.run(startup)
        losses, accs = [], []
        for _ in range(60):
            imgs, labels = make_batch(rng, 32)
            loss_v, acc_v = exe.run(main, feed={"img": imgs, "label": labels},
                                    fetch_list=[avg_loss.name, acc.name])
            losses.append(float(loss_v[0]))
            accs.append(float(acc_v[0]))
        first5, last5 = np.mean(losses[:5]), np.mean(losses[-5:])
        assert last5 < first5 * 0.7, "loss did not decrease: %s -> %s" % (first5, last5)
        assert np.mean(accs[-5:]) > 0.5, "accuracy too low: %s" % np.mean(accs[-5:])
        imgs, labels = make_batch(rng, 16)
        (test_loss,) = exe.run(test_program, feed={"img": imgs, "label": labels},
                               fetch_list=[avg_loss.name])
        assert np.isfinite(test_loss).all()


@pytest.mark.parametrize("make_opt", [
    lambda: fluid.optimizer.SGD(learning_rate=0.1),
    lambda: fluid.optimizer.Momentum(learning_rate=0.05, momentum=0.9),
], ids=["sgd", "momentum"])
def test_sgd_and_momentum_also_train(make_opt):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(x, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        make_opt().minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    rng = np.random.RandomState(0)
    w = rng.randn(8, 1).astype("float32")
    with fluid.scope_guard(fluid.Scope(place=fluid.CPUPlace())):
        exe.run(startup)
        losses = []
        for _ in range(40):
            xs = rng.randn(16, 8).astype("float32")
            (lv,) = exe.run(main, feed={"x": xs, "y": xs @ w}, fetch_list=[loss.name])
            losses.append(float(lv[0]))
    assert losses[-1] < losses[0] * 0.3


def test_book_pipeline_trains_through_the_data_feeder():
    """The user path of the card's smoke run, on the CPU: batch(reader.
    shuffle(dataset.mnist.train(), 500), 64) into a DataFeeder, LeNet-5
    under Adam and training_fused, the for_test clone, then a checkpoint
    round trip into a fresh scope with the same test loss bit for bit."""
    import tempfile

    from paddle_tpu_torch.models import lenet5

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[1, 28, 28], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        loss, acc, _ = lenet5(img, label)
        test_program = main.clone(for_test=True)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    samples = fluid.reader.map_readers(lambda s: (s[0].reshape(1, 28, 28), s[1]),
                                       fluid.dataset.mnist.train())
    random.seed(0)
    train = fluid.batch(fluid.reader.shuffle(samples, 500), 64)
    feeder = fluid.DataFeeder([img, label], place=fluid.CPUPlace(), program=main)
    exe = fluid.Executor(fluid.CPUPlace())
    fluid.set_flags({"pass_pipeline": "training_fused"})
    try:
        with fluid.scope_guard(fluid.Scope(seed=0, place=fluid.CPUPlace())):
            exe.run(startup)
            losses = []
            for i, data in enumerate(train()):
                if i == 8:
                    break
                (lv,) = exe.run(main, feed=feeder.feed(data), fetch_list=[loss.name])
                losses.append(float(lv[0]))
            assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
            test_feed = feeder.feed([(s.reshape(1, 28, 28), l) for s, l in
                                     fluid.reader.firstn(fluid.dataset.mnist.test(), 16)()])
            (want,) = exe.run(test_program, feed=test_feed, fetch_list=[loss.name])
            with tempfile.TemporaryDirectory() as d:
                fluid.io.save_persistables(exe, d, main)
                with fluid.scope_guard(fluid.Scope(seed=1, place=fluid.CPUPlace())):
                    fluid.io.load_persistables(exe, d, main)
                    (got,) = exe.run(test_program, feed=test_feed, fetch_list=[loss.name])
    finally:
        fluid.set_flags({"pass_pipeline": ""})
    assert got.tobytes() == want.tobytes()


# --------------------------------------------------------------------------
# the model builders: the same programs in both packages
# --------------------------------------------------------------------------

MODELS = {
    # name: (program_fn module attr, image shape, optimizer, program_fn kwargs)
    "lenet5": ("lenet", "lenet5", [1, 28, 28], "adam", {}),
    "resnet_cifar10": ("resnet", "resnet_cifar10", [3, 16, 16], "momentum", {"depth": 8}),
    "resnet50": ("resnet", "resnet50", [3, 224, 224], "momentum", {}),
}
JMODS = {"lenet": jlenet, "resnet": jresnet}
PMODS = {"lenet": plenet, "resnet": presnet}


def _opt(pkg, kind):
    if kind == "adam":
        return pkg.optimizer.Adam(learning_rate=1e-3)
    return pkg.optimizer.Momentum(learning_rate=0.05, momentum=0.9)


def build(pkg, mods, name, minimize=True):
    mod, fn, shape, opt, kw = MODELS[name]
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = pkg.layers.data(name="img", shape=shape, dtype="float32")
        label = pkg.layers.data(name="label", shape=[1], dtype="int64")
        loss, acc, logits = getattr(mods[mod], fn)(img, label, **kw)
        test_program = main.clone(for_test=True)
        if minimize:
            _opt(pkg, opt).minimize(loss)
    return main, startup, loss, acc, test_program


def _ops(program):
    out = []
    for op in program.global_block().ops:
        attrs = {k: repr(v) for k, v in sorted(op.attrs.items())}
        out.append((op.type, {k: list(v) for k, v in sorted(op.inputs.items())},
                    {k: list(v) for k, v in sorted(op.outputs.items())}, attrs))
    return out


def _vars(program):
    return {n: (tuple(v.shape) if v.shape is not None else None, v.dtype, bool(v.persistable))
            for n, v in program.global_block().vars.items()}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_builds_the_same_program(name):
    minimize = name != "resnet50"  # resnet50: the forward program, build only
    j = build(jfluid, JMODS, name, minimize)
    p = build(pt, PMODS, name, minimize)
    for jp, pp in ((j[0], p[0]), (j[1], p[1]), (j[4], p[4])):
        assert _ops(pp) == _ops(jp)
        assert _vars(pp) == _vars(jp)


@pytest.mark.parametrize("name", ["lenet5", "resnet_cifar10"])
def test_training_fused_tags_match(name):
    outs = []
    for pkg, mods, manager in ((jfluid, JMODS, jmanager), (pt, PMODS, pmanager)):
        main, _, loss, _, _ = build(pkg, mods, name)
        outs.append(manager.PassManager("training_fused").apply(
            main, scope=None, feed_names=["img", "label"], fetch_names=[loss.name]))
    views = [[(op.type, sorted(op.input_arg_names), sorted(op.output_arg_names),
               tuple(op.attrs.get(t) for t in TAGS)) for op in o.global_block().ops]
             for o in outs]
    assert views[1] == views[0]
    kernels = {v[3][1] for v in views[1] if v[3][1]}
    # LeNet's three fc chains take the GEMM epilogue, its Adam one
    # multi_adam run; the ResNet's one fc (k = 64, n = 10) takes it too, and
    # Momentum has no fused family
    assert kernels == ({"gemm_epilogue", "multi_adam"} if name == "lenet5"
                       else {"gemm_epilogue"})


# --------------------------------------------------------------------------
# 3 training steps in both packages from the same weights
# --------------------------------------------------------------------------


def _feeds(name, steps):
    rng = np.random.RandomState(3)
    shape = MODELS[name][2]
    out = []
    for _ in range(steps):
        if name == "lenet5":
            imgs, labels = make_batch(rng, 8)
        else:
            imgs = rng.randn(8, *shape).astype("float32")
            labels = rng.randint(0, 10, (8, 1)).astype("int64")
        out.append({"img": imgs, "label": labels})
    return out


def _jax_train(name, pipeline, feeds):
    from paddle_tpu import flags as jflags

    jflags.set_flags({"pass_pipeline": pipeline})
    jpk.KERNEL_DISPATCHES.clear()
    try:
        main, startup, loss, _, _ = build(jfluid, JMODS, name)
        names = convert.persistable_names(main)
        scope, exe = JScope(seed=7), jfluid.Executor()
        with jscope_guard(scope):
            exe.run(startup)
            init = {n: np.array(np.asarray(scope.vars[n])) for n in names}
            losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss.name])[0])
                            .reshape(-1)[0]) for f in feeds]
            final = {n: np.array(np.asarray(scope.vars[n])) for n in names}
        return dict(init=init, losses=losses, final=final, names=names,
                    dispatches=dict(jpk.KERNEL_DISPATCHES))
    finally:
        jflags.set_flags({"pass_pipeline": ""})


def _port_train(name, pipeline, feeds, init):
    pt.set_flags({"pass_pipeline": pipeline})
    fused.reset_stats()
    try:
        main, startup, loss, _, _ = build(pt, PMODS, name)
        names = convert.persistable_names(main)
        scope, exe = pt.Scope(seed=7, place=pt.CPUPlace()), pt.Executor(pt.CPUPlace())
        with pt.scope_guard(scope):
            exe.run(startup)
            convert.load_into_scope(scope, init, names)
            losses = [float(exe.run(main, feed=f, fetch_list=[loss.name])[0].reshape(-1)[0])
                      for f in feeds]
        return dict(losses=losses, final=convert.scope_to_numpy(scope, names), names=names,
                    stats=fused.stats())
    finally:
        pt.set_flags({"pass_pipeline": ""})


@pytest.fixture(scope="module", params=[
    ("lenet5", "training_fused"), ("lenet5", ""), ("resnet_cifar10", "training_fused")],
    ids=["lenet5_fused", "lenet5_unfused", "resnet_cifar10_fused"])
def trained(request):
    name, pipeline = request.param
    feeds = _feeds(name, STEPS)
    j = _jax_train(name, pipeline, feeds)
    return name, pipeline, j, _port_train(name, pipeline, feeds, j["init"])


def test_losses_match(trained):
    _, _, j, p = trained
    assert np.all(np.isfinite(p["losses"]))
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=RTOL, atol=ATOL)


def test_persistables_after_steps_match(trained):
    name, _, j, p = trained
    assert p["names"] == j["names"]
    if name == "resnet_cifar10":
        assert any(n.endswith(".w_2") or "batch_norm" in n for n in p["names"])
    for n in j["names"]:
        np.testing.assert_allclose(p["final"][n], j["final"][n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)
        if not np.array_equal(j["final"][n], j["init"][n]):
            assert not np.array_equal(p["final"][n], j["init"][n]), n


def test_dispatch_counts_match(trained):
    """The same fused runs accepted in both packages: the JAX package counts
    while it traces the step (once), the port every step. LeNet takes the
    GEMM epilogue for its three fc chains; on the CPU no kernel launches."""
    name, pipeline, j, p = trained
    assert p["stats"]["dispatches"] == {k: STEPS * v for k, v in j["dispatches"].items()}
    if pipeline and name == "lenet5":
        assert p["stats"]["dispatches"]["gemm_epilogue"] == 3 * STEPS
        assert p["stats"]["dispatches"]["multi_adam"] == STEPS
    if not pipeline:
        assert not p["stats"]["dispatches"]
    assert not any(p["stats"]["launches"].values())


def test_running_statistics_advance(trained):
    name, _, j, p = trained
    stats = [n for n in j["names"] if n.startswith("batch_norm") and
             (n.endswith(".w_1") or n.endswith(".w_2"))]
    if name != "resnet_cifar10":
        assert not stats
        return
    assert stats
    for n in stats:
        assert not np.array_equal(p["final"][n], j["init"][n]), n


# --------------------------------------------------------------------------
# the data pipeline
# --------------------------------------------------------------------------

STREAMS = {
    "mnist_train": lambda ds: ds.mnist.train(),
    "mnist_test": lambda ds: ds.mnist.test(),
    "cifar_train10": lambda ds: ds.cifar.train10(),
    "cifar_test100": lambda ds: ds.cifar.test100(),
}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_dataset_streams_match_through_shuffle_and_batch(stream):
    got = []
    for ds, rd, batch in ((jdataset, jreader, jfluid.batch), (pt.dataset, pt.reader, pt.batch)):
        random.seed(11)
        reader = batch(rd.shuffle(rd.firstn(STREAMS[stream](ds), 300), 100), 32)
        got.append([b for b in reader()])
    assert len(got[1]) == len(got[0]) == 10
    for bj, bp in zip(*got):
        assert len(bj) == len(bp)
        for (xj, yj), (xp, yp) in zip(bj, bp):
            assert yj == yp
            np.testing.assert_array_equal(xp, xj)


def test_reader_decorators_match():
    def r():
        return iter(range(10))

    for rd, batch in ((jreader, jfluid.batch), (pt.reader, pt.batch)):
        assert list(rd.firstn(r, 3)()) == [0, 1, 2]
        assert sorted(rd.shuffle(r, 5)()) == list(range(10))
        assert list(rd.map_readers(lambda a: a * 2, r)()) == [2 * i for i in range(10)]
        assert list(rd.buffered(r, 2)()) == list(range(10))
        assert len(list(rd.chain(r, r)())) == 20
        assert list(rd.xmap_readers(lambda a: a + 1, r, 2, 4, order=True)()) == list(
            range(1, 11))
        batches = list(batch(r, 4)())
        assert batches[0] == [0, 1, 2, 3] and batches[-1] == [8, 9]
    data = np.arange(6).reshape(3, 2)
    assert [list(a) for a in pt.reader.creator.np_array(data)()] == [[0, 1], [2, 3], [4, 5]]


def test_data_feeder_output_matches():
    samples = [(np.random.RandomState(i).rand(784).astype("float32").reshape(1, 28, 28), i % 10)
               for i in range(5)]
    lod = [([1, 2, 3], 0), ([4, 5], 1)]
    out = []
    for pkg in (jfluid, fluid):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            img = pkg.layers.data(name="img", shape=[1, 28, 28], dtype="float32")
            label = pkg.layers.data(name="label", shape=[1], dtype="int64")
        out.append(pkg.DataFeeder([img, label], program=main).feed(samples))
    for k in out[0]:
        assert out[1][k].dtype == out[0][k].dtype and out[1][k].shape == out[0][k].shape
        np.testing.assert_array_equal(out[1][k], out[0][k])
    padded, lens = pt.create_lod_tensor([np.array(a) for a, _ in lod], [[3, 2]])
    jpadded, jlens = jfluid.create_lod_tensor([np.array(a) for a, _ in lod], [[3, 2]])
    np.testing.assert_array_equal(padded, jpadded)
    np.testing.assert_array_equal(lens, jlens)


def test_metrics_and_average_match():
    from paddle_tpu import average as javg
    from paddle_tpu import metrics as jmetrics

    rng = np.random.RandomState(2)
    preds = rng.rand(64, 1)
    labels = (rng.rand(64, 1) < preds).astype("int64")
    vals = []
    for metrics, average in ((jmetrics, javg), (pt.metrics, pt.average)):
        auc = metrics.Auc("auc")
        auc.update(np.concatenate([1 - preds, preds], 1), labels)
        acc = metrics.Accuracy()
        acc.update(0.75, 16)
        acc.update(0.5, 16)
        wa = average.WeightedAverage()
        wa.add(2.0, 1)
        wa.add(4.0, 3)
        vals.append((auc.eval(), acc.eval(), wa.eval()))
    assert vals[1] == vals[0]


# --------------------------------------------------------------------------
# checkpoints across the packages
# --------------------------------------------------------------------------


def _trained_scope(pkg_name, feeds):
    """LeNet-5 trained one step in one package (each from its own startup):
    (program, test program, loss, executor, scope, guard)."""
    if pkg_name == "jax":
        main, startup, loss, _, test = build(jfluid, JMODS, "lenet5")
        exe, scope, guard = jfluid.Executor(), JScope(seed=3), jscope_guard
    else:
        main, startup, loss, _, test = build(pt, PMODS, "lenet5")
        exe, scope, guard = pt.Executor(pt.CPUPlace()), pt.Scope(seed=3, place=pt.CPUPlace()), \
            pt.scope_guard
    with guard(scope):
        exe.run(startup)
        exe.run(main, feed=feeds[0], fetch_list=[loss.name])
    return main, test, loss, exe, scope, guard


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("combined", [False, True], ids=["per_var", "one_file"])
def test_persistables_round_trip_across_packages(tmp_path, direction, combined):
    feeds = _feeds("lenet5", 2)
    src, dst = ("jax", "port") if direction == "jax_to_port" else ("port", "jax")
    s_main, s_test, s_loss, s_exe, s_scope, s_guard = _trained_scope(src, feeds)
    d_main, d_test, d_loss, d_exe, d_scope, d_guard = _trained_scope(dst, feeds)
    s_io = jfluid.io if src == "jax" else fluid.io
    d_io = jfluid.io if dst == "jax" else fluid.io
    filename = "params" if combined else None
    with s_guard(s_scope):
        s_io.save_persistables(s_exe, str(tmp_path), s_main, filename=filename)
        (want,) = s_exe.run(s_test, feed=feeds[1], fetch_list=[s_loss.name])
    with d_guard(d_scope):
        d_io.load_persistables(d_exe, str(tmp_path), d_main, filename=filename)
        (got,) = d_exe.run(d_test, feed=feeds[1], fetch_list=[d_loss.name])
    names = convert.persistable_names(s_main)
    assert names == convert.persistable_names(d_main)
    for n in names:
        a = np.asarray(s_scope.vars[n])
        b = d_scope.vars[n]
        b = b.numpy() if hasattr(b, "numpy") and not isinstance(b, np.ndarray) else np.asarray(b)
        np.testing.assert_array_equal(b, a, err_msg=n)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=FWD_TOL, atol=FWD_TOL)
    files = os.listdir(tmp_path)
    assert ("params.npz" in files) if combined else any(f.endswith(".npy") for f in files)


def test_load_arrays_and_get_inference_program(tmp_path):
    feeds = _feeds("lenet5", 2)
    main, test, loss, exe, scope, guard = _trained_scope("port", feeds)
    with guard(scope):
        fluid.io.save_params(exe, str(tmp_path), main)
        infer = fluid.io.get_inference_program([loss], main_program=main)
        assert not any(op.type in ("adam", "conv2d_grad") for op in infer.global_block().ops)
        (a,) = exe.run(infer, feed=feeds[1], fetch_list=[loss.name])
        (b,) = exe.run(test, feed=feeds[1], fetch_list=[loss.name])
    assert a.tobytes() == b.tobytes()
    arrays = fluid.io.load_arrays(str(tmp_path))
    params = [p.name for p in main.global_block().all_parameters()]
    assert sorted(arrays) == sorted(params)
    for n in params:
        np.testing.assert_array_equal(arrays[n].numpy(), scope.vars[n].numpy())


# --------------------------------------------------------------------------
# the book's sequence scripts (tests/test_book.py:62, :114, :163) through
# paddle_tpu_torch.fluid, with their gates
# --------------------------------------------------------------------------


def _port_exe_scope():
    return pt.Executor(pt.CPUPlace()), pt.Scope(seed=0, place=pt.CPUPlace())


@pytest.mark.parametrize("head", ["nce", "hsigmoid"])
def test_word2vec_nce_and_hsigmoid(head):
    """The N-gram language model with the NCE head and the hsigmoid head:
    the mean of the last 10 losses under 0.7x the first 10's."""
    rng = np.random.RandomState(3)
    V, E, N, B = 40, 16, 4, 32
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        words = [fluid.layers.data(name="w%d" % i, shape=[1], dtype="int64") for i in range(N)]
        target = fluid.layers.data(name="t", shape=[1], dtype="int64")
        embs = [fluid.layers.embedding(w, size=[V, E], param_attr=fluid.ParamAttr(name="emb"))
                for w in words]
        hidden = fluid.layers.fc(fluid.layers.concat(embs, axis=1), size=32, act="relu")
        if head == "nce":
            cost = fluid.layers.nce(hidden, target, num_total_classes=V, num_neg_samples=8)
        else:
            cost = fluid.layers.hsigmoid(hidden, target, num_classes=V)
        loss = fluid.layers.mean(cost)
        fluid.optimizer.Adam(0.02).minimize(loss)
    ws = rng.randint(0, V, (B, N)).astype("int64")
    t = ((ws.sum(1) * 7 + 3) % V).astype("int64")
    feed = {"w%d" % i: ws[:, i:i + 1] for i in range(N)}
    feed["t"] = t[:, None]
    exe, scope = _port_exe_scope()
    with pt.scope_guard(scope):
        exe.run(startup)
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss.name])[0].reshape(()))
                  for _ in range(60)]
    assert np.isfinite(losses).all(), head
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) * 0.7, (head, losses[:3], losses[-3:])


def test_understand_sentiment_conv():
    """embedding -> two sequence_conv_pool windows -> softmax: the last
    loss under 0.5x the first and the last accuracy at least 0.9."""
    rng = np.random.RandomState(5)
    V, B, T = 30, 16, 12
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        words = fluid.layers.data(name="words", shape=[B, T, 1], dtype="int64",
                                  append_batch_size=False)
        main.global_block().create_var(name="wlen", shape=(B,), dtype="int64")
        words._len_name = "wlen"
        label = fluid.layers.data(name="label", shape=[B, 1], dtype="int64",
                                  append_batch_size=False)
        emb = fluid.layers.embedding(words, size=[V, 24])
        conv3 = fluid.nets.sequence_conv_pool(emb, num_filters=16, filter_size=3, act="tanh",
                                              pool_type="max")
        conv4 = fluid.nets.sequence_conv_pool(emb, num_filters=16, filter_size=4, act="tanh",
                                              pool_type="max")
        logits = fluid.layers.fc([conv3, conv4], size=2)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(logits, label))
        acc = fluid.layers.accuracy(fluid.layers.softmax(logits), label)
        fluid.optimizer.Adam(5e-3).minimize(loss)
    ws = rng.randint(0, V, (B, T, 1)).astype("int64")
    lens = rng.randint(5, T + 1, (B,)).astype("int64")
    lab = np.zeros((B, 1), np.int64)
    for b in range(B):
        ws[b, lens[b]:] = 0
        lab[b, 0] = int((ws[b, :lens[b], 0] == 7).any())
    exe, scope = _port_exe_scope()
    with pt.scope_guard(scope):
        exe.run(startup)
        vals = [exe.run(main, feed={"words": ws, "wlen": lens, "label": lab},
                        fetch_list=[loss.name, acc.name]) for _ in range(40)]
    losses = [float(v[0].reshape(())) for v in vals]
    accs = [float(v[1].reshape(())) for v in vals]
    assert losses[-1] < losses[0] * 0.5
    assert accs[-1] >= 0.9


def test_label_semantic_roles_crf():
    """embedding -> GRU -> CRF, then Viterbi decoding with the trained
    transition: the last loss under 0.3x the first, tag accuracy above
    0.9."""
    rng = np.random.RandomState(11)
    V, B, T, TAGS_N = 25, 8, 7, 5
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        words = fluid.layers.data(name="words", shape=[B, T, 1], dtype="int64",
                                  append_batch_size=False)
        main.global_block().create_var(name="wlen", shape=(B,), dtype="int64")
        words._len_name = "wlen"
        tags = fluid.layers.data(name="tags", shape=[B, T, 1], dtype="int64",
                                 append_batch_size=False)
        emb = fluid.layers.embedding(words, size=[V, 16])
        proj = fluid.layers.fc(emb, size=24 * 3, num_flatten_dims=2)
        proj._len_name = "wlen"
        gru = fluid.layers.dynamic_gru(proj, size=24)
        emission = fluid.layers.fc(gru, size=TAGS_N, num_flatten_dims=2)
        emission._len_name = "wlen"
        crf_cost = fluid.layers.linear_chain_crf(emission, tags,
                                                 param_attr=fluid.ParamAttr(name="crfw"))
        loss = fluid.layers.mean(crf_cost)
        decode = fluid.layers.crf_decoding(emission, param_attr="crfw")
        fluid.optimizer.Adam(0.02).minimize(loss)
    ws = rng.randint(0, V, (B, T, 1)).astype("int64")
    tg = (ws % TAGS_N).astype("int64")
    lens = rng.randint(3, T + 1, (B,)).astype("int64")
    feed = {"words": ws, "tags": tg, "wlen": lens}
    exe, scope = _port_exe_scope()
    with pt.scope_guard(scope):
        exe.run(startup)
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss.name])[0].reshape(()))
                  for _ in range(80)]
        (dv,) = exe.run(main, feed=feed, fetch_list=[decode.name])
    assert losses[-1] < losses[0] * 0.3
    dv = dv.reshape(B, T)
    acc = np.mean([np.mean(dv[b, :lens[b]] == tg[b, :lens[b], 0]) for b in range(B)])
    assert acc > 0.9, acc
