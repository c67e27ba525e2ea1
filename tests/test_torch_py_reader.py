"""The port's PyReader and layers.py_reader on the CPU: the cases of
tests/test_io_and_data.py (py_reader training to EOF, batched tuples,
feeder errors, reset mid-epoch, the epoch cache) and
tests/test_input_pipeline.py (feed / compute overlap, the uint8 and bf16
wires, the multi-reader push-back), each held against the JAX package on
the same reader: losses within rtol 1e-5 of the JAX Executor fed by the
JAX PyReader from the same weights, and the bf16 wire bit for bit with
ml_dtypes' rounding."""

import time

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as fluid
from paddle_tpu import framework as jframework
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.executor import scope_guard as jscope_guard
from paddle_tpu.py_reader import EOFException as JEOF
from paddle_tpu.py_reader import PyReader as JPyReader
from paddle_tpu_torch import convert
from paddle_tpu_torch.executor import _pull_reader_steps, _started_readers
from paddle_tpu_torch.py_reader import EOFException, PyReader, bf16_wire

CPU = fluid.CPUPlace()


def _epoch(r):
    out = []
    try:
        while True:
            out.append(r.next_batch())
    except (EOFException, JEOF):
        return out


def _reader_program(fl):
    """tests/test_io_and_data.py's py_reader program: fc 4 -> 2, softmax
    cross entropy, SGD(0.1), fed by layers.py_reader + read_file."""
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        reader = fl.layers.py_reader(capacity=4, shapes=[(-1, 4), (-1, 1)],
                                     dtypes=["float32", "int64"])
        x, label = fl.layers.read_file(reader)
        logits = fl.layers.fc(x, size=2)
        loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(logits, label))
        fl.optimizer.SGD(0.1).minimize(loss)
    return main, startup, reader, x, label, loss


def _reader_batches(n=6):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        xs = rng.randn(8, 4).astype("float32")
        out.append((xs, (xs.sum(1) > 0).astype("int64").reshape(8, 1)))
    return out


def test_py_reader_trains_to_eof_as_the_jax_package():
    """layers.py_reader + read_file, Executor.run with no feed until
    EOFException, then a second epoch after start(): the port's losses
    against the JAX package's from the same weights."""
    batches = _reader_batches()
    losses = {}
    jmain, jstartup, jreader, jx, jlabel, jloss = _reader_program(jfluid)
    jreader.decorate_tensor_provider(
        lambda: ({jx.name: a, jlabel.name: b} for a, b in batches))
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jscope_guard(JScope(seed=0)) as _:
        from paddle_tpu.executor import global_scope as jglobal

        jexe.run(jstartup)
        init = {n: np.asarray(jglobal().vars[n]).copy()
                for n in convert.persistable_names(jmain)}
        jreader.start()
        losses["jax"] = [float(jexe.run(jmain, fetch_list=[jloss.name])[0][0])
                         for _ in range(len(batches))]
        with pytest.raises(JEOF):
            jexe.run(jmain, fetch_list=[jloss.name])
    main, startup, reader, x, label, loss = _reader_program(fluid)
    assert [v.name for v in reader.vars] == [v.name for v in jreader.vars]
    reader.decorate_tensor_provider(lambda: ({x.name: a, label.name: b} for a, b in batches))
    exe = fluid.Executor(CPU)
    scope = fluid.Scope(seed=0, place=CPU)
    with fluid.scope_guard(scope):
        exe.run(startup)
        convert.load_into_scope(scope, init, sorted(init))
        reader.start()
        seen = []
        with pytest.raises(EOFException):
            while True:
                seen.append(float(exe.run(main, fetch_list=[loss.name])[0][0]))
        reader.start()  # a second epoch after the restart
        (again,) = exe.run(main, fetch_list=[loss.name])
        reader.reset()
    assert len(seen) == len(batches)
    np.testing.assert_allclose(seen, losses["jax"], rtol=1e-5)
    assert np.isfinite(again).all()


def test_program_reader_stages_on_the_scope_device():
    """A program reader's batches are tensors on the device of the executor
    that ran its startup program, and so of the scope that executor feeds
    (here the CPU), in the declared shapes; the reader is started outside
    any scope_guard."""
    main, startup, reader, x, label, _ = _reader_program(fluid)
    batches = _reader_batches(2)
    reader.decorate_tensor_provider(lambda: ({x.name: a, label.name: b} for a, b in batches))
    fluid.Executor(CPU).run(startup, scope=fluid.Scope(place=CPU))
    reader.start()
    assert reader.staged_on == (torch.device("cpu"), None)
    got = _epoch(reader)
    assert len(got) == 2
    for (a, b), feed in zip(batches, got):
        assert isinstance(feed[x.name], torch.Tensor) and feed[x.name].device.type == "cpu"
        np.testing.assert_array_equal(feed[x.name].numpy(), a)
        np.testing.assert_array_equal(feed[label.name].numpy(), b)


def test_program_reader_without_an_executor_takes_the_card():
    """A program reader that no executor has placed stages on CUDAPlace(0):
    on a box without CUDA its start() raises, as the entry points do."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a box without CUDA")
    _, _, reader, x, label, _ = _reader_program(fluid)
    reader.decorate_tensor_provider(lambda: iter(()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reader.start()


def test_a_pull_refuses_batches_staged_on_another_device():
    """A pull by an executor on another device than the one the reader's
    epoch is staged on raises, naming both, instead of copying each batch
    inside the step; after reset() the next start() stages on the device
    of the executor that ran the program."""
    from paddle_tpu_torch.executor import _resolve_reader_feed

    main, startup, reader, x, label, loss = _reader_program(fluid)
    batches = _reader_batches(2)
    reader.decorate_tensor_provider(lambda: ({x.name: a, label.name: b} for a, b in batches))
    exe, scope = fluid.Executor(CPU), fluid.Scope(place=CPU)
    exe.run(startup, scope=scope)
    reader.start()
    with pytest.raises(RuntimeError, match="stages this epoch on cpu but is pulled by an "
                                           "executor on meta"):
        _resolve_reader_feed(main, 1, torch.device("meta"))
    reader._take_place(torch.device("meta"))  # as an executor on it would
    assert reader.staged_on == (torch.device("cpu"), None)  # the epoch keeps its staging
    (lv,) = exe.run(main, fetch_list=[loss.name], scope=scope)
    assert np.isfinite(lv).all()
    reader.reset()
    exe.run(main, feed={x.name: batches[0][0], label.name: batches[0][1]},
            fetch_list=[loss.name], scope=scope)  # the run sets the device again
    reader.start()
    assert reader.staged_on == (torch.device("cpu"), None)
    reader.reset()


def test_a_new_placement_stages_the_cached_epoch_again():
    """cache_epoch: a placement given after an epoch was cached (a
    ParallelExecutor built after it) drops the cache, so the next epoch is
    staged again by the new placement instead of replaying whole batches;
    a placement that raises for a field reaches the consumer naming it."""
    pulls = []

    def src():
        pulls.append(1)
        for i in range(3):
            yield {"x": np.full((4, 3), i, "float32")}

    r = PyReader(["x"], capacity=2, cache_epoch=True, place=CPU)
    r.decorate_tensor_provider(src)
    r.start()
    assert [b["x"].shape for b in _epoch(r)] == [(4, 3)] * 3
    r.start()
    _epoch(r)
    assert len(pulls) == 1  # the cached epoch replayed

    def first_half(arr):
        return arr[: arr.shape[0] // 2]

    r.set_device_sharding(first_half)
    r.start()
    assert r.staged_on == (torch.device("cpu"), first_half)
    assert [b["x"].shape for b in _epoch(r)] == [(2, 3)] * 3
    assert len(pulls) == 2

    def refuse(arr):
        raise ValueError("batch dim %d not divisible by device count 3" % arr.shape[0])

    r.set_device_sharding(refuse)
    r.start()
    with pytest.raises(ValueError, match="feed 'x': batch dim 4 not divisible"):
        r.next_batch()


def test_batched_tuples_match_the_jax_reader():
    data = [[(np.ones(4, "float32") * i, i) for i in range(3)] for _ in range(2)]
    out = []
    for r in (PyReader(["img", "label"], return_device_arrays=False, place=CPU),
              JPyReader(["img", "label"], return_device_arrays=False)):
        r.decorate_paddle_reader(lambda: iter(data))
        r.start()
        out.append(r.next_batch())
        r.reset()
        assert r._thread is None
    assert out[0]["img"].shape == (3, 4)
    for k in ("img", "label"):
        np.testing.assert_array_equal(out[0][k], np.asarray(out[1][k]))


@pytest.mark.parametrize("mod", ["port", "jax"])
def test_feeder_exception_propagates(mod):
    """A crashing reader surfaces in the consumer, in both packages, and
    does not read as a clean EOF."""

    def bad_src():
        yield {"x": np.asarray([1.0], "float32")}
        raise RuntimeError("corrupt sample")

    r = (PyReader(["x"], capacity=2, return_device_arrays=False, place=CPU) if mod == "port"
         else JPyReader(["x"], capacity=2, return_device_arrays=False))
    r.decorate_tensor_provider(bad_src)
    r.start()
    assert r.next_batch()["x"][0] == 1.0
    with pytest.raises(RuntimeError, match="corrupt sample"):
        r.next_batch()


def test_reset_mid_epoch_stops_the_thread():
    produced = []

    def src():
        for i in range(1000):
            produced.append(i)
            yield {"x": np.asarray([i])}

    r = PyReader(["x"], capacity=2, return_device_arrays=False, place=CPU)
    r.decorate_tensor_provider(src)
    r.start()
    r.next_batch()
    thread = r._thread
    r.reset()
    assert not thread.is_alive()
    assert len(produced) < 1000


def test_epoch_cache_replays_without_the_reader():
    """cache_epoch: epoch 1 pulls the source, epochs 2-3 replay the staged
    tensors; a new dataset invalidates the cache; each epoch equals the JAX
    reader's."""
    pulls = []

    def src():
        pulls.append(1)
        for i in range(4):
            yield {"x": np.full((2, 3), i, "float32")}

    r = PyReader(["x"], capacity=2, cache_epoch=True, place=CPU)
    r.decorate_tensor_provider(src)
    epochs = []
    for _ in range(3):
        r.start()
        epochs.append([b["x"] for b in _epoch(r)])
    assert len(pulls) == 1
    j = JPyReader(["x"], capacity=2, cache_epoch=True)
    j.decorate_tensor_provider(lambda: ({"x": np.full((2, 3), i, "float32")} for i in range(4)))
    j.start()
    want = [np.asarray(b["x"]) for b in _epoch(j)]
    for e in epochs:
        assert len(e) == 4 and all(isinstance(t, torch.Tensor) for t in e)
        for a, b in zip(e, want):
            np.testing.assert_array_equal(a.numpy(), b)
    r.decorate_tensor_provider(src)
    r.start()
    _epoch(r)
    assert len(pulls) == 2


def test_partial_epoch_does_not_poison_the_cache():
    def src():
        for i in range(6):
            yield {"x": np.asarray([i], "float32")}

    r = PyReader(["x"], capacity=2, cache_epoch=True, place=CPU)
    r.decorate_tensor_provider(src)
    r.start()
    r.next_batch()
    r.reset()
    assert r._cache is None
    r.start()
    assert [int(b["x"][0]) for b in _epoch(r)] == [0, 1, 2, 3, 4, 5]
    assert r._cache is not None and len(r._cache) == 6


def _mlp(fl, n=64):
    """tests/test_input_pipeline.py's program: 4 fc of width n, mean."""
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[n], dtype="float32")
        h = x
        for _ in range(4):
            h = fl.layers.fc(h, size=n)
        loss = fl.layers.mean(h)
    return main, startup, loss


def _jax_loss(n, feed_of, wire=None):
    """(init, the JAX Executor's loss over the one batch its PyReader
    stages, with `wire` on it)."""
    main, startup, loss = _mlp(jfluid, n)
    exe = jfluid.Executor(jfluid.CPUPlace())
    r = JPyReader(["x"], capacity=2, wire_dtypes=wire)
    r.decorate_tensor_provider(lambda: iter([feed_of]))
    scope = JScope(seed=0)
    with jscope_guard(scope):
        exe.run(startup)
        init = {k: np.asarray(scope.vars[k]).copy() for k in convert.persistable_names(main)}
        r.start()
        (got,) = exe.run(main, feed=r.next_batch(), fetch_list=[loss.name])
        r.reset()
    return init, got


def _port_losses(n, init, feeds):
    main, startup, loss = _mlp(fluid, n)
    exe = fluid.Executor(CPU)
    scope = fluid.Scope(seed=0, place=CPU)
    exe.run(startup, scope=scope)
    convert.load_into_scope(scope, init, sorted(init))
    return [exe.run(main, feed=f, fetch_list=[loss.name], scope=scope)[0] for f in feeds]


def test_pyreader_overlaps_feed_with_compute():
    """The feeder thread stages batch N+1 while step N runs: judged from the
    feeder's and the steps' own timestamps (when the feeder began each
    batch, when each step began and ended), so a loaded machine that slows
    both sides does not change the verdict. Fed in turns, the feeder would
    begin batch N+1 only after step N ended."""
    delay, steps = 0.08, 6
    main, startup, loss = _mlp(fluid, 512)
    exe = fluid.Executor(CPU)
    scope = fluid.Scope(seed=0, place=CPU)
    exe.run(startup, scope=scope)
    batch = {"x": np.random.RandomState(0).rand(64, 512).astype("float32")}
    exe.run(main, feed=batch, fetch_list=[loss.name], scope=scope)
    began = []

    def slow_reader():
        for _ in range(steps):
            began.append(time.perf_counter())
            time.sleep(delay)
            yield dict(batch)

    reader = PyReader(["x"], capacity=2, place=CPU)
    reader.decorate_tensor_provider(slow_reader)
    reader.start()
    runs = []
    for feed in reader():
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[loss.name], scope=scope)
        runs.append((t0, time.perf_counter()))
    assert len(runs) == steps and len(began) == steps
    # the feeder was at work on batch n + 1 before step n ended
    overlapped = [n for n in range(steps - 1) if began[n + 1] < runs[n][1]]
    assert len(overlapped) >= steps - 2, (began, runs)


def test_uint8_wire_against_f32_and_the_jax_package():
    """uint8 on the wire: the staged tensor is uint8, the executor's feed
    in the declared f32 makes the cast, and the loss equals the f32 feed's
    (rtol 1e-6) and the JAX package's uint8-wire loss (rtol 1e-5)."""
    img = np.random.RandomState(1).randint(0, 256, (8, 64)).astype("uint8")
    init, jgot = _jax_loss(64, {"x": img}, {"x": "uint8"})
    wire = PyReader(["x"], capacity=2, wire_dtypes={"x": "uint8"}, place=CPU)
    wire.decorate_tensor_provider(lambda: iter([{"x": img}]))
    wire.start()
    batch = wire.next_batch()
    wire.reset()
    assert batch["x"].dtype == torch.uint8
    got, want = _port_losses(64, init, [batch, {"x": img.astype("float32")}])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, jgot, rtol=1e-5)


def test_bf16_wire_bits_and_loss_against_the_jax_package():
    """bf16 on the wire: bf16_wire's uint16 equals ml_dtypes' bfloat16
    bits (round to nearest even, halfway cases, NaN, inf, subnormals), the
    staged tensor is torch.bfloat16 of half the bytes, and the loss equals
    the JAX package's bf16-wire loss (rtol 1e-5)."""
    import ml_dtypes

    x = np.random.RandomState(2).rand(8, 64).astype("float32")
    edges = np.array([0.0, -0.0, 1.0, 1.00390625, 1.01171875, 3.4e38, -3.4e38, np.inf,
                      -np.inf, np.nan, 1e-40, -1e-45, 65504.0, 1 + 2 ** -8, 1 + 3 * 2 ** -8],
                     "float32")
    for v in (x, edges, np.random.RandomState(3).randn(4096).astype("float32") * 1e3):
        want = v.astype(ml_dtypes.bfloat16).view(np.uint16)
        got = bf16_wire(v)
        nan = np.isnan(v)
        np.testing.assert_array_equal(got[~nan], want[~nan])
        assert np.isnan(got[nan].view(ml_dtypes.bfloat16).astype("float32")).all()
    init, jgot = _jax_loss(64, {"x": x}, {"x": "bfloat16"})
    wire = PyReader(["x"], capacity=2, wire_dtypes={"x": "bfloat16"}, place=CPU)
    wire.decorate_tensor_provider(lambda: iter([{"x": x}]))
    wire.start()
    batch = wire.next_batch()
    wire.reset()
    assert batch["x"].dtype == torch.bfloat16
    assert batch["x"].numel() * batch["x"].element_size() == x.nbytes // 2
    np.testing.assert_array_equal(batch["x"].view(torch.int16).numpy().view(np.uint16),
                                  x.astype(ml_dtypes.bfloat16).view(np.uint16))
    (got,) = _port_losses(64, init, [batch])
    np.testing.assert_allclose(got, jgot, rtol=1e-5)


def test_multireader_midstep_eof_pushback_and_group_eof():
    """One reader of a program's group ends mid-step in a multi-step pull:
    the siblings' batches of the incomplete step go back, the tail runs,
    and the next pull raises EOF for the group — in both packages alike."""
    from paddle_tpu.executor import _pull_reader_steps as jpull
    from paddle_tpu.executor import _started_readers as jstarted

    def make(cls, name, n, **kw):
        rd = cls([name], capacity=8, return_device_arrays=False, **kw)
        rd.decorate_tensor_provider(
            lambda: ({name: np.full((2, 3), i, "float32")} for i in range(n)))
        rd.start()
        return rd

    for cls, pull, started, eof, kw in ((PyReader, _pull_reader_steps, _started_readers,
                                         EOFException, {"place": CPU}),
                                        (JPyReader, jpull, jstarted, JEOF, {})):
        ra, rb = make(cls, "a", 5, **kw), make(cls, "b", 3, **kw)
        feed, k = pull([ra, rb], 2)
        assert k == 2 and feed["a"].shape == (2, 2, 3)
        feed, k = pull([ra, rb], 2)
        assert k == 1 and float(np.asarray(feed["a"])[0, 0, 0]) == 2.0

        class P:
            _py_readers = [ra, rb]

        with pytest.raises(eof):
            started(P())
        assert float(np.asarray(ra.next_batch()["a"])[0, 0]) == 3.0


def test_pyreader_needs_a_place_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a box without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PyReader(["x"])
