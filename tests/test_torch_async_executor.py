"""The port's DataFeedDesc, AsyncExecutor and contrib.reader.ctr_reader on
the CPU (tests/test_async_executor.py's cases): the textproto round trip,
CTR-style sparse + dense training from MultiSlot text files through the
native C++ feed with thread_num=1 (the files parsed in order), per-period
loss means within rtol 1e-5 of the JAX package's from the same weights,
the data-runtime path (num_workers) equal to the in-process feed, and the
CTR reader feeding a program with no feed dict to EOF, loss for loss with
the JAX package's."""

import os

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as fluid
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.executor import global_scope as jglobal_scope
from paddle_tpu.executor import scope_guard as jscope_guard
from paddle_tpu_torch import convert

CPU = fluid.CPUPlace()

PROTO = """
name: "MultiSlotDataFeed"
batch_size: 8
multi_slot_desc {
  slots {
    name: "ids"
    type: "uint64"
    is_dense: false
    is_used: true
  }
  slots {
    name: "dense_x"
    type: "float"
    is_dense: true
    is_used: true
  }
  slots {
    name: "label"
    type: "uint64"
    is_dense: false
    is_used: true
  }
}
"""


def _write_files(td, nfiles=2, lines_per_file=40, n_ids=None):
    """MultiSlot text files of CTR lines: 1-3 ids (or n_ids each, so that
    every batch pads its ids to one width), 4 dense floats, a label."""
    rng = np.random.RandomState(7)
    files = []
    for fi in range(nfiles):
        p = os.path.join(td, "part-%d.txt" % fi)
        with open(p, "w") as f:
            for _ in range(lines_per_file):
                n = n_ids or rng.randint(1, 4)
                ids = rng.randint(0, 50, n)
                dense = rng.rand(4)
                label = int(dense.sum() > 2.0)
                f.write("%d %s 4 %s 1 %d\n" % (n, " ".join(map(str, ids)),
                                               " ".join("%.4f" % v for v in dense), label))
        files.append(p)
    return files


def test_data_feed_desc_roundtrip():
    desc = fluid.DataFeedDesc(PROTO)
    assert desc.batch_size == 8
    assert [s.name for s in desc.slots] == ["ids", "dense_x", "label"]
    desc.set_batch_size(16)
    text = desc.desc()
    desc2 = fluid.DataFeedDesc(text)
    assert desc2.batch_size == 16
    assert desc2.slots[1].type == "float" and desc2.slots[1].is_dense
    jdesc = jfluid.DataFeedDesc(PROTO)
    jdesc.set_batch_size(16)
    assert text == jdesc.desc()
    assert desc.native_slot_types() == jdesc.native_slot_types()
    assert [(i, s.name) for i, s in desc.used_slots()] == [
        (i, s.name) for i, s in jdesc.used_slots()]


def _ctr_program(fl):
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        ids = fl.layers.data(name="ids", shape=[-1], dtype="int64")
        dense = fl.layers.data(name="dense_x", shape=[4], dtype="float32")
        label = fl.layers.data(name="label", shape=[1], dtype="int64")
        emb = fl.layers.embedding(input=ids, size=[50, 8], is_sparse=True)
        pooled = fl.layers.reduce_sum(emb, dim=1)
        concat = fl.layers.concat([pooled, dense], axis=1)
        fc = fl.layers.fc(input=concat, size=16, act="relu")
        pred = fl.layers.fc(input=fc, size=2, act="softmax")
        loss = fl.layers.mean(fl.layers.cross_entropy(input=pred, label=label))
        fl.optimizer.Adam(learning_rate=0.05).minimize(loss)
    return main, startup, loss


def _jax_means(files):
    main, startup, loss = _ctr_program(jfluid)
    with jscope_guard(JScope(seed=0)):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
        init = {n: np.asarray(jglobal_scope().vars[n]).copy()
                for n in convert.persistable_names(main)}
        means = jfluid.AsyncExecutor(jfluid.CPUPlace()).run(
            main, jfluid.DataFeedDesc(PROTO), files, thread_num=1, fetch=[loss],
            print_period=3)
    return init, means


def _port_means(files, init, **kw):
    main, startup, loss = _ctr_program(fluid)
    scope = fluid.Scope(seed=0, place=CPU)
    with fluid.scope_guard(scope):
        fluid.Executor(CPU).run(startup)
        convert.load_into_scope(scope, init, sorted(init))
        return fluid.AsyncExecutor(CPU).run(main, fluid.DataFeedDesc(PROTO), files,
                                            thread_num=1, fetch=[loss], print_period=3, **kw)


def test_async_executor_trains_as_the_jax_package(tmp_path):
    files = _write_files(str(tmp_path))
    init, want = _jax_means(files)
    got = _port_means(files, init)
    assert len(got) == len(want) == 4  # 10 steps, periods of 3 and the rest
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_async_executor_data_runtime_path_equals_the_feed_threads(tmp_path):
    """num_workers=1 (a file a shard, decoded in a worker process, in
    filelist order) trains on the same batches as the in-process feed."""
    files = _write_files(str(tmp_path))
    init, _ = _jax_means(files)
    assert _port_means(files, init, num_workers=1) == _port_means(files, init)


def test_async_executor_needs_a_place_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a box without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fluid.AsyncExecutor()


def _ctr_reader_losses(fl, files, init=None, k=1):
    """(init, losses, calls) of the ctr_reader-fed program pulled
    steps_per_run=k a call to EOFException: the fetch's leading size of each
    call. With k > 1, a second epoch follows, pulled to its tail, and after
    reset() and start() (the tail's deferred EOF not yet raised) one more
    call."""
    from importlib import import_module

    ctr_reader = import_module(fl.__name__.split(".")[0] + ".contrib.reader.ctr_reader").ctr_reader
    eof = import_module(fl.__name__.split(".")[0] + ".py_reader").EOFException
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        ids_v = fl.layers.data(name="ids", shape=[-1, -1], dtype="int64",
                               append_batch_size=False)
        dense_v = fl.layers.data(name="dense_x", shape=[-1, 4], dtype="float32",
                                 append_batch_size=False)
        label_v = fl.layers.data(name="label", shape=[-1, 1], dtype="int64",
                                 append_batch_size=False)
        reader = ctr_reader(feed_data=[ids_v, dense_v, label_v], capacity=8, thread_num=1,
                            batch_size=8, file_list=files, slots=PROTO)
        emb = fl.layers.embedding(ids_v, size=[50, 8], is_sparse=False, padding_idx=-1)
        pooled = fl.layers.reduce_mean(emb, dim=[1])
        feat = fl.layers.concat([pooled, dense_v], axis=1)
        logits = fl.layers.fc(feat, size=2)
        loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(logits, label_v))
        fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
    if init is None:
        exe, scope, guard = fl.Executor(fl.CPUPlace()), JScope(seed=0), jscope_guard
    else:
        exe, scope, guard = fl.Executor(CPU), fl.Scope(seed=0, place=CPU), fl.scope_guard
    with guard(scope):
        exe.run(startup)
        if init is None:
            init = {n: np.asarray(scope.vars[n]).copy() for n in convert.persistable_names(main)}
        else:
            convert.load_into_scope(scope, init, sorted(init))
        reader.start()
        losses, calls = [], []
        with pytest.raises(eof):
            while True:
                (lv,) = exe.run(main, fetch_list=[loss.name], steps_per_run=k)
                lv = np.asarray(lv)
                calls.append(lv.shape[0] if k > 1 else 1)
                losses.extend(float(v) for v in (lv.reshape(calls[-1], -1)[:, 0] if k > 1
                                                 else lv.ravel()[:1]))
        reader.reset()
        if k > 1:
            def pull():
                return np.asarray(exe.run(main, fetch_list=[loss.name],
                                          steps_per_run=k)[0]).shape[0]

            reader.start()  # a second epoch, pulled to its tail
            n = len(calls)
            while len(calls) == n or calls[-1] == k:
                calls.append(pull())
            reader.reset()  # before the tail's deferred EOF was raised
            reader.start()
            calls.append(pull())
            reader.reset()
    return init, losses, calls


def test_ctr_reader_feeds_a_program_as_the_jax_package(tmp_path):
    files = _write_files(str(tmp_path))
    init, want, _ = _ctr_reader_losses(jfluid, files)
    _, got, _ = _ctr_reader_losses(fluid, files, init)
    assert len(got) == len(want) == 10  # 80 lines / batch 8
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_ctr_reader_multistep_tail_reset_and_start(tmp_path):
    """ctr_reader pulled steps_per_run=3 over its 10 batches: calls of 3, 3,
    3 and a stacked tail of 1, then EOFException; a second epoch to its
    tail, then reset() and start() before the deferred EOF was raised: the
    next call runs 3 steps (the deferred EOF went with the epoch); the
    losses within rtol 1e-5 of the JAX package's single-step
    ctr_reader run from the same weights. Each line has 3 ids, so the
    batches stack (one padded width)."""
    files = _write_files(str(tmp_path), n_ids=3)
    init, want, _ = _ctr_reader_losses(jfluid, files)
    _, got, calls = _ctr_reader_losses(fluid, files, init, k=3)
    assert calls == [3, 3, 3, 1, 3, 3, 3, 1, 3]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_ctr_reader_pushes_back_a_mid_step_batch(tmp_path):
    """A ctr_reader grouped with a py_reader that ends first: the pull
    returns the ctr batch of the incomplete step to its reader (push_back),
    which serves it next."""
    from paddle_tpu_torch.async_executor import stream_batches
    from paddle_tpu_torch.contrib.reader.ctr_reader import ctr_reader
    from paddle_tpu_torch.data_feed_desc import DataFeedDesc
    from paddle_tpu_torch.executor import _pull_reader_steps
    from paddle_tpu_torch.py_reader import PyReader

    files = _write_files(str(tmp_path), n_ids=3)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        reader = ctr_reader(capacity=8, thread_num=1, batch_size=8, file_list=files,
                            slots=PROTO)
    fluid.Executor(CPU).run(startup, scope=fluid.Scope(place=CPU))
    short = PyReader(["z"], capacity=4, place=CPU)
    short.decorate_tensor_provider(lambda: ({"z": np.full((8, 1), i, "float32")}
                                            for i in range(3)))
    reader.start()
    short.start()
    assert _pull_reader_steps([reader, short], 2)[1] == 2
    assert _pull_reader_steps([reader, short], 2)[1] == 1  # batch 3 of ctr went back
    want = list(stream_batches(DataFeedDesc(PROTO), files, thread_num=1))[3]
    got = reader.next_batch()
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_array_equal(np.asarray(got[name]), value)
    reader.reset()
