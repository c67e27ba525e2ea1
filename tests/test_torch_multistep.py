"""steps_per_run > 1 (executor._MultiStepBlock) on the CPU: k steps in one
call equal k single runs of the port bit for bit, dropout included, and
the JAX package's multi-step block (a lax.scan over the stacked feeds)
loss for loss within rtol 1e-5; the stacked-dict and feed-list forms, the
stacked fetches, and the refusals of tests/test_multistep.py (host ops, a
block that creates persistables, k < 1); the ParallelExecutor's k steps
at dp 2 (gloo, spawned ranks) against the JAX single-device run.

The py_reader forms of tests/test_multistep.py (Executor.run with no feed
pulling k staged batches a call, the epoch's tail and the deferred EOF,
the restart, layers.py_reader, the PE at dp 2): bit for bit the same
batches fed as stacked dicts, and within rtol 1e-5 of the JAX package's
reader-fed runs; a pull reaches the block that a dict feed reaches."""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as fluid
import torch_parallel_ranks as R
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.executor import scope_guard as jscope_guard
from paddle_tpu_torch import convert


def _port_train(batches, k, dropout=0.0, seed=0, init=None, fetch_h=False):
    """(losses, final fc params[, stacked h fetch]) of the port's MLP: k=1
    runs each batch alone, k > 1 takes them k at a time in one call."""
    main, startup, loss = R.build_sq_mlp(fluid, dropout, seed)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope(seed=11, place=fluid.CPUPlace())
    exe.run(startup, scope=scope)
    if init is not None:
        convert.load_into_scope(scope, init, sorted(init))
    h = [op for op in main.global_block().ops if op.type == "relu"][0].output("Out")[0]
    fetch = [loss.name] + ([h] if fetch_h else [])
    losses, hs = [], []
    for i in range(0, len(batches), k):
        if k == 1:
            vals = exe.run(main, feed=batches[i], fetch_list=fetch, scope=scope)
            losses.append(float(vals[0].reshape(-1)[0]))
            hs.append(vals[-1])
        else:
            vals = exe.run(main, feed=batches[i:i + k], fetch_list=fetch, scope=scope,
                           steps_per_run=k)
            assert vals[0].shape[0] == k
            losses.extend(float(v) for v in vals[0].reshape(k))
            hs.extend(vals[-1])
    params = {n: scope.vars[n].numpy().copy() for n in sorted(scope.vars) if n.startswith("fc_")}
    return (losses, params, hs) if fetch_h else (losses, params)


def _jax_train(batches, k):
    """(init arrays, losses) of the JAX package's MLP: single runs, or its
    _MultiStepBlock k steps a call."""
    main, startup, loss = R.build_sq_mlp(jfluid)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = JScope(seed=11)
    losses = []
    with jscope_guard(scope):
        exe.run(startup)
        init = {n: np.asarray(scope.vars[n]).copy() for n in convert.persistable_names(main)}
        for i in range(0, len(batches), k):
            if k == 1:
                (v,) = exe.run(main, feed=batches[i], fetch_list=[loss.name])
                losses.append(float(np.asarray(v).reshape(-1)[0]))
            else:
                (v,) = exe.run(main, feed=batches[i:i + k], fetch_list=[loss.name],
                               steps_per_run=k)
                losses.extend(float(x) for x in np.asarray(v).reshape(k))
    return init, losses


@pytest.mark.parametrize("k", [2, 4, 8])
def test_multistep_equals_single_runs_bit_for_bit(k):
    """k steps a call == k single runs: the same losses and final
    parameters, bit for bit, and the fetches stacked [k, ...]."""
    batches = R.sq_batches(8)
    seq, seq_params, seq_h = _port_train(batches, 1, fetch_h=True)
    multi, multi_params, multi_h = _port_train(batches, k, fetch_h=True)
    assert multi == seq
    assert seq_params.keys() == multi_params.keys() and seq_params
    for n in seq_params:
        np.testing.assert_array_equal(multi_params[n], seq_params[n])
    for a, b in zip(multi_h, seq_h):
        np.testing.assert_array_equal(a, b)
    assert multi[-1] < multi[0]


@pytest.mark.parametrize("k", [2, 3])
def test_multistep_dropout_bit_for_bit(k):
    """A dropout program (random_seed pinned): each step of a call draws
    from the scope's generator as a single run does, so the trajectory and
    the parameters equal the single runs' bit for bit."""
    batches = R.sq_batches(6, seed=5)
    seq, seq_params = _port_train(batches, 1, dropout=0.5, seed=23)
    multi, multi_params = _port_train(batches, k, dropout=0.5, seed=23)
    assert multi == seq
    for n in seq_params:
        np.testing.assert_array_equal(multi_params[n], seq_params[n])


@pytest.mark.parametrize("k", [1, 4])
def test_multistep_matches_jax_multistep(k):
    """The port's k-step calls against the JAX package's (its lax.scan
    block at k = 4, its single runs at k = 1) from the same weights:
    losses within rtol 1e-5."""
    batches = R.sq_batches(8)
    init, jax_losses = _jax_train(batches, k)
    port, _ = _port_train(batches, max(k, 2), init=init)
    np.testing.assert_allclose(port, jax_losses, rtol=1e-5)


def test_multistep_stacked_dict_feed_and_single_entry_list():
    """A dict of arrays stacked on a leading k axis is taken as it is; a
    one-entry feed list runs unstacked, as a single run."""
    batches = R.sq_batches(4)
    stacked = {n: np.stack([b[n] for b in batches]) for n in batches[0]}
    main, startup, loss = R.build_sq_mlp(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope(seed=1, place=fluid.CPUPlace())
    exe.run(startup, scope=scope)
    (vals,) = exe.run(main, feed=stacked, fetch_list=[loss.name], steps_per_run=4,
                      scope=scope)
    assert vals.shape == (4, 1) and np.isfinite(vals).all()
    (v,) = exe.run(main, feed=[batches[0]], fetch_list=[loss.name], scope=scope)
    (w,) = exe.run(main, feed=batches[0], fetch_list=[loss.name], scope=scope)
    assert v.shape == w.shape == (1,)
    with pytest.raises(ValueError, match="steps_per_run"):
        exe.run(main, feed=batches[:3], fetch_list=[loss.name], steps_per_run=2, scope=scope)
    with pytest.raises(ValueError, match="leading axis"):
        exe.run(main, feed=stacked, fetch_list=[loss.name], steps_per_run=2, scope=scope)


def test_multistep_rejects_host_ops():
    """A block holding a host op cannot run k steps in one call."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        out = fluid.layers.fc(x, size=4)
    prog.global_block().append_op(type="delete_var", inputs={"X": [out]}, outputs={})
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope(seed=0, place=fluid.CPUPlace())
    exe.run(startup, scope=scope)
    with pytest.raises(RuntimeError, match="steps_per_run"):
        exe.run(prog, feed=[{"x": np.zeros((4, 8), "float32")}] * 2, fetch_list=[],
                steps_per_run=2, scope=scope)


def test_multistep_rejects_creating_persistables_and_bad_k():
    """A block that creates persistables (a startup program) and k < 1
    are refused, as in the JAX package."""
    main, startup, loss = R.build_sq_mlp(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope(seed=0, place=fluid.CPUPlace())
    with pytest.raises(RuntimeError, match="creates no new persistables"):
        exe.run(startup, feed={"x": np.zeros((2, 1), "float32")}, steps_per_run=2, scope=scope)
    exe.run(startup, scope=scope)
    with pytest.raises(ValueError, match="steps_per_run"):
        exe.run(main, feed=R.sq_batches(1)[0], fetch_list=[loss.name], steps_per_run=0,
                scope=scope)


def test_multistep_parallel_executor_dp2(tmp_path_factory):
    """steps_per_run=4 through the ParallelExecutor at dp 2: stacked [k, N,
    ...] feeds split on their batch dim, bit for bit the same PE's single
    runs, and the JAX single-device trajectory within the PE tests' bar."""
    batches = R.sq_batches(8, batch=16)
    init, jax_losses = _jax_train(batches, 1)
    res = R.spawn(2, "sc_multistep", {"init": init, "k": 4, "steps": 8, "seed": 3},
                  tmp_path_factory.mktemp("multistep_pe"))
    for r in res:
        assert r[4]["losses"] == r[1]["losses"] == res[0][4]["losses"]
        for n, v in r[1]["params"].items():
            np.testing.assert_array_equal(r[4]["params"][n], v)
    np.testing.assert_allclose(res[0][4]["losses"], jax_losses, rtol=1e-4, atol=1e-5)


def _reader(batches, names=("x", "y")):
    from paddle_tpu_torch.py_reader import PyReader

    r = PyReader(list(names), capacity=8, place=fluid.CPUPlace())
    r.decorate_tensor_provider(lambda: ({n: b[m] for n, m in zip(names, ("x", "y"))}
                                        for b in batches))
    return r


def _jax_reader_losses(batches, k, calls, seed=6):
    """(init, [stacked losses of each call]) of the JAX package's MLP fed
    by its PyReader, steps_per_run=k, `calls` calls."""
    from paddle_tpu.py_reader import PyReader as JPyReader

    main, startup, loss = R.build_sq_mlp(jfluid)
    reader = JPyReader(["x", "y"], capacity=8)
    reader.decorate_tensor_provider(lambda: iter(batches))
    main._py_readers = [reader]
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = JScope(seed=seed)
    with jscope_guard(scope):
        exe.run(startup)
        init = {n: np.asarray(scope.vars[n]).copy() for n in convert.persistable_names(main)}
        reader.start()
        out = [np.asarray(exe.run(main, fetch_list=[loss.name], steps_per_run=k)[0])
               for _ in range(calls)]
        reader.reset()
    return init, out


def _port_mlp(init):
    main, startup, loss = R.build_sq_mlp(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope(seed=6, place=fluid.CPUPlace())
    exe.run(startup, scope=scope)
    convert.load_into_scope(scope, init, sorted(init))
    return main, loss, exe, scope


@pytest.mark.parametrize("n,k,shapes", [(8, 4, [4, 4]), (6, 4, [4, 2]), (5, 4, [4, 1])])
def test_multistep_pyreader_pulls_k_batches(n, k, shapes):
    """feed=None with a started reader: each call pulls up to k staged
    batches and stacks them; an epoch's tail (2, or 1 batch) still comes
    back stacked [tail, ...], and the next call raises EOFException. The
    losses and parameters equal the same batches fed as stacked dicts bit
    for bit, and the JAX package's reader-fed calls within rtol 1e-5."""
    from paddle_tpu_torch.py_reader import EOFException

    batches = R.sq_batches(n, seed=9 + n)
    init, jax_calls = _jax_reader_losses(batches, k, len(shapes))
    assert [c.shape[0] for c in jax_calls] == shapes
    main, loss, exe, scope = _port_mlp(init)
    reader = _reader(batches)
    main._py_readers = [reader]
    reader.start()
    pulled = [exe.run(main, fetch_list=[loss.name], steps_per_run=k, scope=scope)[0]
              for _ in shapes]
    with pytest.raises(EOFException):
        exe.run(main, fetch_list=[loss.name], steps_per_run=k, scope=scope)
    assert [v.shape[0] for v in pulled] == shapes
    got_params = {m: scope.vars[m].numpy().copy() for m in scope.vars if m.startswith("fc_")}
    main2, loss2, exe2, scope2 = _port_mlp(init)
    fed, i = [], 0
    for m in shapes:
        if m == 1:  # a single run of the tail batch, its fetch stacked
            fed.append(exe2.run(main2, feed=batches[i], fetch_list=[loss2.name],
                                scope=scope2)[0][None])
        else:
            stacked = {name: np.stack([b[name] for b in batches[i:i + m]])
                       for name in batches[0]}
            fed.append(exe2.run(main2, feed=stacked, fetch_list=[loss2.name],
                                steps_per_run=m, scope=scope2)[0])
        i += m
    for a, b in zip(pulled, fed):
        np.testing.assert_array_equal(a, b)
    for m, v in got_params.items():
        np.testing.assert_array_equal(v, scope2.vars[m].numpy())
    np.testing.assert_allclose(np.concatenate(pulled).reshape(-1),
                               np.concatenate(jax_calls).reshape(-1), rtol=1e-5)


def test_multistep_pyreader_restart_clears_deferred_eof():
    """Epoch of 5 at k = 4: 4, the stacked 1-batch tail, EOFException; a
    reset and start() begin a fresh epoch instead of a stale EOF."""
    from paddle_tpu_torch.py_reader import EOFException

    main, loss, exe, scope = _port_mlp(_jax_reader_losses(R.sq_batches(1), 1, 0)[0])
    reader = _reader(R.sq_batches(5, seed=19))
    main._py_readers = [reader]
    reader.start()
    run = lambda: exe.run(main, fetch_list=[loss.name], steps_per_run=4, scope=scope)[0]  # noqa: E731
    assert run().shape[0] == 4
    assert run().shape[0] == 1
    with pytest.raises(EOFException):
        run()
    reader.reset()
    reader.start()
    assert run().shape[0] == 4
    reader.reset()


def test_multistep_graph_pyreader_restart_clears_deferred_eof():
    """The same through layers.py_reader + read_file (its start / reset
    delegate to the impl, where the deferred-EOF flag lives), against the
    JAX package's program on the same reader, within rtol 1e-5."""
    from paddle_tpu_torch.py_reader import EOFException

    batches = R.sq_batches(5, seed=29)
    losses = {}
    for name, fl in (("jax", jfluid), ("port", fluid)):
        main, startup = fl.Program(), fl.Program()
        with fl.unique_name.guard(), fl.program_guard(main, startup):
            reader = fl.layers.py_reader(capacity=8, shapes=[[-1, 8], [-1, 1]],
                                         dtypes=["float32", "float32"], use_double_buffer=False)
            x, y = fl.layers.read_file(reader)
            pred = fl.layers.fc(x, size=1)
            loss = fl.layers.mean(fl.layers.square(pred - y))
            fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
        slots = [v.name for v in reader.vars]
        reader.decorate_tensor_provider(
            lambda: iter({slots[0]: b["x"], slots[1]: b["y"]} for b in batches))
        if name == "jax":
            exe, scope = jfluid.Executor(jfluid.CPUPlace()), JScope(seed=3)
            guard, eof = jscope_guard(scope), __import__(
                "paddle_tpu.py_reader", fromlist=["EOFException"]).EOFException
        else:
            exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope(seed=3,
                                                                        place=fluid.CPUPlace())
            guard, eof = fluid.scope_guard(scope), EOFException
        with guard:
            exe.run(startup)
            if name == "jax":
                init = {n: np.asarray(scope.vars[n]).copy()
                        for n in convert.persistable_names(main)}
            else:
                convert.load_into_scope(scope, init, sorted(init))
            reader.start()
            v1 = exe.run(main, fetch_list=[loss.name], steps_per_run=4)[0]
            v2 = exe.run(main, fetch_list=[loss.name], steps_per_run=4)[0]
            assert v1.shape[0] == 4 and v2.shape[0] == 1
            with pytest.raises(eof):
                exe.run(main, fetch_list=[loss.name], steps_per_run=4)
            reader.reset()
            reader.start()
            v3 = exe.run(main, fetch_list=[loss.name], steps_per_run=4)[0]
            assert v3.shape[0] == 4
            reader.reset()
        losses[name] = np.concatenate([np.asarray(v).reshape(-1) for v in (v1, v2, v3)])
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-5)


def test_pulled_batches_reach_the_dict_feeds_block():
    """A pulled batch (tensors) keys the executor's cache as the same batch
    fed as numpy arrays: a dict feed after a pull, single-step and k-step,
    prepares no block of its own."""
    batches = R.sq_batches(10, seed=31)
    main, loss, exe, scope = _port_mlp(_jax_reader_losses(R.sq_batches(1), 1, 0)[0])
    reader = _reader(batches)
    main._py_readers = [reader]
    reader.start()
    exe.run(main, fetch_list=[loss.name], scope=scope)
    n = len(exe._cache)
    exe.run(main, feed=batches[1], fetch_list=[loss.name], scope=scope)
    assert len(exe._cache) == n
    exe.run(main, fetch_list=[loss.name], steps_per_run=4, scope=scope)
    n = len(exe._cache)
    stacked = {m: np.stack([b[m] for b in batches[6:10]]) for m in batches[0]}
    exe.run(main, feed=stacked, fetch_list=[loss.name], steps_per_run=4, scope=scope)
    assert len(exe._cache) == n
    reader.reset()


def test_multistep_parallel_executor_pyreader_dp2(tmp_path_factory):
    """The PE at dp 2 with a started reader and steps_per_run=4 over an
    epoch of 6: calls of 4 and 2, then EOFException; each rank stages only
    its rows; losses and parameters bit for bit the same PE fed the global
    batches as stacked dicts, and the JAX package's reader-fed
    single-device run within the PE tests' bar."""
    batches = R.sq_batches(6, seed=17, batch=16)
    init, jax_calls = _jax_reader_losses(batches, 4, 2)
    res = R.spawn(2, "sc_multistep_reader",
                  {"init": init, "k": 4, "steps": 6, "seed": 17, "batch": 16},
                  tmp_path_factory.mktemp("multistep_pe_reader"))
    for r in res:
        assert r["eof"] and r["staged_rows"] == (8, 8)
        assert r["reader"]["shapes"] == r["dict"]["shapes"] == [4, 2]
        assert r["reader"]["losses"] == r["dict"]["losses"] == res[0]["reader"]["losses"]
        for n, v in r["dict"]["params"].items():
            np.testing.assert_array_equal(r["reader"]["params"][n], v)
    np.testing.assert_allclose(res[0]["reader"]["losses"],
                               np.concatenate(jax_calls).reshape(-1), rtol=1e-4, atol=1e-5)


def test_parallel_executor_pull_whatever_the_reader_staged_dp2(tmp_path_factory):
    """The PE at dp 2, steps_per_run=4 over an epoch of 6: a reader started
    before the PE (staged whole, split by the pull) and a cache_epoch
    reader whose cached epoch was staged whole (staged again as the rank's
    rows) give the stacked-dict PE's losses and parameters bit for bit; an
    epoch ending on a batch of 15 rows raises ValueError at its pull,
    started before or after the PE, as that batch fed as a dict does."""
    res = R.spawn(2, "sc_reader_staging", {"init": None, "k": 4, "steps": 6, "seed": 23,
                                           "batch": 16},
                  tmp_path_factory.mktemp("pe_reader_staging"))
    for r in res:
        assert r["before"]["whole"] and not r["cached"]["whole"]
        assert r["before"]["sources"] == 1 and r["cached"]["sources"] == 2
        for form in ("before", "cached"):
            assert r[form]["losses"] == r["dict"]["losses"] == res[0]["dict"]["losses"]
            for n, v in r["dict"]["params"].items():
                np.testing.assert_array_equal(r[form]["params"][n], v)
        for key in ("dict_odd", "odd_before", "odd_after"):
            assert "batch dim 15 not divisible by device count 2" in r[key], (key, r.get(key))


def test_transformer_reader_build_pulls_as_the_stacked_dicts():
    """profile_training.build(reader=True) (the chip smoke's multi-step
    reader leg, at a small width, flash and training_fused): feed=None calls
    of steps_per_run=2 over the reader equal stacked-dict calls of the
    data-var build bit for bit, losses and every persistable, and an epoch
    of 5 runs 2, 2 and a stacked tail of 1 before EOFException."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.py_reader import EOFException
    from paddle_tpu_torch.tools import profile_training as prof

    cfg = dict(prof.BASE_FLASH, n_layer=1, n_head=2, d_model=32, d_inner=64, d_key=16,
               d_value=16, vocab=97, t=16, batch=2, dropout=0.1)
    batches = [prof.make_batch(cfg, 50 + i) for i in range(5)]
    flags.set_flags({"pass_pipeline": "training_fused"})
    try:
        runs = {}
        for form in ("dict", "reader"):
            main, startup, loss = prof.build(cfg, reader=form == "reader")
            exe = fluid.Executor(fluid.CPUPlace())
            scope = fluid.Scope(seed=0, place=fluid.CPUPlace())
            exe.run(startup, scope=scope)
            out = []
            if form == "reader":
                rd = main._py_readers[0]
                rd.decorate_tensor_provider(lambda: (prof.reader_feed(main, b) for b in batches))
                with fluid.scope_guard(scope):
                    rd.start()
                for _ in range(3):
                    out.append(exe.run(main, fetch_list=[loss.name], scope=scope,
                                       steps_per_run=2)[0])
                with pytest.raises(EOFException):
                    exe.run(main, fetch_list=[loss.name], scope=scope, steps_per_run=2)
            else:
                for i in (0, 2):
                    stacked = {n: np.stack([b[n] for b in batches[i:i + 2]]) for n in batches[0]}
                    out.append(exe.run(main, feed=stacked, fetch_list=[loss.name], scope=scope,
                                       steps_per_run=2)[0])
                out.append(exe.run(main, feed=batches[4], fetch_list=[loss.name],
                                   scope=scope)[0][None])
            runs[form] = (out, {n: t.clone() for n, t in scope.vars.items()})
    finally:
        flags.set_flags({"pass_pipeline": ""})
    assert [o.shape[0] for o in runs["reader"][0]] == [2, 2, 1]
    for a, b in zip(*(runs[f][0] for f in ("reader", "dict"))):
        np.testing.assert_array_equal(a, b)
    state, want = runs["reader"][1], runs["dict"][1]
    assert sorted(state) == sorted(want)
    for n in want:
        assert torch.equal(state[n], want[n]), n
