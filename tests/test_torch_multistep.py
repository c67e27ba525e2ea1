"""steps_per_run > 1 (executor._MultiStepBlock) on the CPU: k steps in one
call equal k single runs of the port bit for bit, dropout included, and
the JAX package's multi-step block (a lax.scan over the stacked feeds)
loss for loss within rtol 1e-5; the stacked-dict and feed-list forms, the
stacked fetches, and the refusals of tests/test_multistep.py (host ops, a
block that creates persistables, k < 1); the ParallelExecutor's k steps
at dp 2 (gloo, spawned ranks) against the JAX single-device run.

The py_reader forms of tests/test_multistep.py wait for py_reader.py."""

import numpy as np
import pytest

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
