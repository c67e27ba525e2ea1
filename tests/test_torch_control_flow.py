"""The control-flow ops and layers of the torch port
(paddle_tpu_torch/ops/control_flow_ops.py, layers/control_flow.py) against
the JAX package, on the CPU: open-ended and bounded While, ConditionalBlock,
Switch, IfElse, StaticRNN, DynamicRNN, the tensor-array and rank-table
ops, each program built in both packages and run on the same feeds (and
the JAX package's startup state), mirroring tests/test_control_flow.py;
then the capture rule's decision: a block holding an open-ended while is
never captured and says why, a bounded one is (the card's side of it is in
tests/test_torch_rnn_cuda.py).

Tolerances: rtol 1e-5, atol 1e-6 (f32 in both, the loops' rounding in
another order); integer results exact.
"""

import numpy as np
import pytest

from torch_rnn_cases import assert_runs_close, run_both

RTOL, ATOL = 1e-5, 1e-6


def _same(program_fn, feed, steps=1, check_state=False):
    want, got, names, (jstate, pstate) = run_both(program_fn, feed, steps=steps)
    assert_runs_close(got, want, RTOL, ATOL)
    if check_state:
        for n in names:
            np.testing.assert_allclose(pstate[n], jstate[n], rtol=RTOL, atol=ATOL, err_msg=n)
    return got[0]


def _counting_while(fluid, max_iters=None):
    L = fluid.layers
    i = L.fill_constant(shape=[1], dtype="int64", value=0)
    n = L.fill_constant(shape=[1], dtype="int64", value=10)
    acc = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    cond = L.less_than(i, n)
    w = L.While(cond, maximum_iterations=max_iters)
    with w.block():
        acc2 = L.elementwise_add(acc, L.fill_constant([1], "float32", 2.0))
        L.assign(acc2, acc)
        L.increment(i, value=1, in_place=True)
        L.less_than(i, n, cond=cond)
    return [acc, i]


@pytest.mark.parametrize("max_iters", [None, 12])
def test_while_counts_and_accumulates(max_iters):
    acc_v, i_v = _same(lambda fluid: _counting_while(fluid, max_iters), {})
    assert i_v[0] == 10
    np.testing.assert_allclose(acc_v, [20.0], rtol=1e-6)


def test_while_bounded_is_differentiable():
    def program_fn(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[4], dtype="float32")
        w_param = L.create_parameter([4, 4], "float32", name="W")
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        n = L.fill_constant(shape=[1], dtype="int64", value=3)
        h = L.elementwise_mul(x, L.fill_constant([1], "float32", 1.0))
        cond = L.less_than(i, n)
        w = L.While(cond, maximum_iterations=8)
        with w.block():
            h2 = L.tanh(L.matmul(h, w_param))
            L.assign(h2, h)
            L.increment(i, value=1, in_place=True)
            L.less_than(i, n, cond=cond)
        loss = L.mean(h)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return [loss, h]

    xv = np.random.RandomState(0).randn(2, 4).astype("float32")
    loss_v = _same(program_fn, {"x": xv}, steps=2, check_state=True)[0]
    assert np.isfinite(loss_v).all()


def test_conditional_block_and_switch():
    def program_fn(fluid):
        L = fluid.layers
        step = L.fill_constant(shape=[1], dtype="int64", value=7)
        lr = L.fill_constant(shape=[1], dtype="float32", value=0.0)
        b1 = L.fill_constant(shape=[1], dtype="int64", value=5)
        b2 = L.fill_constant(shape=[1], dtype="int64", value=10)
        sw = L.Switch()
        with sw.case(L.less_than(step, b1)):
            L.assign(L.fill_constant([1], "float32", 1.0), lr)
        with sw.case(L.less_than(step, b2)):
            L.assign(L.fill_constant([1], "float32", 0.1), lr)
        with sw.default():
            L.assign(L.fill_constant([1], "float32", 0.01), lr)
        return [lr]

    (lr_v,) = _same(program_fn, {})
    np.testing.assert_allclose(lr_v, [0.1], rtol=1e-6)


@pytest.mark.parametrize("step", [3, 12])
def test_switch_over_a_fed_step(step):
    """The same Switch over a fed step: the first case and the default."""

    def program_fn(fluid):
        L = fluid.layers
        s = L.data(name="s", shape=[1], dtype="int64", append_batch_size=False)
        lr = L.fill_constant(shape=[1], dtype="float32", value=0.0)
        sw = L.Switch()
        with sw.case(L.less_than(s, L.fill_constant([1], "int64", 5))):
            L.assign(L.fill_constant([1], "float32", 1.0), lr)
        with sw.case(L.less_than(s, L.fill_constant([1], "int64", 10))):
            L.assign(L.fill_constant([1], "float32", 0.1), lr)
        with sw.default():
            L.assign(L.fill_constant([1], "float32", 0.01), lr)
        return [lr]

    (lr_v,) = _same(program_fn, {"s": np.array([step], np.int64)})
    np.testing.assert_allclose(lr_v, [1.0 if step < 5 else 0.01], rtol=1e-6)


def test_ifelse_batch_select():
    def program_fn(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[1], dtype="float32")
        cond = L.greater_than(x, L.fill_constant([1], "float32", 0.0))
        ie = L.IfElse(cond)
        with ie.true_block():
            xt = ie.input(x)
            ie.output(L.elementwise_mul(xt, xt))
        with ie.false_block():
            xf = ie.input(x)
            ie.output(L.scale(xf, scale=-1.0))
        return [ie()]

    xv = np.array([[-2.0], [3.0], [0.5], [-1.0]], np.float32)
    (out_v,) = _same(program_fn, {"x": xv})
    np.testing.assert_allclose(out_v, [[2.0], [9.0], [0.25], [1.0]], rtol=1e-6)


def test_static_rnn_matches_numpy():
    T, B, D, H = 5, 3, 4, 4
    xv = np.random.RandomState(1).randn(T, B, D).astype("float32")

    def program_fn(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[T, B, D], dtype="float32", append_batch_size=False)
        rnn = L.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            h = rnn.memory(shape=[H], batch_ref=x, init_value=0.0)
            nh = L.tanh(L.elementwise_add(xt, h))
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        return [rnn()]

    (out_v,) = _same(program_fn, {"x": xv})
    h = np.zeros((B, H), np.float32)
    expect = []
    for t in range(T):
        h = np.tanh(xv[t] + h)
        expect.append(h)
    np.testing.assert_allclose(out_v, np.stack(expect), rtol=RTOL, atol=ATOL)


def test_static_rnn_trains():
    """A parameter inside the step, 2 SGD steps: the generic grad of
    `recurrent` (time-major) in both packages."""
    T, B, D, H = 5, 3, 4, 4
    xv = np.random.RandomState(1).randn(T, B, D).astype("float32")

    def program_fn(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[T, B, D], dtype="float32", append_batch_size=False)
        w = L.create_parameter([D, H], "float32", name="rnn_w")
        rnn = L.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            h = rnn.memory(shape=[H], batch_ref=x, init_value=0.0)
            nh = L.tanh(L.elementwise_add(L.matmul(xt, w), h))
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        out = rnn()
        loss = L.mean(out)
        fluid.optimizer.SGD(0.2).minimize(loss)
        return [out, loss]

    _same(program_fn, {"x": xv}, steps=2, check_state=True)


def test_dynamic_rnn_masks_finished_rows():
    B, T, D = 3, 6, 4
    xv = np.random.RandomState(2).randn(B, T, D).astype("float32")
    lens = np.array([6, 3, 1], np.int64)

    def program_fn(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[B, T, D], dtype="float32", append_batch_size=False)
        sl = L.data(name="sl", shape=[B], dtype="int64", append_batch_size=False)
        drnn = L.DynamicRNN()
        with drnn.block():
            xt = drnn.step_input(x, seq_len=sl)
            h = drnn.memory(shape=[D], value=0.0)
            nh = L.tanh(L.elementwise_add(xt, h))
            drnn.update_memory(h, nh)
            drnn.output(nh)
        out = drnn()
        return [out, L.sequence_pool(out, "last")]

    out_v, last_v = _same(program_fn, {"x": xv, "sl": lens})
    h = np.zeros((B, D), np.float32)
    outs = np.zeros((B, T, D), np.float32)
    for t in range(T):
        nh = np.tanh(xv[:, t] + h)
        active = (t < lens)[:, None]
        h = np.where(active, nh, h)
        outs[:, t] = np.where(active, nh, 0.0)
    np.testing.assert_allclose(out_v, outs, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(last_v, h, rtol=RTOL, atol=ATOL)
    assert np.all(out_v[1, 3:] == 0) and np.all(out_v[2, 1:] == 0)


def test_dynamic_rnn_trains_through_the_recurrent_grad():
    """A DynamicRNN with a parameter inside its step, trained 2 SGD steps:
    the generic grad of `recurrent` through the loop, in both packages."""
    B, T, D = 3, 5, 4
    rng = np.random.RandomState(3)
    feed = {"x": rng.randn(B, T, D).astype("float32"), "sl": np.array([5, 2, 1], np.int64)}

    def program_fn(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[B, T, D], dtype="float32", append_batch_size=False)
        sl = L.data(name="sl", shape=[B], dtype="int64", append_batch_size=False)
        boot = L.fc(L.reduce_mean(x, dim=[1]), size=D, act="tanh")
        drnn = L.DynamicRNN()
        with drnn.block():
            xt = drnn.step_input(x, seq_len=sl)
            h = drnn.memory(init=boot)
            nh = L.fc([xt, h], size=D, act="tanh")
            drnn.update_memory(h, nh)
            drnn.output(nh)
        out = drnn()
        loss = L.mean(L.sequence_pool(out, "sum"))
        fluid.optimizer.SGD(0.3).minimize(loss)
        return [loss, out]

    _same(program_fn, feed, steps=2, check_state=True)


def test_array_write_read_roundtrip():
    def program_fn(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[2, 3], dtype="float32", append_batch_size=False)
        i0 = L.fill_constant([1], "int64", 0)
        i1 = L.fill_constant([1], "int64", 1)
        arr = L.array_write(x, i0)
        L.array_write(L.scale(x, scale=2.0), i1, array=arr)
        return [L.array_length(arr), L.array_read(arr, i0), L.array_read(arr, i1)]

    xv = np.arange(6, dtype=np.float32).reshape(2, 3)
    n_v, r0_v, r1_v = _same(program_fn, {"x": xv})
    assert n_v[0] == 2
    np.testing.assert_allclose(r0_v, xv)
    np.testing.assert_allclose(r1_v, 2 * xv)


def test_array_write_out_of_order():
    def program_fn(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[2], dtype="float32", append_batch_size=False)
        i2 = L.fill_constant([1], "int64", 2)
        i0 = L.fill_constant([1], "int64", 0)
        arr = L.array_write(x, i2)
        L.array_write(L.scale(x, scale=3.0), i0, array=arr)
        return [L.array_length(arr), L.array_read(arr, i0), L.array_read(arr, i2)]

    xv = np.array([5.0, 5.0], np.float32)
    n_v, r0_v, r2_v = _same(program_fn, {"x": xv})
    assert n_v[0] == 3
    np.testing.assert_allclose(r0_v, 3 * xv)
    np.testing.assert_allclose(r2_v, xv)


def test_lod_tensor_array_conversions():
    def program_fn(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[2, 4, 3], dtype="float32", append_batch_size=False)
        arr = L.lod_tensor_to_array(x)
        step1 = L.array_read(arr, L.fill_constant([1], "int64", 1))
        return [step1, L.array_to_lod_tensor(arr), L.array_length(arr)]

    xv = np.random.RandomState(3).randn(2, 4, 3).astype("float32")
    s1, back_v, n_v = _same(program_fn, {"x": xv})
    np.testing.assert_allclose(s1, xv[:, 1])
    np.testing.assert_allclose(back_v, xv)
    assert n_v[0] == 4


def _array_loop(fluid, max_iters, t_cap, n_live):
    L = fluid.layers
    arr = L.create_array("float32", shape=[t_cap, 2])
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", n_live)
    val = L.fill_constant([2], "float32", 1.0)
    cond = L.less_than(i, n)
    w = L.While(cond, maximum_iterations=max_iters)
    with w.block():
        v2 = L.scale(val, scale=2.0)
        L.assign(v2, val)
        L.array_write(v2, i, array=arr)
        L.increment(i, value=1, in_place=True)
        L.less_than(i, n, cond=cond)
    return [L.array_to_lod_tensor(arr), L.array_length(arr)]


def test_while_with_preallocated_array():
    r_v, n_v = _same(lambda fluid: _array_loop(fluid, None, 4, 4), {})
    np.testing.assert_allclose(r_v.T, [[2, 2], [4, 4], [8, 8], [16, 16]])
    assert n_v[0] == 4


def test_while_bounded_with_array_carry():
    r_v, n_v = _same(lambda fluid: _array_loop(fluid, 6, 6, 4), {})
    np.testing.assert_allclose(r_v.T, [[2, 2], [4, 4], [8, 8], [16, 16], [0, 0], [0, 0]])
    assert n_v[0] == 4


def test_rank_table_and_reorder():
    def program_fn(fluid):
        L = fluid.layers
        sl = L.data(name="sl", shape=[4], dtype="int64", append_batch_size=False)
        x = L.data(name="x", shape=[4, 2], dtype="float32", append_batch_size=False)
        table = L.lod_rank_table(sl)
        mx = L.max_sequence_len(seq_len=sl)
        mx2 = L.max_sequence_len(table)
        xr = L.reorder_lod_tensor_by_rank(x, table)
        return [mx, mx2, xr, table, L.shrink_memory(x, None, table)]

    lens = np.array([2, 5, 1, 5], np.int64)  # a tie keeps row order
    xv = np.arange(8, dtype=np.float32).reshape(4, 2)
    mx_v, mx2_v, xr_v, table_v, shrunk = _same(program_fn, {"sl": lens, "x": xv})
    assert mx_v[0] == 5 and mx2_v[0] == 5
    assert table_v.tolist() == [1, 3, 0, 2]
    np.testing.assert_allclose(xr_v, xv[[1, 3, 0, 2]])
    np.testing.assert_allclose(shrunk, xv)


@pytest.mark.parametrize("flag", [True, False])
def test_conditional_block_writes_array(flag):
    def program_fn(fluid):
        L = fluid.layers
        f = L.data(name="flag", shape=[1], dtype="bool", append_batch_size=False)
        arr = L.create_array("float32", shape=[2, 3])
        i0 = L.fill_constant([1], "int64", 0)
        v = L.fill_constant([3], "float32", 7.0)
        L.array_write(L.fill_constant([3], "float32", 1.0), i0, array=arr)
        cb = L.ConditionalBlock([f])
        with cb.block():
            L.array_write(v, i0, array=arr)
        return [L.array_read(arr, i0)]

    (out,) = _same(program_fn, {"flag": np.array([flag])})
    np.testing.assert_allclose(out, [7.0] * 3 if flag else [1.0] * 3)


def test_untaken_branch_with_an_out_of_range_index_does_not_fault():
    """The branch always runs (no host read): an array index that is out of
    range only when the predicate is false is clamped, its value dropped."""

    def program_fn(fluid):
        L = fluid.layers
        f = L.data(name="flag", shape=[1], dtype="bool", append_batch_size=False)
        idx = L.data(name="idx", shape=[1], dtype="int64", append_batch_size=False)
        arr = L.create_array("float32", shape=[2, 3])
        L.array_write(L.fill_constant([3], "float32", 1.0), L.fill_constant([1], "int64", 0),
                      array=arr)
        out = L.fill_constant([3], "float32", -1.0)
        cb = L.ConditionalBlock([f])
        with cb.block():
            L.assign(L.array_read(arr, idx), out)
        return [out]

    (out,) = _same(program_fn, {"flag": np.array([False]), "idx": np.array([9], np.int64)})
    np.testing.assert_allclose(out, [-1.0] * 3)


@pytest.mark.parametrize("op", ["less_than", "less_equal", "greater_than", "greater_equal",
                                "equal", "not_equal"])
def test_comparisons(op):
    rng = np.random.RandomState(4)
    x = rng.randint(0, 3, (3, 4)).astype(np.float32)
    y = rng.randint(0, 3, (3, 4)).astype(np.float32)

    def program_fn(fluid):
        L = fluid.layers
        xv = L.data(name="x", shape=[3, 4], dtype="float32", append_batch_size=False)
        yv = L.data(name="y", shape=[3, 4], dtype="float32", append_batch_size=False)
        return [getattr(L, op)(xv, yv)]

    _same(program_fn, {"x": x, "y": y})


@pytest.mark.parametrize("op", ["logical_and", "logical_or", "logical_xor", "logical_not"])
def test_logical_ops(op):
    rng = np.random.RandomState(5)
    a, b = rng.rand(6) > 0.5, rng.rand(6) > 0.5

    def program_fn(fluid):
        L = fluid.layers
        av = L.data(name="a", shape=[6], dtype="bool", append_batch_size=False)
        bv = L.data(name="b", shape=[6], dtype="bool", append_batch_size=False)
        return [L.logical_not(av) if op == "logical_not" else getattr(L, op)(av, bv)]

    _same(program_fn, {"a": a, "b": b})


def test_block_exception_rolls_back():
    import paddle_tpu_torch.fluid as fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        i = fluid.layers.fill_constant([1], "int64", 0)
        n = fluid.layers.fill_constant([1], "int64", 3)
        w = fluid.layers.While(fluid.layers.less_than(i, n))
        with pytest.raises(RuntimeError):
            with w.block():
                raise RuntimeError("boom")
        assert main.current_block_idx == 0


def test_seeded_random_op_in_a_loop_repeats_its_draw():
    """A random op with a pinned seed inside a loop draws the same numbers
    every iteration (its generator restarts from the seed, as the JAX
    package's key(seed)); an unseeded one draws afresh each iteration."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.fluid as fluid

    for seed, same in ((7, True), (0, False)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            L = fluid.layers
            arr = L.create_array("float32", shape=[3, 4])
            i = L.fill_constant([1], "int64", 0)
            n = L.fill_constant([1], "int64", 3)
            cond = L.less_than(i, n)
            w = L.While(cond, maximum_iterations=3)
            with w.block():
                r = L.uniform_random([4], seed=seed)
                L.array_write(r, i, array=arr)
                L.increment(i, value=1, in_place=True)
                L.less_than(i, n, cond=cond)
            out = L.array_to_lod_tensor(arr)
        scope = pt.Scope(seed=0, place=pt.CPUPlace())
        with pt.scope_guard(scope):
            exe = pt.Executor(pt.CPUPlace())
            exe.run(startup)
            (v,) = exe.run(main, fetch_list=[out.name])
        rows = v.T  # (3, 4)
        assert np.array_equal(rows[0], rows[1]) == same and np.array_equal(rows[1], rows[2]) == same


# ---------------------------------------------------------------------------
# the capture rule
# ---------------------------------------------------------------------------


def _prepared(program_fn):
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.executor import _PerOpProfiledBlock

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        fetch = program_fn(fluid)
    fresh = pt.Scope(seed=0, place=pt.CPUPlace())
    start = _PerOpProfiledBlock(startup.global_block(), [], [], fresh)
    scope = pt.Scope(seed=0, place=pt.CPUPlace())
    with pt.scope_guard(scope):
        pt.Executor(pt.CPUPlace()).run(startup)
    block = _PerOpProfiledBlock(main.global_block(), [], [v.name for v in fetch], scope)
    return block, start


@pytest.mark.parametrize("max_iters,reason", [(None, "open_ended_while"), (12, None)])
def test_capture_rule_names_the_open_ended_while(max_iters, reason):
    """The executor's decision, on the CPU: a block holding an open-ended
    while would run op by op for "open_ended_while"; a bounded one would
    be captured; a startup program for "creates_persistables"."""
    def program_fn(fluid):
        acc, i = _counting_while(fluid, max_iters)
        fluid.layers.create_parameter([2], "float32", name="p")
        return [acc, i]

    block, start = _prepared(program_fn)
    assert block.capture_declined == reason
    assert start.capture_declined == "creates_persistables"


def test_capture_rule_sees_a_while_nested_in_a_sub_block():
    def program_fn(fluid):
        L = fluid.layers
        f = L.fill_constant([1], "bool", True)
        acc = L.fill_constant([1], "float32", 0.0)
        cb = L.ConditionalBlock([f])
        with cb.block():
            i = L.fill_constant([1], "int64", 0)
            n = L.fill_constant([1], "int64", 2)
            cond = L.less_than(i, n)
            w = L.While(cond)
            with w.block():
                L.assign(L.scale(acc, scale=1.0, bias=1.0), acc)
                L.increment(i, value=1, in_place=True)
                L.less_than(i, n, cond=cond)
        return [acc]

    block, _ = _prepared(program_fn)
    assert block.capture_declined == "open_ended_while"
