"""The executor slice of the torch port (paddle_tpu_torch executor.py,
flags.py, profiler.py) against the JAX package, on the CPU.

- The canonical fluid script, `exe = Executor(CPUPlace());
  exe.run(default_startup_program())` with no scope_guard, runs in both
  packages: the process scope takes the first executor's device. The
  JAX startup's weights are carried into the port by name
  (convert.load_into_scope), and 3 Adam steps of a small fc program give
  the same losses within rtol 1e-5 (f32 on both sides, sums in another
  order over a few products).
- Without a card, an executor or scope on the card still raises, and a
  scope bound to one device refuses another device's executor.
- FLAGS_profile_ops reads the same through get_flags / set_flags in both
  packages, with the same default.
- The ported host profiler holds the cases of tests/test_profiler.py
  (nesting names, no-op when off, a stop in mid event, the sort keys).
- Under profiler() with FLAGS_profile_ops the op-by-op block, with an event
  per op, gives the same fetches as the normal run, bit for bit.
- Random ops in a main program draw on the run's device from the scope's
  device generator (the form a CUDA graph replays), fresh every step, and
  the same every step where the op pins a seed; the host generator, which
  a startup program draws from, is left alone.
"""

import contextlib
import io
import threading
import time

import numpy as np
import pytest
import torch

import jax

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch as pt
from paddle_tpu import flags as jflags
from paddle_tpu_torch import convert, profiler
from paddle_tpu_torch import executor as pt_executor
from paddle_tpu_torch import flags as pt_flags

jax.config.update("jax_platforms", "cpu")

STEPS = 3
LOSS_RTOL = 1e-5


def _fc_adam(pkg):
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


def _batch(step):
    rng = np.random.RandomState(100 + step)
    return {"x": rng.randn(4, 16).astype("float32"), "y": rng.randn(4, 1).astype("float32")}


def _script(pkg, steps, init=None):
    """The fluid script with no scope_guard: a CPU executor, the default
    startup program, then `steps` runs of the default main program over the
    process scope; `init` overwrites the startup's state by name first.
    Returns (losses, the startup's state)."""
    main, startup, loss = _fc_adam(pkg)
    names = convert.persistable_names(main)
    with pkg.program_guard(main, startup):
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(pkg.default_startup_program())
        scope = pkg.global_scope()
        if init is not None:
            convert.load_into_scope(scope, init, names)
        state = {n: np.array(np.asarray(scope.vars[n])) for n in names}
        losses = [
            np.asarray(exe.run(pkg.default_main_program(), feed=_batch(s),
                               fetch_list=[loss])[0]).reshape(-1)[0]
            for s in range(steps)
        ]
    return np.asarray(losses), state


@pytest.fixture
def fresh_process_scope(monkeypatch):
    """The port's process scope as a new process has it: not made yet."""
    monkeypatch.setattr(pt_executor, "_global_scope", None)


def test_default_scope_script_runs_in_both_packages(fresh_process_scope):
    want, init = _script(jfluid, STEPS)
    got, _ = _script(pt, STEPS, init=init)
    assert pt.global_scope().device == torch.device("cpu")
    assert np.all(np.isfinite(got)) and got[0] != got[-1]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a box without CUDA")


def test_card_entry_points_still_raise_without_a_card(no_cuda, fresh_process_scope):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.Executor(pt.CUDAPlace(0))
    # a scope made without a place, and the unbound process scope, asked
    # for their device before any executor ran on them take the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.Scope().device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.global_scope().device


def test_bound_scope_refuses_another_device(fresh_process_scope):
    main, startup, loss = _fc_adam(pt)
    pt.Executor(pt.CPUPlace()).run(startup)
    with pytest.raises(ValueError, match="scope lives on cpu but the executor runs on meta"):
        pt.Executor("meta").run(main, feed=_batch(0), fetch_list=[loss])
    scope = pt.Scope(place=pt.CPUPlace())  # an explicit place keeps its device
    with pytest.raises(ValueError, match="scope lives on cpu"):
        pt.Executor("meta").run(startup, scope=scope)


def test_profile_ops_flag_matches_jax_package():
    name = "profile_ops"
    assert pt_flags.get_flags(name) == jflags.get_flags(name) == {name: False}
    try:
        for value in (True, "1", "false", "on", 0):
            pt_flags.set_flags({"FLAGS_" + name: value})
            jflags.set_flags({"FLAGS_" + name: value})
            assert pt_flags.get_flags([name]) == jflags.get_flags([name])
    finally:
        pt_flags.set_flags({name: False})
        jflags.set_flags({name: False})


# ---- the host profiler: the cases of tests/test_profiler.py -------------


@pytest.fixture
def clean_profiler():
    profiler.reset_profiler()
    yield
    if profiler.is_profiling():
        _silent_stop()
    profiler.reset_profiler()


def _silent_stop(sorted_key=None):
    with contextlib.redirect_stdout(io.StringIO()):
        return profiler.stop_profiler(sorted_key, None)


def test_record_event_nesting_names(clean_profiler):
    profiler.start_profiler("All")
    with profiler.RecordEvent("outer"):
        with profiler.RecordEvent("inner"):
            pass
        with profiler.RecordEvent("inner"):
            pass
    table = _silent_stop()
    assert table["outer/inner"][0] == 2 and table["outer"][0] == 1
    assert "inner" not in table


def test_record_event_noop_when_off(clean_profiler):
    with profiler.RecordEvent("ignored"):
        pass
    assert not profiler._events


def test_stop_mid_event_does_not_leak_stack_prefix(clean_profiler):
    entered, stop_done = threading.Event(), threading.Event()

    def worker():
        with profiler.RecordEvent("outer"):
            entered.set()
            assert stop_done.wait(5)
        with profiler.RecordEvent("solo"):
            pass

    profiler.start_profiler("All")
    t = threading.Thread(target=worker)
    t.start()
    assert entered.wait(5)
    _silent_stop()
    profiler.start_profiler("All")
    stop_done.set()
    t.join(5)
    assert not t.is_alive()
    table = _silent_stop()
    assert "solo" in table
    assert not any(name.startswith("outer/") for name in table)


@pytest.mark.parametrize(
    "sorted_key,expected_first",
    [("total", "beta"), ("calls", "beta"), ("max", "gamma"), ("min", "alpha"), ("ave", "alpha")],
)
def test_stop_profiler_sort_keys(clean_profiler, capsys, sorted_key, expected_first):
    profiler.start_profiler("All")
    now = time.perf_counter()
    for name, durs in (("alpha", [0.050]), ("beta", [0.010] * 10), ("gamma", [0.001, 0.080])):
        for d in durs:
            profiler._events.append((name, now, now + d, 0))
    profiler.stop_profiler(sorted_key, None)
    rows = [line.split()[0] for line in capsys.readouterr().out.splitlines()
            if line and line.split()[0] in ("alpha", "beta", "gamma")]
    assert rows[0] == expected_first


# ---- the op-by-op block -------------------------------------------------


def _steps(per_op, steps=STEPS):
    main, startup, loss = _fc_adam(pt)
    scope, exe = pt.Scope(seed=3, place=pt.CPUPlace()), pt.Executor(pt.CPUPlace())
    fetches = [loss.name, "fc_0.w_0"]
    with pt.scope_guard(scope):
        exe.run(startup)
        if not per_op:
            return [exe.run(main, feed=_batch(s), fetch_list=fetches) for s in range(steps)], None
        pt_flags.set_flags({"profile_ops": True})
        try:
            profiler.start_profiler("All")
            out = [exe.run(main, feed=_batch(s), fetch_list=fetches) for s in range(steps)]
        finally:
            pt_flags.set_flags({"profile_ops": False})
            table = _silent_stop()
    return out, table


def test_op_by_op_block_under_profile_ops_matches_normal_run(clean_profiler):
    want, _ = _steps(per_op=False)
    got, table = _steps(per_op=True)
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert table["run/block0"][0] == STEPS
    per_op = [n for n in table if n.startswith("run/block0/op/")]
    assert any(n.startswith("run/block0/op/adam:") for n in per_op)
    assert any(n.startswith("run/block0/op/mul:") for n in per_op)
    assert all(table[n][0] == STEPS for n in per_op)


def test_feed_shapes_key_the_block_cache():
    main, startup, loss = _fc_adam(pt)
    scope, exe = pt.Scope(seed=3, place=pt.CPUPlace()), pt.Executor(pt.CPUPlace())
    with pt.scope_guard(scope):
        exe.run(startup)
        for rows in (4, 8, 4):
            feed = {"x": np.ones((rows, 16), "float32"), "y": np.ones((rows, 1), "float32")}
            assert np.isfinite(exe.run(main, feed=feed, fetch_list=[loss])[0]).all()
    assert len(exe._cache) == 3  # the startup block and one block a feed shape


def _noise_program():
    """(main, [x + gaussian noise, uniform noise with a pinned seed]): a
    main program that draws random numbers every run."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[4, 8], dtype="float32", append_batch_size=False)
        noise = pt.layers.gaussian_random([4, 8], mean=1.0, std=2.0)
        pinned = pt.layers.uniform_random([4, 8], min=-1.0, max=1.0, seed=7)
        out = pt.layers.elementwise_add(x, noise)
    return main, [out, pinned]


@pytest.mark.parametrize("use_program_cache", [True, False])
def test_main_program_random_ops_draw_from_the_device_generator(use_program_cache):
    """Outside a startup program the random ops draw on the run's device
    from the scope's device generator (the form a CUDA graph replays): fresh
    values every step, the same sequence from the same seed, and the same
    values every step where the op pins a seed."""
    main, outs = _noise_program()
    x = np.zeros((4, 8), "float32")
    runs = []
    for _ in range(2):
        scope, exe = pt.Scope(seed=5, place=pt.CPUPlace()), pt.Executor(pt.CPUPlace())
        with pt.scope_guard(scope):
            runs.append([exe.run(main, feed={"x": x}, fetch_list=outs,
                                 use_program_cache=use_program_cache) for _ in range(3)])
        # the host generator, a startup program's, drew nothing
        assert torch.equal(scope.generator.get_state(),
                           torch.Generator().manual_seed(5).get_state())
    first, again = runs
    for a, b in zip(first, again):
        assert all(np.array_equal(u, v) for u, v in zip(a, b))
    noise = [step[0] for step in first]
    pinned = [step[1] for step in first]
    want = torch.empty(4, 8).normal_(1.0, 2.0, generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(noise[0], want.numpy())
    assert not np.array_equal(noise[0], noise[1]) and not np.array_equal(noise[1], noise[2])
    assert all(np.array_equal(p, pinned[0]) for p in pinned)
    assert pinned[0].min() >= -1.0 and pinned[0].max() <= 1.0
    assert not np.array_equal(pinned[0], noise[0])
