"""A Scope made without a place binds no device until an executor runs on it
(the reference's Scope(seed) has none): a bare Scope() runs a startup and a
main program under Executor(CPUPlace()) on a host without a card, and
trains as the JAX package's Scope() does from the same state; Scope(place=)
binds at once; a bound scope under an executor of another device raises."""

import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu_torch import convert


def _fc_adam(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[6], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        h = pkg.layers.fc(x, size=12, act="tanh")
        loss = pkg.layers.mean(pkg.layers.square(pkg.layers.fc(h, size=1) - y))
        pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return main, startup, loss


def _batch(step):
    rng = np.random.RandomState(step)
    x = rng.randn(8, 6).astype("float32")
    return {"x": x, "y": x[:, :1] * 2 - 1}


def test_bare_scope_runs_startup_and_main_on_the_cpu():
    """Scope() under scope_guard with Executor(CPUPlace()): the startup
    binds it to the CPU, and 4 Adam steps from the JAX package's startup
    state (carried by convert.load_into_scope) give the JAX package's
    losses at rtol 1e-5 (float32 sums in another order)."""
    import paddle_tpu.fluid as jfluid
    from paddle_tpu.executor import Scope as JScope
    from paddle_tpu.executor import scope_guard as jscope_guard

    jmain, jstartup, jloss = _fc_adam(jfluid)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    with jscope_guard(jscope):
        jexe.run(jstartup)
        init = {n: np.array(np.asarray(jscope.vars[n])) for n in convert.persistable_names(jmain)}
        want = [float(np.asarray(jexe.run(jmain, feed=_batch(s), fetch_list=[jloss.name])[0])
                      .reshape(-1)[0]) for s in range(4)]
    main, startup, loss = _fc_adam(pt)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    with pt.scope_guard(scope):
        exe.run(startup)
        assert scope.device.type == "cpu"
        convert.load_into_scope(scope, init, list(init))
        got = [float(np.asarray(exe.run(main, feed=_batch(s), fetch_list=[loss.name])[0])
                     .reshape(-1)[0]) for s in range(4)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


def test_scope_with_a_place_binds_at_once():
    """Scope(place=CPUPlace()) is on the CPU before any run, so an executor
    of another device refuses it at its first run."""
    scope = pt.Scope(place=pt.CPUPlace())
    assert scope.device.type == "cpu"
    main, startup, loss = _fc_adam(pt)
    with pytest.raises(ValueError, match="scope lives on cpu but the executor runs on meta"):
        pt.Executor("meta").run(startup, scope=scope)


def test_bound_bare_scope_refuses_another_device():
    """A bare scope bound by its first executor (the CPU) still raises under
    an executor of another device."""
    main, startup, loss = _fc_adam(pt)
    scope = pt.Scope(seed=1)
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    pt.Executor(pt.CPUPlace()).run(main, feed=_batch(0), fetch_list=[loss], scope=scope)
    with pytest.raises(ValueError, match="scope lives on cpu but the executor runs on meta"):
        pt.Executor("meta").run(main, feed=_batch(0), fetch_list=[loss], scope=scope)
