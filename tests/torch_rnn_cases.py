"""Shared helpers of the sequence, control-flow, loss and recurrent-model
parity tests of the torch port (tests/test_torch_sequence.py,
test_torch_control_flow.py, test_torch_loss.py, test_torch_rnn_models.py):

- `lower_both` runs one op's lowering (and its generic vjp grad) in both
  packages on the same seed-made numpy inputs;
- `run_both` builds the same Program in both packages with a program_fn that
  takes the package's fluid module, runs its startup program in the JAX
  package, carries that scope into the port by name
  (convert.load_into_scope) and runs the main program N steps in both.
"""

import importlib

import numpy as np
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu.ops import registry as jreg

import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.ops import registry as preg

jax.config.update("jax_platforms", "cpu")

PACKAGES = ("paddle_tpu", "paddle_tpu_torch")


def _jax_in(v):
    if v is None:
        return None
    if isinstance(v, tuple):
        return tuple(_jax_in(x) for x in v)
    return jnp.asarray(v)


def _port_in(v):
    if v is None:
        return None
    if isinstance(v, tuple):
        return tuple(_port_in(x) for x in v)
    return torch.from_numpy(np.ascontiguousarray(v))


def _np(v):
    if v is None:
        return None
    if isinstance(v, tuple):
        return tuple(_np(x) for x in v)
    if isinstance(v, torch.Tensor):
        return v.detach().numpy()
    return np.asarray(v)


def lower_one(package, op_type, ins, attrs):
    """{slot: [numpy]} of one lowering of `op_type` in `package` over numpy
    `ins` ({slot: [array or None or (buffer, size)]})."""
    if package == "paddle_tpu":
        ctx = jreg.LowerCtx(jax.random.key(0))
        outs = jreg.get(op_type).lower(
            ctx, {s: [_jax_in(v) for v in vs] for s, vs in ins.items()}, dict(attrs))
    else:
        ctx = preg.LowerCtx("cpu", generator=torch.Generator().manual_seed(0),
                            device_generator=torch.Generator().manual_seed(0),
                            host_random=False)
        outs = preg.get(op_type).lower(
            ctx, {s: [_port_in(v) for v in vs] for s, vs in ins.items()}, dict(attrs))
    return {s: [_np(v) for v in vs] for s, vs in outs.items()}


def grad_one(package, op_type, ins, attrs, cots):
    """{"<slot>@GRAD": [numpy]} of the generic grad `<op_type>_grad` over
    the forward inputs and the cotangents `cots` ({out slot: [array]})."""
    meta = {jreg.FWD_IN_SLOTS_ATTR: list(ins), jreg.FWD_OUT_SLOTS_ATTR: list(cots)}
    gins = dict(ins)
    gins.update({s + "@GRAD": vs for s, vs in cots.items()})
    return lower_one(package, op_type + "_grad", gins, dict(attrs, **meta))


def lower_both(op_type, ins, attrs):
    return [lower_one(p, op_type, ins, attrs) for p in PACKAGES]


def assert_outs_close(got, want, tol, what=""):
    """Every output slot: floats within rtol = atol = tol, the rest exact."""
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for slot in want:
        for i, (g, w) in enumerate(zip(got[slot], want[slot])):
            msg = "%s %s[%d]" % (what, slot, i)
            if w is None:
                assert g is None, msg
                continue
            if isinstance(w, tuple):
                assert_outs_close({"v": list(g)}, {"v": list(w)}, tol, msg)
                continue
            assert g.shape == w.shape, (msg, g.shape, w.shape)
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=msg)
            else:
                np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64),
                                              err_msg=msg)


def check_op(op_type, ins, attrs, tol, grad=True, seed=0):
    """The port's lowering against the JAX package's on the same inputs,
    forward and (grad) the generic grad with seed-made cotangents on every
    floating output."""
    want, got = lower_both(op_type, ins, attrs)
    assert_outs_close(got, want, tol, op_type)
    if not grad:
        return want
    rng = np.random.RandomState(seed + 100)
    cots = {s: [rng.randn(*v.shape).astype(np.float32) for v in vs]
            for s, vs in want.items()
            if all(v is not None and not isinstance(v, tuple)
                   and np.issubdtype(v.dtype, np.floating) for v in vs)}
    gw, gg = [grad_one(p, op_type, ins, attrs, cots) for p in PACKAGES]
    assert_outs_close(gg, gw, tol, op_type + "_grad")
    return want


def fluid_of(package):
    return importlib.import_module(package + ".fluid")


def exe_scope(package, seed=0):
    """(executor, scope, scope_guard) of one package on the CPU."""
    if package == "paddle_tpu":
        from paddle_tpu.executor import Executor, Scope, scope_guard

        return Executor(), Scope(seed=seed), scope_guard
    return pt.Executor(pt.CPUPlace()), pt.Scope(seed=seed, place=pt.CPUPlace()), pt.scope_guard


def build(package, program_fn):
    """(main, startup, fetch vars) of `program_fn(fluid)` in `package`."""
    fluid = fluid_of(package)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        fetch = program_fn(fluid)
    return main, startup, list(fetch)


def run_both(program_fn, feeds, steps=1, flags=None, state=None):
    """Build with `program_fn(fluid)` -> fetch vars in both packages, run the
    JAX package's startup program and carry its persistables into the port
    (and `state`, {name: array}, into both), then `steps` runs of the main
    program over `feeds` (one dict, or a list of one a step). Returns
    ([jax fetches a step], [port fetches a step], persistable names,
    ({name: array} of the JAX scope, of the port scope) after the steps)."""
    progs = {p: build(p, program_fn) for p in PACKAGES}
    names = convert.persistable_names(progs["paddle_tpu_torch"][0])
    results, finals = [], []
    shared = None
    for p in PACKAGES:
        main, startup, fetch = progs[p]
        exe, scope, guard = exe_scope(p)
        if flags:
            importlib.import_module(p + ".flags").set_flags(flags)
        try:
            with guard(scope):
                exe.run(startup)
                if p == "paddle_tpu":
                    shared = {n: np.asarray(scope.vars[n]) for n in names}
                    shared.update(state or {})
                    for n, v in (state or {}).items():
                        scope.vars[n] = jnp.asarray(v)
                else:
                    convert.load_into_scope(scope, shared, names)
                outs = []
                for i in range(steps):
                    f = feeds[i] if isinstance(feeds, list) else feeds
                    outs.append([np.asarray(v) for v in exe.run(
                        main, feed=f, fetch_list=[v.name for v in fetch])])
                if p == "paddle_tpu":
                    finals.append({n: np.asarray(scope.vars[n]) for n in names})
                else:
                    finals.append(convert.scope_to_numpy(scope, names))
        finally:
            if flags:
                importlib.import_module(p + ".flags").set_flags(
                    {k: "" if isinstance(v, str) else False for k, v in flags.items()})
        results.append(outs)
    return results[0], results[1], names, finals


def assert_runs_close(got, want, rtol, atol, what=""):
    for i, (g_step, w_step) in enumerate(zip(got, want)):
        for j, (g, w) in enumerate(zip(g_step, w_step)):
            msg = "%s step %d fetch %d" % (what, i, j)
            assert np.shape(g) == np.shape(w), (msg, np.shape(g), np.shape(w))
            if np.issubdtype(np.asarray(w).dtype, np.floating):
                np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=msg)
            else:
                np.testing.assert_array_equal(np.asarray(g).astype(np.int64),
                                              np.asarray(w).astype(np.int64), err_msg=msg)
