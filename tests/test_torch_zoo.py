"""The rest of the CNN zoo in the torch port (models/alexnet.py, vgg.py,
googlenet.py, se_resnext.py) against the JAX package, on the CPU, at the
smallest inputs that keep every layer (the builders of
tests/test_passes.py, 10 classes): AlexNet at 67 x 67 (a 1 x 1 map before
fc6), VGG-16 and VGG-19 at 32 x 32, GoogLeNet at 96 x 96 with both
auxiliary heads (the smallest input whose 4a map still takes the heads'
5 x 5 pool), SE-ResNeXt-50 at 64 x 64 with one bottleneck a stage and
filters [32, 64, 128, 256] (cardinality 32).

- Each model builds the same program in both packages, and the
  training_fused pass tags the same runs.
- Each trains 2 steps of Momentum(0.01, 0.9) from the same weights (the
  port's startup program's, carried into the JAX package by name) on the
  same seeded batches: losses and every persistable after the steps
  (parameters, velocities, batch_norm's running statistics) at rtol 2e-3,
  atol 2e-4, the bar of tests/test_torch_book.py (the JAX package's
  fused-vs-unfused bar). The dropout ops run at dropout_prob 0 in both
  programs (each package draws its masks from its own generator, so no
  other rate gives the same masks); their ops and grads still run.
- GoogLeNet (22 conv layers, no batch_norm) is ill-conditioned at these
  weights: its first step's grads agree within 4e-6 relative, but the
  second step's first-layer grads move by 2e-2 relative on that
  difference. So each of its port steps starts from the JAX package's
  state after the step before (STEPWISE), as the MobileNet-SSD test of
  tests/test_torch_detection.py does.
"""

import numpy as np
import pytest

import jax

import paddle_tpu.fluid as jfluid
from paddle_tpu import models as jmodels
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.executor import scope_guard as jscope_guard
from paddle_tpu.passes import manager as jmanager

import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch import models as pmodels
from paddle_tpu_torch.passes import manager as pmanager

from torch_zoo_cases import MODELS, build, feeds

jax.config.update("jax_platforms", "cpu")

RTOL, ATOL = 2e-3, 2e-4
STEPS = 2
TAGS = ("__pallas_group__", "__pallas_kernel__", "__fusion_group__")
STEPWISE = {"googlenet"}

def _ops(program):
    return [(op.type, {k: list(v) for k, v in sorted(op.inputs.items())},
             {k: list(v) for k, v in sorted(op.outputs.items())},
             {k: repr(v) for k, v in sorted(op.attrs.items())})
            for op in program.global_block().ops]


def _vars(program):
    return {n: (tuple(v.shape) if v.shape is not None else None, v.dtype, bool(v.persistable))
            for n, v in program.global_block().vars.items()}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_builds_the_same_program(name):
    j = build(jfluid, jmodels, name)
    p = build(pt, pmodels, name)
    for jp, pp in ((j[0], p[0]), (j[1], p[1])):
        assert _ops(pp) == _ops(jp)
        assert _vars(pp) == _vars(jp)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_training_fused_tags_match(name):
    outs = []
    for pkg, mods, manager in ((jfluid, jmodels, jmanager), (pt, pmodels, pmanager)):
        main, _, loss = build(pkg, mods, name)
        outs.append(manager.PassManager("training_fused").apply(
            main, scope=None, feed_names=["img", "label"], fetch_names=[loss.name]))
    views = [[(op.type, sorted(op.input_arg_names), sorted(op.output_arg_names),
               tuple(op.attrs.get(t) for t in TAGS)) for op in o.global_block().ops]
             for o in outs]
    assert views[1] == views[0]


def _train(name, batches):
    """STEPS steps in each package from the port's startup weights, carried
    into the JAX package by name (its own startup program compiles for up
    to 18 s a model on this CPU, the port's runs in about one). A model in
    STEPWISE starts each port step from the JAX package's state after the
    step before. Returns (names, init, (JAX losses, final state), (port
    losses, final state))."""
    import jax.numpy as jnp

    main, startup, loss = build(pt, pmodels, name, no_dropout=True)
    names = convert.persistable_names(main)
    pscope, pexe = pt.Scope(seed=7, place=pt.CPUPlace()), pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pscope):
        pexe.run(startup)
    init = convert.scope_to_numpy(pscope, names)
    jmain, _, jloss = build(jfluid, jmodels, name, no_dropout=True)
    assert convert.persistable_names(jmain) == names
    jscope, jexe = JScope(seed=7), jfluid.Executor()
    for n in names:
        jscope.vars[n] = jnp.asarray(init[n])
    jl, pl, jstate = [], [], init
    for f in batches:
        if name in STEPWISE:
            convert.load_into_scope(pscope, jstate, names)
        with jscope_guard(jscope):
            jl.append(float(np.asarray(jexe.run(jmain, feed=f, fetch_list=[jloss.name])[0])
                            .reshape(-1)[0]))
            jstate = {n: np.array(np.asarray(jscope.vars[n])) for n in names}
        with pt.scope_guard(pscope):
            pl.append(float(pexe.run(main, feed=f, fetch_list=[loss.name])[0].reshape(-1)[0]))
    return names, init, (jl, jstate), (pl, convert.scope_to_numpy(pscope, names))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_trains_as_the_jax_package(name):
    names, init, (jl, jfinal), (pl, pfinal) = _train(name, feeds(name, STEPS))
    assert np.all(np.isfinite(pl))
    np.testing.assert_allclose(pl, jl, rtol=RTOL, atol=ATOL, err_msg="%s losses" % name)
    moved = 0
    for n in names:
        np.testing.assert_allclose(pfinal[n], jfinal[n], rtol=RTOL, atol=ATOL,
                                   err_msg="%s %s" % (name, n))
        if not np.array_equal(jfinal[n], init[n]):
            moved += 1
            assert not np.array_equal(pfinal[n], init[n]), n
    assert moved > len(names) // 2
