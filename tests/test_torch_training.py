"""The training slice of the torch port against the JAX package: a small
Transformer (models/transformer.py) built in both packages, the JAX
startup's weights and optimizer state carried into the port by name
(paddle_tpu_torch.convert), then 3 Adam steps through each package's
Executor.run, under the training_fused pass preset and with no pipeline.

Tolerances:
- step-1 fetched @GRADs: rtol 1e-4 (f32 both sides; the last digits move
  with the summation order of every product, and an absolute floor of
  1e-4 of the grad's largest magnitude keeps cancelled entries from
  counting as relative error);
- losses and the whole state after 3 steps: rtol 2e-3, atol 2e-4, the JAX
  package's own fused-vs-unfused bar (tests/test_fused_kernels.py).

At these sizes every fused family's predicate holds (rows = 128, widths
multiples of 128), so under training_fused both packages' dispatch
counters move for all four families; with no pipeline neither moves.
"""

import collections

import numpy as np
import pytest

import jax

import paddle_tpu.fluid as jfluid
from paddle_tpu import flags as jflags
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.executor import scope_guard as jscope_guard
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.ops import pallas_kernels as jpk

import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.models import transformer as ptransformer
from paddle_tpu_torch.ops import fused, registry

from torch_transformer_case import SMALL, build, make_batch

jax.config.update("jax_platforms", "cpu")

STEPS = 3
FAMILIES = ("gemm_epilogue", "layer_norm", "layer_norm_grad", "multi_adam")


def _jax_run(pipeline):
    jflags.set_flags({"pass_pipeline": pipeline})
    jpk.KERNEL_DISPATCHES.clear()
    try:
        main, startup, loss = build(jfluid, jtransformer, SMALL)
        grads = [p.name + "@GRAD" for p in main.global_block().all_parameters()
                 if p.trainable]
        names = convert.persistable_names(main)
        scope = JScope(seed=7)
        exe = jfluid.Executor()
        losses, step1 = [], None
        with jscope_guard(scope):
            exe.run(startup)
            init = {n: np.array(np.asarray(scope.vars[n])) for n in names}
            for s in range(STEPS):
                out = exe.run(main, feed=make_batch(SMALL, s),
                              fetch_list=[loss.name] + grads)
                losses.append(np.asarray(out[0]).copy())
                if s == 0:
                    step1 = {g: np.asarray(v).copy() for g, v in zip(grads, out[1:])}
            final = {n: np.array(np.asarray(scope.vars[n])) for n in names}
        ops = collections.Counter(op.type for op in main.global_block().ops)
        return dict(losses=np.stack(losses), step1=step1, init=init, final=final,
                    grads=grads, names=names, dispatches=dict(jpk.KERNEL_DISPATCHES),
                    ops=ops)
    finally:
        jflags.set_flags({"pass_pipeline": ""})


def _port_run(pipeline, init):
    pt.flags.set_flags({"pass_pipeline": pipeline})
    fused.reset_stats()
    try:
        main, startup, loss = build(pt, ptransformer, SMALL)
        grads = [p.name + "@GRAD" for p in main.global_block().all_parameters()
                 if p.trainable]
        names = convert.persistable_names(main)
        scope = pt.Scope(seed=0, place=pt.CPUPlace())
        exe = pt.Executor(pt.CPUPlace())
        losses, step1 = [], None
        with pt.scope_guard(scope):
            exe.run(startup)
            convert.load_into_scope(scope, init, names)
            for s in range(STEPS):
                out = exe.run(main, feed=make_batch(SMALL, s),
                              fetch_list=[loss.name] + grads)
                losses.append(out[0])
                if s == 0:
                    step1 = dict(zip(grads, out[1:]))
            final = convert.scope_to_numpy(scope, names)
        return dict(losses=np.stack(losses), step1=step1, final=final, grads=grads,
                    names=names, stats=fused.stats(), program=main)
    finally:
        pt.flags.set_flags({"pass_pipeline": ""})


@pytest.fixture(scope="module", params=["training_fused", ""], ids=["training_fused", "no_pipeline"])
def runs(request):
    j = _jax_run(request.param)
    p = _port_run(request.param, j["init"])
    return request.param, j, p


def test_same_program_and_state_names(runs):
    _, j, p = runs
    assert j["grads"] == p["grads"]
    assert j["names"] == p["names"]
    ops = collections.Counter(op.type for op in p["program"].global_block().ops)
    assert ops == j["ops"]
    assert ops["adam"] == len(p["grads"])


def test_step1_grads_match(runs):
    _, j, p = runs
    for g in j["grads"]:
        want = j["step1"][g]
        np.testing.assert_allclose(p["step1"][g], want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()), err_msg=g)


def test_losses_match(runs):
    _, j, p = runs
    assert np.all(np.isfinite(p["losses"]))
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=2e-3, atol=2e-4)


def test_state_after_steps_matches(runs):
    _, j, p = runs
    for n in j["names"]:
        np.testing.assert_allclose(p["final"][n], j["final"][n], rtol=2e-3, atol=2e-4,
                                   err_msg=n)


def test_dispatch_counters(runs):
    pipeline, j, p = runs
    if pipeline:
        for fam in FAMILIES:
            assert j["dispatches"].get(fam, 0) > 0, (fam, j["dispatches"])
            assert p["stats"]["dispatches"].get(fam, 0) > 0, (fam, p["stats"])
        # the same runs accepted (and declined) in both packages: the JAX
        # package counts while it traces the step (once), the port every step
        assert p["stats"]["dispatches"] == {k: STEPS * v for k, v in j["dispatches"].items()}
        # one multi_adam run a step; on the CPU the wrappers take the plain
        # versions, so no kernel launched
        assert p["stats"]["dispatches"]["multi_adam"] == STEPS
    else:
        assert not j["dispatches"] and not p["stats"]["dispatches"]
    assert not any(p["stats"]["launches"].values())


def test_every_op_type_registered(runs):
    _, _, p = runs
    types = {op.type for op in p["program"].global_block().ops}
    missing = sorted(t for t in types if not registry.is_registered(t))
    assert not missing, missing
