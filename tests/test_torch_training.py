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

from paddle_tpu_torch.ops import registry

from torch_transformer_case import SMALL, jax_run, port_run

jax.config.update("jax_platforms", "cpu")

STEPS = 3
FAMILIES = ("gemm_epilogue", "layer_norm", "layer_norm_grad", "multi_adam")


@pytest.fixture(scope="module", params=["training_fused", ""], ids=["training_fused", "no_pipeline"])
def runs(request):
    j = jax_run(SMALL, request.param, STEPS)
    p = port_run(SMALL, request.param, j["init"], STEPS)
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
