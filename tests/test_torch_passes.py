"""The pass framework of the torch port (paddle_tpu_torch/passes) against
the JAX package's: on the same Transformer training program, the
training_fused preset folds, eliminates and tags the same ops, with the
same kernel families and groups, and plans the same state split."""

import numpy as np
import pytest

import jax

import paddle_tpu.fluid as jfluid
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.executor import scope_guard as jscope_guard
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.ops import registry as jregistry
from paddle_tpu.passes import manager as jmanager

import paddle_tpu_torch as pt
from paddle_tpu_torch.models import transformer as ptransformer
from paddle_tpu_torch.ops import registry as pregistry
from paddle_tpu_torch.passes import manager as pmanager
from paddle_tpu_torch.tools.profile_training import BASE

from torch_transformer_case import FEED_NAMES, SMALL, build

jax.config.update("jax_platforms", "cpu")

TAGS = ("__pallas_group__", "__pallas_kernel__", "__fusion_group__")


def _apply(pkg, transformer, scope_cls, guard, manager, cfg, pipeline, place=None):
    main, startup, loss = build(pkg, transformer, cfg)
    scope = scope_cls(seed=1) if place is None else scope_cls(seed=1, place=place)
    exe = pkg.Executor() if place is None else pkg.Executor(place)
    with guard(scope):
        exe.run(startup)
    out = manager.PassManager(pipeline).apply(
        main, scope=scope, feed_names=list(FEED_NAMES), fetch_names=[loss.name]
    )
    return main, out


def _both(cfg, pipeline):
    _, jout = _apply(jfluid, jtransformer, JScope, jscope_guard, jmanager, cfg, pipeline)
    _, pout = _apply(pt, ptransformer, pt.Scope, pt.scope_guard, pmanager, cfg, pipeline,
                     place=pt.CPUPlace())
    return jout, pout


def _op_view(program):
    return [
        (op.type, sorted(op.input_arg_names), sorted(op.output_arg_names),
         tuple(op.attrs.get(t) for t in TAGS))
        for op in program.global_block().ops
    ]


def test_preset_lists_match():
    for name in ("training_default", "training_fused", "inference"):
        assert pmanager.PRESETS[name] == jmanager.PRESETS[name]


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["no_dropout", "dropout"])
def test_training_fused_tags_match(dropout):
    cfg = dict(SMALL, dropout=dropout)
    jout, pout = _both(cfg, "training_fused")
    jv, pv = _op_view(jout), _op_view(pout)
    assert len(pv) == len(jv)
    for i, (a, b) in enumerate(zip(pv, jv)):
        assert a == b, (i, a, b)
    kernels = {v[3][1] for v in pv if v[3][1]}
    assert kernels == {"gemm_epilogue", "layer_norm", "layer_norm_grad", "multi_adam"}


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["no_dropout", "dropout"])
def test_pass_results_and_state_plan_match(dropout):
    cfg = dict(SMALL, dropout=dropout)
    jout, pout = _both(cfg, "training_fused")
    for name in jmanager.PRESETS["training_fused"]:
        jr, pr = dict(jout._pass_results[name]), dict(pout._pass_results[name])
        if name == "inplace_donation_plan":
            for k in ("feed", "fetch", "mut", "ro", "unknown"):
                assert pr[k] == jr[k], (k, pr[k], jr[k])
        else:
            assert pr == jr, (name, pr, jr)


def test_transformer_base_tags_match():
    """Transformer base (N=6, d_model 512, d_ff 2048, h=8, vocab 37000,
    16 x 256 tokens), the configuration the port trains on the card: both
    packages tag the same ops, and the optimizer's 183 adam ops (180 in the
    layers, two word embeddings and the head) form one multi_adam run."""
    outs = []
    for pkg, transformer, manager in ((jfluid, jtransformer, jmanager),
                                      (pt, ptransformer, pmanager)):
        main, _, loss = build(pkg, transformer, BASE)
        outs.append(manager.PassManager("training_fused").apply(
            main, scope=None, feed_names=list(FEED_NAMES), fetch_names=[loss.name]))
    jv, pv = _op_view(outs[0]), _op_view(outs[1])
    assert pv == jv
    groups = {}
    for _, _, _, (group, kernel, _) in pv:
        if kernel:
            groups.setdefault(kernel, set()).add(group)
    assert {k: len(v) for k, v in groups.items()} == {
        "gemm_epilogue": 42, "layer_norm": 30, "layer_norm_grad": 30, "multi_adam": 1}
    assert sum(v[0] == "adam" for v in pv) == 183


def test_every_tagged_family_has_a_fused_lowering():
    _, pout = _both(SMALL, "training_fused")
    families = {op.attrs.get("__pallas_kernel__") for op in pout.global_block().ops} - {None}
    assert families <= set(pregistry.FUSED_LOWERINGS)
    assert set(pregistry.FUSED_LOWERINGS) <= set(jregistry.FUSED_LOWERINGS)


def test_executor_memoizes_the_rewritten_program():
    """Executor.run applies FLAGS_pass_pipeline once per (program version,
    scope, feeds, fetches): a second run reuses the rewritten program and
    the block prepared for it."""
    from paddle_tpu_torch import executor as pexecutor

    main, startup, loss = build(pt, ptransformer, SMALL)
    scope = pt.Scope(seed=1, place=pt.CPUPlace())
    with pt.scope_guard(scope):
        pt.Executor(pt.CPUPlace()).run(startup)
    a = pexecutor._apply_pass_pipeline(main, scope, list(FEED_NAMES), [loss.name],
                                       "training_fused")
    b = pexecutor._apply_pass_pipeline(main, scope, list(FEED_NAMES), [loss.name],
                                       "training_fused")
    assert a is b and a is not main
    assert a._donation_plan["mut"]  # the step writes its parameters back
    assert pexecutor._apply_pass_pipeline(main, scope, [], [loss.name], "") is main
    assert np.all([op.type for op in a.global_block().ops])
