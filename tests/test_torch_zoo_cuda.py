"""The zoo models (AlexNet, VGG-16/19, GoogLeNet, SE-ResNeXt-50) and the
explicit batch_norm_grad on the card. Every test here is marked `cuda` and
skips without a card; on the card they run with `python -m pytest
--noconftest tests/test_torch_zoo_cuda.py -m cuda` (this file imports no
JAX).

- Each model at the CPU tests' small sizes (tests/torch_zoo_cases.py),
  4 steps under training_fused from one seed, dropout on: the graph path
  (call 1 op by op, call 2 captured, then replays) gives the op-by-op
  path's losses bit for bit, with the same kernel launches a step (cuDNN
  restricted to deterministic algorithms).
- batch_norm_grad's explicit lowering against the generic vjp grad on the
  card, training, is_test, use_global_stats, NHWC and 2-D, with and
  without X@GRAD: rtol 1e-5 with an absolute floor of 1e-6 of the grad's
  largest magnitude (sums in another order), and at a ResNet stem's shape
  (32, 64, 56, 56) at rtol 1e-4 with a floor of 1e-5 (longer sums).
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import flags, models, profiler
from paddle_tpu_torch.ops import fused, registry

from torch_cnn_cases import BN_CASES
from torch_zoo_cases import MODELS, build, feeds

BN_GRAD_RTOL, BN_GRAD_ATOL = 1e-5, 1e-6
BN_LARGE_RTOL, BN_LARGE_ATOL = 1e-4, 1e-5
STEPS = 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: cuDNN and the hand-written kernels")
    return torch.device("cuda", 0)


@contextlib.contextmanager
def _op_by_op():
    flags.set_flags({"profile_ops": True})
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            with profiler.profiler(profile_path=None):
                yield
    finally:
        flags.set_flags({"profile_ops": False})


def _steps(name, device, batches, per_op):
    main, startup, loss = build(pt, models, name)
    pt.set_flags({"pass_pipeline": "training_fused"})
    try:
        scope, exe = pt.Scope(seed=0, place=device), pt.Executor(device)
        out, deltas = [], []
        with pt.scope_guard(scope), (_op_by_op() if per_op else contextlib.nullcontext()):
            exe.run(startup)
            for f in batches:
                before = fused.stats()["launches"]
                out.append(exe.run(main, feed=f, fetch_list=[loss.name])[0])
                after = fused.stats()["launches"]
                deltas.append({k: after[k] - before[k] for k in after if after[k] != before[k]})
        return out, deltas
    finally:
        pt.set_flags({"pass_pipeline": ""})


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MODELS))
def test_zoo_graph_matches_op_by_op(cuda_device, name):
    batches = feeds(name, STEPS)
    graph, gd = _steps(name, cuda_device, batches, per_op=False)
    eager, ed = _steps(name, cuda_device, batches, per_op=True)
    for i, (g, e) in enumerate(zip(graph, eager)):
        assert np.isfinite(g).all()
        assert g.tobytes() == e.tobytes(), (name, i, g, e)
    assert gd == ed
    assert all(d == gd[0] for d in gd)


def _bn(shape, layout, extra, device, seed=27):
    c = shape[1] if layout == "NCHW" else shape[-1]
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    ins = {"X": [r(*shape) * 2 + 1], "Scale": [torch.rand(c, generator=g) + 0.5],
           "Bias": [r(c)], "Mean": [r(c)], "Variance": [torch.rand(c, generator=g) + 0.5]}
    ins = {k: [v.to(device) for v in vs] for k, vs in ins.items()}
    attrs = dict(extra, data_layout=layout, momentum=0.8, epsilon=1e-5)
    ctx = registry.LowerCtx(device)
    outs = registry.get("batch_norm").lower(ctx, ins, attrs)
    gins = dict(ins, **outs)
    gins["Y@GRAD"] = [r(*shape).to(device)]
    gattrs = dict(attrs, **{registry.FWD_IN_SLOTS_ATTR: list(ins),
                            registry.FWD_OUT_SLOTS_ATTR: list(outs)})
    return ctx, gins, gattrs


class _GradOp:
    def __init__(self, outputs):
        self.outputs = outputs


def _explicit_vs_generic(ctx, gins, gattrs, skip_x, rtol, atol):
    generic = registry._make_generic_grad(registry.get("batch_norm"))(ctx, gins, gattrs)
    ctx.op = _GradOp({"X@GRAD": [registry.EMPTY_VAR_NAME if skip_x else "x@GRAD"],
                      "Scale@GRAD": ["s@GRAD"], "Bias@GRAD": ["b@GRAD"]})
    explicit = registry.get("batch_norm_grad").lower(ctx, gins, gattrs)
    assert ("X@GRAD" in explicit) == (not skip_x)
    for slot in explicit:
        got, want = explicit[slot][0].cpu().numpy(), generic[slot][0].cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=atol * float(np.abs(want).max()), err_msg=slot)


@pytest.mark.cuda
@pytest.mark.parametrize("skip_x", [False, True])
@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batch_norm_explicit_grad_on_card(cuda_device, case, skip_x):
    extra, shape, layout = BN_CASES[case]
    ctx, gins, gattrs = _bn(shape, layout, extra, cuda_device)
    _explicit_vs_generic(ctx, gins, gattrs, skip_x, BN_GRAD_RTOL, BN_GRAD_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_batch_norm_explicit_grad_at_a_stem_shape(cuda_device, layout):
    shape = (32, 64, 56, 56) if layout == "NCHW" else (32, 56, 56, 64)
    ctx, gins, gattrs = _bn(shape, layout, {"is_test": False}, cuda_device)
    _explicit_vs_generic(ctx, gins, gattrs, False, BN_LARGE_RTOL, BN_LARGE_ATOL)
