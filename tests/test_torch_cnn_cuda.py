"""The CNN lowerings of the torch port on the card against their CPU form,
and LeNet-5's training step on CUDA graphs against the op-by-op path. Every
test here is marked `cuda` and skips without a card; on the card they run
with `python -m pytest --noconftest tests/test_torch_cnn_cuda.py -m cuda`
(this file imports no JAX).

Tolerances: forward rtol = atol = 1e-5 and grads rtol 1e-4 with an
absolute floor of 1e-5 of the largest magnitude, card against CPU (f32
both, cuDNN's and the CPU's sums in different orders; TF32 off); on the
card, conv2d_grad's explicit lowering against the generic vjp at the same
tolerance; the optimizers at rtol 1e-5 (elementwise f32, no sums); graph
against op by op bit for bit (cuDNN restricted to deterministic
algorithms).
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import flags, profiler
from paddle_tpu_torch.ops import fused, registry
from paddle_tpu_torch.tools import profile_training as prof

from torch_cnn_cases import BN_CASES, CONV_CASES, POOL_CASES, conv_attrs, pool_attrs

FWD_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: cuDNN and the hand-written kernels")
    return torch.device("cuda", 0)


def _rand(shape, seed, lo=None):
    a = np.random.RandomState(seed).randn(*shape).astype("float32")
    return torch.from_numpy(a if lo is None else np.abs(a) + lo)


def _lower(op_type, ins, attrs, device):
    ctx = registry.LowerCtx(device)
    return registry.get(op_type).lower(ctx, {k: [v.to(device) for v in vs]
                                             for k, vs in ins.items()}, attrs)


def _grads(op_type, ins, attrs, out_slot, device, generic=False):
    """Forward outputs and the grads of sum(out * dy) by the op's grad
    lowering (explicit where registered, or the generic vjp)."""
    fwd = _lower(op_type, ins, attrs, device)
    y = fwd[out_slot][0]
    dy = torch.from_numpy(np.random.RandomState(9).randn(*y.shape).astype("float32"))
    g_ins = {k: [v.to(device) for v in vs] for k, vs in ins.items()}
    g_ins.update({s: v for s, v in fwd.items()})
    g_ins[out_slot + "@GRAD"] = [dy.to(device)]
    gattrs = dict(attrs, **{registry.FWD_IN_SLOTS_ATTR: list(ins),
                            registry.FWD_OUT_SLOTS_ATTR: list(fwd)})
    ctx = registry.LowerCtx(device)
    if generic:
        grads = registry._make_generic_grad(registry.get(op_type))(ctx, g_ins, gattrs)
    else:
        grads = registry.get(op_type + "_grad").lower(ctx, g_ins, gattrs)
    return fwd, {k: v[0].cpu() for k, v in grads.items() if v and v[0] is not None}


def _close_grad(got, want, what):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL * max(float(want.abs().max()), 1e-30),
                               err_msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_on_card_matches_cpu(cuda_device, case):
    c = CONV_CASES[case]
    ins = {"Input": [_rand(c[1], 1)], "Filter": [_rand(c[2], 2)]}
    fwd, grads = _grads(c[0], ins, conv_attrs(c), "Output", cuda_device)
    cfwd, cgrads = _grads(c[0], ins, conv_attrs(c), "Output", "cpu")
    np.testing.assert_allclose(fwd["Output"][0].cpu().numpy(), cfwd["Output"][0].numpy(),
                               rtol=FWD_TOL, atol=FWD_TOL)
    assert sorted(grads) == ["Filter@GRAD", "Input@GRAD"]
    for slot in grads:
        _close_grad(grads[slot], cgrads[slot], slot)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_explicit_grad_matches_generic_on_card(cuda_device, case):
    c = CONV_CASES[case]
    ins = {"Input": [_rand(c[1], 1)], "Filter": [_rand(c[2], 2)]}
    _, explicit = _grads(c[0], ins, conv_attrs(c), "Output", cuda_device)
    _, generic = _grads(c[0], ins, conv_attrs(c), "Output", cuda_device, generic=True)
    for slot in ("Input@GRAD", "Filter@GRAD"):
        _close_grad(explicit[slot], generic[slot], slot)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool2d_on_card_matches_cpu(cuda_device, case):
    ins = {"X": [_rand((2, 3, 9, 9), 4)]}
    fwd, grads = _grads("pool2d", ins, pool_attrs(case), "Out", cuda_device, generic=True)
    cfwd, cgrads = _grads("pool2d", ins, pool_attrs(case), "Out", "cpu", generic=True)
    np.testing.assert_allclose(fwd["Out"][0].cpu().numpy(), cfwd["Out"][0].numpy(),
                               rtol=FWD_TOL, atol=FWD_TOL)
    _close_grad(grads["X@GRAD"], cgrads["X@GRAD"], case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["max_2x2_s2", "max_3x3_s2_p1"])
def test_max_pool_tied_window_grad_on_card(cuda_device, case):
    """A tied window sends its whole cotangent to its first element on the
    card as on the CPU (the JAX package's select-and-scatter)."""
    x = torch.from_numpy(np.random.RandomState(5).randint(0, 2, (2, 3, 9, 9)).astype("float32"))
    ins = {"X": [x]}
    _, grads = _grads("pool2d", ins, pool_attrs(case), "Out", cuda_device, generic=True)
    _, cgrads = _grads("pool2d", ins, pool_attrs(case), "Out", "cpu", generic=True)
    assert torch.equal(grads["X@GRAD"], cgrads["X@GRAD"])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batch_norm_on_card_matches_cpu(cuda_device, case):
    extra, shape, layout = BN_CASES[case]
    c = shape[1] if layout == "NCHW" else shape[-1]
    ins = {"X": [_rand(shape, 6) * 2 + 1], "Scale": [_rand((c,), 7, lo=0.5)],
           "Bias": [_rand((c,), 8)], "Mean": [_rand((c,), 9)], "Variance": [_rand((c,), 10, 0.5)]}
    attrs = dict(extra, data_layout=layout, momentum=0.8)
    fwd, grads = _grads("batch_norm", ins, attrs, "Y", cuda_device, generic=True)
    cfwd, cgrads = _grads("batch_norm", ins, attrs, "Y", "cpu", generic=True)
    for slot in ("Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        np.testing.assert_allclose(fwd[slot][0].cpu().numpy(), cfwd[slot][0].numpy(),
                                   rtol=FWD_TOL, atol=FWD_TOL, err_msg=slot)
    for slot in ("X@GRAD", "Scale@GRAD", "Bias@GRAD"):
        _close_grad(grads[slot], cgrads[slot], slot)


OPTIMIZER_OPS = {
    "sgd": ({}, {}),
    "momentum": ({"Velocity": 1}, {"mu": 0.9}),
    "momentum_nesterov": ({"Velocity": 1}, {"mu": 0.9, "use_nesterov": True}),
    "lars_momentum": ({"Velocity": 1}, {"mu": 0.9}),
    "adagrad": ({"Moment": 1}, {}),
    "decayed_adagrad": ({"Moment": 1}, {}),
    "rmsprop": ({"MeanSquare": 1, "Moment": 1}, {}),
    "adadelta": ({"AvgSquaredGrad": 1, "AvgSquaredUpdate": 1}, {}),
    "adamax": ({"Moment": 1, "InfNorm": 1, "Beta1Pow": 0}, {}),
    "ftrl": ({"SquaredAccumulator": 1, "LinearAccumulator": 1}, {"l1": 0.01, "l2": 0.01}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(OPTIMIZER_OPS))
def test_optimizer_on_card_matches_cpu(cuda_device, name):
    slots, attrs = OPTIMIZER_OPS[name]
    op_type = "momentum" if name.startswith("momentum") else name
    ins = {"Param": [_rand((64, 33), 1)], "Grad": [_rand((64, 33), 2)],
           "LearningRate": [torch.tensor([0.05])]}
    for i, (slot, full) in enumerate(sorted(slots.items())):
        ins[slot] = [_rand((64, 33), 3 + i, lo=0.1) if full else torch.tensor([0.8])]
    got = _lower(op_type, ins, attrs, cuda_device)
    want = _lower(op_type, ins, attrs, "cpu")
    assert sorted(got) == sorted(want)
    for slot in got:
        np.testing.assert_allclose(got[slot][0].cpu().numpy(), want[slot][0].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=slot)


@contextlib.contextmanager
def _op_by_op():
    flags.set_flags({"profile_ops": True})
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            with profiler.profiler(profile_path=None):
                yield
    finally:
        flags.set_flags({"profile_ops": False})


def _lenet_steps(device, feeds, per_op):
    model = prof.build_lenet()
    pt.set_flags({"pass_pipeline": "training_fused"})
    try:
        scope, exe = pt.Scope(seed=0, place=device), pt.Executor(device)
        out, deltas = [], []
        with pt.scope_guard(scope), (_op_by_op() if per_op else contextlib.nullcontext()):
            exe.run(model["startup"])
            for f in feeds:
                before = fused.stats()
                out.append(exe.run(model["main"], feed=f,
                                   fetch_list=[model["loss"].name, model["acc"].name]))
                after = fused.stats()
                deltas.append({k: after["launches"][k] - before["launches"][k]
                               for k in after["launches"]
                               if after["launches"][k] != before["launches"][k]})
        return out, deltas
    finally:
        pt.set_flags({"pass_pipeline": ""})


@pytest.mark.cuda
def test_lenet_graph_matches_op_by_op(cuda_device):
    """The book script's LeNet-5 under training_fused, 4 steps of batch 16:
    the graph path (call 1 op by op, call 2 captured) gives the op-by-op
    path's losses and accuracies bit for bit, with 3 GEMM epilogue and 1
    multi_adam launches a step on both."""
    model = prof.build_lenet()
    feeds = prof.lenet_feeds(model, 4, pt.CPUPlace(), batch_size=16)
    graph, gd = _lenet_steps(cuda_device, feeds, per_op=False)
    eager, ed = _lenet_steps(cuda_device, feeds, per_op=True)
    for g, e in zip(graph, eager):
        assert all(a.tobytes() == b.tobytes() for a, b in zip(g, e)), (g, e)
    assert gd == ed == [{"gemm_epilogue": 3, "multi_adam": 1}] * 4
