"""The hand kernels as torch.library ops (namespace paddle_tpu_torch): each
op's schema, its fake against its CPU implementation, and the tensors it
declares it mutates, by torch.library.opcheck on CPU tensors at small
shapes; each wrapper's result against its plain version, bit for bit (the
CPU implementation is the plain version); and, on the card, each op
launching its kernel (the `cuda`-marked case)."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import gemm_epilogue as ge
from paddle_tpu_torch.ops import layer_norm as ln
from paddle_tpu_torch.ops import multi_adam as ma

OPS = torch.ops.paddle_tpu_torch


def _t(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _cases(device):
    """(name, op, args) of each registered op at small shapes."""
    rng = np.random.default_rng(0)
    dev = torch.device(device)
    q, k, v = (_t(rng, 2, 3, 8, 16).to(dev) for _ in range(3))
    out, lse = fa.flash_forward_plain(q, k, v, False, 0.25)
    dout = _t(rng, 2, 3, 8, 16).to(dev)
    x2, w2, b = _t(rng, 16, 32).to(dev), _t(rng, 32, 24).to(dev), _t(rng, 24).to(dev)
    lx, lr_, sc, bi = (_t(rng, 8, 128).to(dev), _t(rng, 8, 128).to(dev),
                       _t(rng, 128).to(dev), _t(rng, 128).to(dev))
    _, _, mean, var = ln.fused_layer_norm_plain(lx, None, sc, bi, 1e-5)
    shapes = [(5, 3), (7,), (4, 4)]
    ps = [_t(rng, *s).to(dev) for s in shapes]
    gs = [_t(rng, *s).to(dev) for s in shapes]
    m1 = [_t(rng, *s).to(dev) * 0.1 for s in shapes]
    m2 = [_t(rng, *s).to(dev).abs() * 0.01 for s in shapes]
    lrs = torch.tensor([1e-3, 2e-3, 3e-3], device=dev)
    return [
        ("flash_forward", OPS.flash_forward, (q, k, v, False, 0.25)),
        ("flash_forward_causal", OPS.flash_forward, (q, k, v, True, 0.25)),
        ("flash_backward", OPS.flash_backward, (q, k, v, out, lse, dout, False, 0.25)),
        ("gemm_bias_act", OPS.gemm_bias_act, (x2, w2, b, "gelu")),
        ("gemm_bias_act_no_act", OPS.gemm_bias_act, (x2, w2, b, None)),
        ("fused_layer_norm", OPS.fused_layer_norm, (lx, lr_, sc, bi, 1e-5)),
        ("fused_layer_norm_no_residual", OPS.fused_layer_norm, (lx, None, None, None, 1e-5)),
        ("fused_layer_norm_grad", OPS.fused_layer_norm_grad, (lx, sc, mean, var, lr_, 1e-5)),
        ("multi_tensor_adam", OPS.multi_tensor_adam,
         (ps, gs, m1, m2, lrs, 0.9, 0.999, 1e-8)),
    ]


CASE_IDS = [c[0] for c in _cases("cpu")]


@pytest.mark.parametrize("name", CASE_IDS)
def test_op_passes_opcheck_on_cpu(name):
    """schema, fake against real (shapes, dtypes, strides), the declared
    mutations (multi_tensor_adam's params and moments, nothing else), and
    the op under torch.compile's AOT dispatcher."""
    (_, op, args), = [c for c in _cases("cpu") if c[0] == name]
    torch.library.opcheck(op, args)


def test_wrappers_equal_plain_on_cpu():
    """Through the ops, the CPU wrappers return their plain versions' bits
    (no tolerance: the CPU implementation is the plain version)."""
    cases = {c[0]: c[2] for c in _cases("cpu")}
    q, k, v, causal, s = cases["flash_forward_causal"]
    for got, want in zip(fa.flash_forward(q, k, v, causal, s),
                         fa.flash_forward_plain(q, k, v, causal, s)):
        assert torch.equal(got, want)
    args = cases["flash_backward"]
    for got, want in zip(fa.flash_backward(*args), fa.flash_backward_plain(*args)):
        assert torch.equal(got, want)
    x2, w2, b, _ = cases["gemm_bias_act"]
    for act in (None, "relu", "gelu", "tanh", "sigmoid"):
        got, want = ge.gemm_bias_act(x2, w2, b, act), ge.gemm_bias_act_plain(x2, w2, b, act)
        assert torch.equal(got[0], want[0])
        assert (got[1] is None) == (want[1] is None) == (act is None)
        if act:
            assert torch.equal(got[1], want[1])
    lx, r, sc, bi, eps = cases["fused_layer_norm"]
    for res in (None, r):
        got = ln.fused_layer_norm(lx, res, sc, bi, eps)
        want = ln.fused_layer_norm_plain(lx, res, sc, bi, eps)
        assert (got[0] is None) == (res is None)
        for g, w in zip(got, want):
            assert (g is None and w is None) or torch.equal(g, w)
    args = cases["fused_layer_norm_grad"]
    for g, w in zip(ln.fused_layer_norm_grad(*args), ln.fused_layer_norm_grad_plain(*args)):
        assert torch.equal(g, w)
    ps, gs, m1, m2, lrs, b1, b2, e = cases["multi_tensor_adam"]
    copies = [[t.clone() for t in group] for group in (ps, m1, m2)]
    ma.multi_tensor_adam(ps, gs, m1, m2, lrs, b1, b2, e)
    ma.multi_tensor_adam_plain(copies[0], gs, copies[1], copies[2], lrs, b1, b2, e)
    for group, want in zip((ps, m1, m2), copies):
        for g, w in zip(group, want):
            assert torch.equal(g, w)


def test_export_records_the_ops():
    """torch.export of a function over the wrappers holds each op by name in
    its graph (the CPU trace sees the op, not its plain form)."""

    class M(torch.nn.Module):
        def forward(self, q, k, v, x2, w2, b):
            out, lse = fa.flash_forward(q, k, v, True, 0.25)
            z, y = ge.gemm_bias_act(x2, w2, b, "relu")
            s, yy, mean, var = ln.fused_layer_norm(x2, z, None, None, 1e-5)
            return out.sum() + lse.sum() + y.sum() + yy.sum()

    rng = np.random.default_rng(1)
    args = (*(_t(rng, 1, 2, 4, 8) for _ in range(3)), _t(rng, 128, 128), _t(rng, 128, 128),
            _t(rng, 128))
    ep = torch.export.export(M(), args)
    targets = {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}
    for name in ("flash_forward", "gemm_bias_act", "fused_layer_norm"):
        assert "paddle_tpu_torch.%s.default" % name in targets, targets


def test_trace_over_card_tensors_records_ops_and_names_direct_kernels():
    """Over fake CUDA tensors (what torch.export traces on the card), the
    registered ops give their shapes from their fakes, and a kernel still
    launched by a direct call (the paged, quant GEMM and fp8 kernels)
    raises an error that names it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from paddle_tpu_torch.ops import paged_flash as pf
    from paddle_tpu_torch.ops import quant_gemm as qg

    with FakeTensorMode(allow_non_fake_inputs=True):
        q = torch.empty(2, 4, 16, 64, device="cuda")
        out, lse = fa.flash_forward(q, q, q, True, 0.125)
        assert out.shape == q.shape and lse.shape == (2, 4, 16) and lse.device == q.device
        x = torch.empty(32, 128, device="cuda")
        z, y = ge.gemm_bias_act(x, torch.empty(128, 256, device="cuda"),
                                torch.empty(256, device="cuda"), "relu")
        assert z.shape == y.shape == (32, 256)
        xi = torch.empty(32, 128, dtype=torch.int8, device="cuda")
        with pytest.raises(RuntimeError, match="quant_gemm_kernel is launched by a direct call"):
            qg.quant_gemm_bias_act(xi, torch.empty(128, 128, dtype=torch.int8, device="cuda"),
                                   torch.empty((), device="cuda"))
        with pytest.raises(RuntimeError, match="fp8_gemm_kernel"):
            qg.fp8_matmul(x, torch.empty(128, 64, device="cuda"))
        pool = torch.empty(4, 8, 64, device="cuda")
        with pytest.raises(RuntimeError, match="paged_flash"):
            pf.paged_flash_attention(torch.empty(1, 64, device="cuda"), pool, pool,
                                     torch.empty(1, 4, dtype=torch.int32, device="cuda"),
                                     torch.empty(1, dtype=torch.int32, device="cuda"),
                                     n_head=1, page_size=8)


@pytest.mark.cuda
def test_ops_launch_their_kernels_on_the_card():
    """Each op on CUDA tensors launches its kernel once (the launch counters
    live in the ops' CUDA implementations) and agrees with its plain
    version: flash and layer_norm at rtol 2e-3 / atol 2e-4 (3xTF32 sums and
    another summation order), the GEMM at the same bar, Adam at rtol 1e-6
    (one f32 expression, another rounding of the lr product)."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    cpu = {c[0]: c[2] for c in _cases("cpu")}
    gpu = {c[0]: c[2] for c in _cases("cuda")}
    mods = (fa, ge, ln, ma)
    for m in mods:
        m.reset_kernel_launches()
    for name, op, _ in _cases("cuda"):
        if name == "multi_tensor_adam":
            continue
        got, want = op(*gpu[name]), op(*cpu[name])
        for g, w in zip(got, want):
            if w.numel():
                torch.testing.assert_close(g.cpu(), w, rtol=2e-3, atol=2e-4)
    ps, gs, m1, m2, lrs, b1, b2, e = gpu["multi_tensor_adam"]
    OPS.multi_tensor_adam(ps, gs, m1, m2, lrs, b1, b2, e)
    cps, cgs, cm1, cm2, clrs, _, _, _ = cpu["multi_tensor_adam"]
    OPS.multi_tensor_adam(cps, cgs, cm1, cm2, clrs, b1, b2, e)
    for g, w in zip(ps + m1 + m2, cps + cm1 + cm2):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-6, atol=1e-7)
    launches = {}
    for m in mods:
        launches.update(m.kernel_launches())
    assert launches["flash_fwd"] == 1 and launches["flash_fwd_causal"] == 1, launches
    assert launches["flash_bwd_fused"] == 1, launches
    assert launches["gemm_epilogue"] == 2 and launches["multi_adam"] == 1, launches
    assert launches["layer_norm"] == 2 and launches["layer_norm_grad"] == 1, launches
