"""The hand kernels as torch.library ops (namespace paddle_tpu_torch): each
op's schema, its fake against its CPU implementation, and the tensors it
declares it mutates, by torch.library.opcheck on CPU tensors at small
shapes; each wrapper's result against its plain version, bit for bit (the
CPU implementation is the plain version); every op's fake over fake CUDA
tensors (what a trace on the card sees); and, on the card, each op
launching its kernel, its output's shape, dtype and strides those of its
fake (the `cuda`-marked case). The ops: flash forward / backward, the GEMM
epilogue, layer_norm forward / backward, multi-tensor Adam, paged flash
attention (both table forms, f32 and int8 pools), the quant GEMM (int8 and
e4m3), fp8_matmul, its gradients and the e4m3 rounding."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import gemm_epilogue as ge
from paddle_tpu_torch.ops import layer_norm as ln
from paddle_tpu_torch.ops import multi_adam as ma
from paddle_tpu_torch.ops import paged_flash as pf
from paddle_tpu_torch.ops import quant_gemm as qg

OPS = torch.ops.paddle_tpu_torch


def _t(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _paged(rng, dev, shared, quant, n_head=2, d=16, ps=4, n_pages=6, rows=3):
    """Arguments of the paged op: a pool of (rows * n_pages + 1) pages, page
    0 the scratch page; a shared table of n_pages, or one a row; positions
    with an idle row (pos < 0) and one at the table's last position."""
    feat = n_head * d
    pool_rows = (rows * n_pages + 1) * ps
    q = _t(rng, rows, feat)
    if quant:
        kp, vp = (torch.from_numpy(rng.integers(-127, 128, (pool_rows, feat)).astype(np.int8))
                  for _ in range(2))
        ks, vs = (torch.from_numpy(rng.uniform(0.01, 0.1, pool_rows).astype(np.float32))
                  for _ in range(2))
    else:
        kp, vp = _t(rng, pool_rows, feat), _t(rng, pool_rows, feat)
        ks = vs = None
    pages = rng.permutation(np.arange(1, rows * n_pages + 1)).astype(np.int32)
    bt = pages[:n_pages] if shared else pages.reshape(rows, n_pages)
    pos = np.array([n_pages * ps - 1] + [-1] + [ps + 1] * (rows - 2), np.int32)
    args = [q, kp, vp, torch.from_numpy(bt), torch.from_numpy(pos)]
    return tuple(a.to(dev) for a in args) + (n_head, ps, 0.0) + tuple(
        None if t is None else t.to(dev) for t in (ks, vs))


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
    xi, wi = (torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(dev)
              for shape in ((16, 32), (32, 48)))
    x8, w8 = (_t(rng, *shape).to(torch.float8_e4m3fn).to(dev) for shape in ((16, 32), (32, 48)))
    qs, qb = torch.tensor(0.02, device=dev), _t(rng, 48).to(dev)
    fx, fy, fg = _t(rng, 2, 16, 32).to(dev), _t(rng, 32, 24).to(dev), _t(rng, 2, 16, 24).to(dev)
    bx, by, bg = (t.to(torch.bfloat16) for t in (fx, fy, fg))
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
        ("paged_decode", OPS.paged_flash_attention, _paged(rng, dev, False, False)),
        ("paged_shared", OPS.paged_flash_attention, _paged(rng, dev, True, False)),
        ("paged_decode_int8", OPS.paged_flash_attention, _paged(rng, dev, False, True)),
        ("paged_shared_int8", OPS.paged_flash_attention, _paged(rng, dev, True, True)),
        # a 130-page table, heads of 160 (the wide kernel on the card)
        ("paged_wide_table", OPS.paged_flash_attention,
         _paged(rng, dev, False, False, n_head=1, d=160, ps=2, n_pages=130, rows=2)),
        ("quant_gemm_int8_relu", OPS.quant_gemm_bias_act, (xi, wi, qs, qb, "relu")),
        ("quant_gemm_int8_no_act", OPS.quant_gemm_bias_act, (xi, wi, qs, None, None)),
        ("quant_gemm_e4m3", OPS.quant_gemm_bias_act, (x8, w8, qs, qb, "gelu")),
        ("fp8_matmul_f32", OPS.fp8_matmul, (fx[0] * 40.0, fy)),
        ("fp8_matmul_bf16", OPS.fp8_matmul, (bx[0], by)),
        ("fp8_matmul_broadcast", OPS.fp8_matmul, (fx, fy)),
        ("fp8_matmul_grads", OPS.fp8_matmul_grads, (fx, fy, fg, True, True)),
        ("fp8_matmul_grads_dx", OPS.fp8_matmul_grads, (fx, fy, fg, True, False)),
        ("fp8_matmul_grads_dy", OPS.fp8_matmul_grads, (fx, fy, fg, False, True)),
        ("fp8_matmul_grads_none", OPS.fp8_matmul_grads, (fx, fy, fg, False, False)),
        ("fp8_matmul_grads_bf16", OPS.fp8_matmul_grads, (bx, by, bg, True, True)),
        ("e4m3_round", OPS.e4m3_round, (fx * 100.0,)),
    ]


CASE_IDS = [c[0] for c in _cases("cpu")]


@pytest.mark.parametrize("name", CASE_IDS)
def test_op_passes_opcheck_on_cpu(name):
    """schema, fake against real (shapes, dtypes, strides), the declared
    mutations (multi_tensor_adam's params and moments, nothing else), and
    the op under torch.compile's AOT dispatcher."""
    (_, op, args), = [c for c in _cases("cpu") if c[0] == name]
    utils = OPCHECK_UTILS
    if name in NO_SCHEMA_MODE:
        utils = tuple(u for u in utils if u != "test_schema")
    torch.library.opcheck(op, args, test_utils=utils)


# opcheck's default tests
OPCHECK_UTILS = ("test_schema", "test_autograd_registration", "test_faketensor",
                 "test_aot_dispatch_dynamic")
# SchemaCheckMode compares each input before and after by a multiply, which
# torch has no float8 kernel for: the e4m3 case runs opcheck's other tests,
# and the op's one schema is held by its int8 cases
NO_SCHEMA_MODE = ("quant_gemm_e4m3",)


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
    for name in ("paged_decode", "paged_shared", "paged_decode_int8", "paged_shared_int8",
                 "paged_wide_table"):
        q, kp, vp, bt, pos, n_head, page, scale, ks, vs = cases[name]
        kw = dict(n_head=n_head, page_size=page, sm_scale=scale, k_scales=ks, v_scales=vs)
        assert torch.equal(pf.paged_flash_attention(q, kp, vp, bt, pos, **kw),
                           pf.paged_attention_plain(q, kp, vp, bt, pos, **kw)), name
    for name in ("quant_gemm_int8_relu", "quant_gemm_e4m3"):
        x2, w2, scale, bias, _ = cases[name]
        for b in (None, bias):
            for act in (None, "relu", "gelu", "tanh", "sigmoid"):
                got = qg.quant_gemm_bias_act(x2, w2, scale, b, act)
                want = qg.quant_gemm_bias_act_plain(x2, w2, scale, b, act)
                assert torch.equal(got[0], want[0])
                assert (got[1] is None) == (want[1] is None) == (act is None)
                if act:
                    assert torch.equal(got[1], want[1])
    for name in ("fp8_matmul_f32", "fp8_matmul_bf16", "fp8_matmul_broadcast"):
        x, y = cases[name]
        assert torch.equal(qg.fp8_matmul(x, y), qg.fp8_matmul_plain(x, y)), name
    for name in ("fp8_matmul_grads", "fp8_matmul_grads_bf16"):
        x, y, g, _, _ = cases[name]
        xr, yr = x.clone().requires_grad_(), y.clone().requires_grad_()
        qg.fp8_matmul(xr, yr).backward(g)
        dx, dy = qg.fp8_matmul_grads_plain(x, y, g)
        assert torch.equal(xr.grad, dx) and torch.equal(yr.grad, dy), name
    (t,) = cases["e4m3_round"]
    for dt in (torch.float32, torch.bfloat16):
        got, want = qg.e4m3_round(t.to(dt)), qg.e4m3_round_plain(t.to(dt)).to(dt)
        assert got.dtype == dt and torch.equal(got, want)


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


def test_trace_over_card_tensors_takes_every_op_from_its_fake():
    """Over fake CUDA tensors (what torch.export traces on the card), every
    wrapper reaches its op and takes its shapes and dtypes from the op's
    fake: no kernel is launched outside an op, so a trace that reaches one
    records an op node."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cuda = dict(device="cuda")
    with FakeTensorMode(allow_non_fake_inputs=True):
        q = torch.empty(2, 4, 16, 64, **cuda)
        out, lse = fa.flash_forward(q, q, q, True, 0.125)
        assert out.shape == q.shape and lse.shape == (2, 4, 16) and lse.device == q.device
        x = torch.empty(32, 128, **cuda)
        z, y = ge.gemm_bias_act(x, torch.empty(128, 256, **cuda), torch.empty(256, **cuda),
                                "relu")
        assert z.shape == y.shape == (32, 256)
        for dt in (torch.int8, torch.float8_e4m3fn):
            xi = torch.empty(32, 128, dtype=dt, **cuda)
            wi = torch.empty(128, 64, dtype=dt, **cuda)
            for act in (None, "relu"):
                z, y = qg.quant_gemm_bias_act(xi, wi, torch.empty((), **cuda),
                                              torch.empty(64, **cuda), act)
                assert z.shape == (32, 64) and z.dtype == torch.float32 and z.is_cuda
                assert (y is None) == (act is None)
                assert y is None or (y.shape == z.shape and y.dtype == torch.float32)
        for dt in (torch.float32, torch.bfloat16):
            xb = torch.empty(3, 32, 128, dtype=dt, **cuda)
            yb = torch.empty(128, 48, dtype=dt, **cuda)
            o = qg.fp8_matmul(xb, yb)
            assert o.shape == (3, 32, 48) and o.dtype == dt and o.is_cuda
            dx, dy = OPS.fp8_matmul_grads(xb, yb, torch.empty(3, 32, 48, dtype=dt, **cuda),
                                          True, True)
            assert dx.shape == xb.shape and dy.shape == yb.shape and dx.dtype == dt
            r = qg.e4m3_round(xb)
            assert r.shape == xb.shape and r.dtype == dt and r.is_cuda
        for quant in (False, True):
            pool = torch.empty(4 * 8, 64, dtype=torch.int8 if quant else torch.float32, **cuda)
            sc = torch.empty(4 * 8, **cuda) if quant else None
            for table in ((3, 4), (4,)):
                o = pf.paged_flash_attention(torch.empty(3, 64, **cuda), pool, pool,
                                             torch.empty(*table, dtype=torch.int32, **cuda),
                                             torch.empty(3, dtype=torch.int32, **cuda),
                                             n_head=2, page_size=8, k_scales=sc, v_scales=sc)
                assert o.shape == (3, 64) and o.dtype == torch.float32 and o.is_cuda


# cases held on the card at another bar than _CARD_TOL: the bf16 forward
# within one bf16 ulp (2^-8), the e4m3 gradients within one e4m3 ulp (2^-3
# of the value, atol the smallest subnormal 2^-9), the rounding and the
# int8 forms bit for bit
_CARD_TOL = (2e-3, 2e-4)
_CARD_TOLS = {"fp8_matmul_bf16": (2 ** -8, 1e-3), "e4m3_round": (0.0, 0.0),
              "quant_gemm_int8_relu": (0.0, 0.0), "quant_gemm_int8_no_act": (0.0, 0.0)}
_E4M3_ULP = (0.125, 2 ** -9)


@pytest.mark.cuda
def test_ops_launch_their_kernels_on_the_card():
    """Each op on CUDA tensors launches its kernel (the launch counters live
    in the ops' CUDA implementations), returns the shape, dtype and strides
    its fake gives, and agrees with its plain version: flash and
    layer_norm at rtol 2e-3 / atol 2e-4 (3xTF32 sums and another summation
    order), the GEMMs, the paged kernels and the f32 fp8 forward at the
    same bar, the int8 quant GEMM and the rounding bit for bit, the bf16
    fp8 forward within one bf16 ulp, the fp8 gradients within one e4m3 ulp
    (f32 sums in another order may round across an e4m3 step), Adam at
    rtol 1e-6 (one f32 expression, another rounding of the lr product)."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    from torch._subclasses.fake_tensor import FakeTensorMode

    cpu = {c[0]: c[2] for c in _cases("cpu")}
    gpu = {c[0]: c[2] for c in _cases("cuda")}
    mods = (fa, ge, ln, ma, pf, qg)
    for m in mods:
        m.reset_kernel_launches()
    for name, op, _ in _cases("cuda"):
        if name == "multi_tensor_adam":
            continue
        got, want = op(*gpu[name]), op(*cpu[name])
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                        for a in gpu[name]))
        if isinstance(want, torch.Tensor):
            got, want, fake = (got,), (want,), (fake,)
        rtol, atol = (_E4M3_ULP if name.startswith("fp8_matmul_grads")
                      else _CARD_TOLS.get(name, _CARD_TOL))
        for g, w, f in zip(got, want, fake):
            assert (g.shape, g.dtype, g.stride(), g.device) == (
                f.shape, f.dtype, f.stride(), f.device), name
            if w.numel():
                torch.testing.assert_close(g.cpu().float(), w.float(), rtol=rtol, atol=atol,
                                           equal_nan=True, msg=name)
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
    for key in ("paged_flash", "paged_flash_shared", "paged_flash_int8",
                "paged_flash_shared_int8", "paged_flash_wide"):
        assert launches[key] == 1, (key, launches)
    assert launches["quant_gemm_int8"] == 2 and launches["quant_gemm_fp8"] == 1, launches
    # the f32 gradients: library products, each rounding one e4m3_round
    # launch (y, dx, x, dy); the bf16 pair: one dx and one dy launch
    assert launches["fp8_matmul"] == 3 and launches["e4m3_round"] == 1 + 4 + 2 + 2, launches
    assert launches["fp8_matmul_dx"] == 1 and launches["fp8_matmul_dy"] == 1, launches
