"""bf16 training and fp8_matmul on the card (every test is marked `cuda` and
skips without a CUDA device; the file imports no JAX, so on the card it
runs with `python -m pytest --noconftest tests/test_torch_bf16_cuda.py -m
cuda`):

- fp8_matmul's kernels (csrc/fp8_gemm.cu: the forward, one launch a call,
  and the dx and dy forms for bf16 operands; f32 grads take library
  products rounded by its e4m3_round_kernel) against the plain versions at
  ragged and batched shapes (m 1 to 1024, k 1 to 4096 with k % 16 != 0, n
  1 to 2064, a batched (16 x 8) 256 x 64 @ 64 x 256, an operand broadcast
  over the batch, either one), f32 and bf16 operands, values past e4m3's
  448: NaN where the plain version has NaN; the forward f32 within rtol
  1e-5 of max |out|, bf16 within one bf16 ulp (or that f32 bar where it is
  larger); the grads within one e4m3 ulp plus that f32 bar, at least
  99.9 % equal; the
  rounding kernel equal to the plain rounding; every call repeated bit for
  bit, the launch counters moving;
- a Bf16Transpiler'd Transformer (small widths) captured as one CUDA graph:
  3 steps on the graph path against 3 op by op, losses bit for bit, the
  same launches a step, no op-by-op block; then with FLAGS_fp8_matmul its
  products launch the fp8 kernels (graph against op by op again), also
  with every plain fp8 version patched to raise: none runs on the card.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import flags
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.ops import fused, quant_gemm
from paddle_tpu_torch.tools import profile_recsys as recsys
from paddle_tpu_torch.tools import profile_training as prof

FP8_RTOL = 1e-5  # of max |out|: the same e4m3 values, f32 sums in another order
FP8_GRAD_EQUAL = 0.999  # share of gradient values equal to the plain backward's
SMALL = dict(n_layer=1, n_head=2, d_model=128, d_inner=256, d_key=64, d_value=64,
             vocab=96, batch=4, t=32, dropout=0.0)
FP8_SHAPES = [
    ((1, 1), (1, 1)),
    ((1, 4096), (4096, 16)),
    ((17, 37), (37, 5)),
    ((250, 48), (48, 2064)),
    ((1024, 4095), (4095, 33)),
    ((1000, 512), (512, 2064)),
    ((16, 8, 256, 64), (16, 8, 64, 256)),
    ((3, 100, 20), (20, 130)),
    ((4, 6, 20), (20, 5)),
    ((100, 20), (3, 20, 130)),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the hand-written kernels")
    return torch.device("cuda", 0)


def bf16_ulp(t):
    """One bf16 ulp at each value of t (f32): 2^(exponent - 7)."""
    a = t.abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def check_fp8(x, y):
    """fp8_matmul's kernels against fp8_matmul_plain on the same operands;
    returns the max abs error over the finite outputs."""
    before = quant_gemm.kernel_launches()
    got = quant_gemm.fp8_matmul(x, y)
    again = quant_gemm.fp8_matmul(x, y)
    after = quant_gemm.kernel_launches()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == \
        {"fp8_matmul": 2}
    want = quant_gemm.fp8_matmul_plain(x, y)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.int16) if got.dtype == torch.bfloat16 else got.view(
        torch.int32), again.view(torch.int16) if got.dtype == torch.bfloat16 else again.view(
        torch.int32))
    g, w = got.float(), want.float()
    assert torch.equal(torch.isnan(g), torch.isnan(w))
    ok = ~torch.isnan(w)
    err = (g - w)[ok].abs()
    bar = FP8_RTOL * w[ok].abs().max()
    if x.dtype == torch.bfloat16:
        bar = torch.maximum(bf16_ulp(w[ok]), bar)
    assert (err <= bar).all(), (err.max().item(), x.shape, y.shape, x.dtype)
    return err.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes", FP8_SHAPES, ids=lambda s: "x".join(map(str, s[0] + s[1])))
def test_fp8_matmul_kernel_matches_plain(cuda_device, shapes, dtype):
    gen = torch.Generator(device="cuda").manual_seed(0)
    xs, ys = shapes
    x = torch.randn(xs, device="cuda", generator=gen) * 40
    y = torch.randn(ys, device="cuda", generator=gen) * 40
    if xs[-2] > 1:
        x[..., 0, 0] = 500.0  # past 448: a NaN row
    if ys[-1] > 1:
        y[..., -1, -1] = -1e4  # a NaN column
    check_fp8(x.to(dtype), y.to(dtype))


def e4m3_ulp(t):
    """One e4m3 ulp at each value of t (f32): 2^(exponent - 3), 2^-9 among
    the subnormals."""
    return torch.exp2(torch.floor(torch.log2(t.abs().clamp(min=2.0 ** -6))) - 3)


def check_fp8_grads(x, y):
    """fp8_matmul's gradient kernels against fp8_matmul_grads_plain on a
    seeded g (operands ~ 40 N(0, 1)): NaN where the plain version has NaN,
    within one e4m3 ulp plus FP8_RTOL of max |out|, at least
    FP8_GRAD_EQUAL equal, repeated bit for bit. Returns the launches a
    backward made."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    batch = torch.broadcast_shapes(tuple(x.shape[:-2]), tuple(y.shape[:-2]))
    # the grads about 64 for operands ~ 40 N(0, 1): inside e4m3's range
    red = max(x.shape[-2], y.shape[-1]) * max(1, int(np.prod(batch)))
    g = (torch.randn(tuple(batch) + (x.shape[-2], y.shape[-1]), device="cuda", generator=gen)
         * (64.0 / (40.0 * red ** 0.5))).to(x.dtype)
    xr, yr = x.detach().requires_grad_(), y.detach().requires_grad_()
    out = quant_gemm.fp8_matmul(xr, yr)
    before = quant_gemm.kernel_launches()
    got = torch.autograd.grad(out, (xr, yr), g, retain_graph=True)
    after = quant_gemm.kernel_launches()
    again = torch.autograd.grad(out, (xr, yr), g)
    want = quant_gemm.fp8_matmul_grads_plain(x, y, g)
    torch.cuda.synchronize()
    for a, b, w, t in zip(got, again, want, (x, y)):
        bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        assert a.dtype == t.dtype and a.shape == t.shape
        assert torch.equal(a.view(bits), b.view(bits))
        a32, w32 = a.float(), w.float()
        assert torch.equal(torch.isnan(a32), torch.isnan(w32))
        ok = ~torch.isnan(w32)
        err = (a32 - w32)[ok].abs()
        # one ulp where the two f32 sums straddle a rounding boundary, plus
        # the forward's bar on those sums (a sum that cancels keeps them)
        bar = (e4m3_ulp(torch.maximum(a32[ok].abs(), w32[ok].abs()))
               + FP8_RTOL * w32[ok].abs().max())
        assert (err <= bar).all()
        assert (err == 0).float().mean() >= FP8_GRAD_EQUAL
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes", FP8_SHAPES, ids=lambda s: "x".join(map(str, s[0] + s[1])))
def test_fp8_matmul_grad_kernels_match_plain(cuda_device, shapes, dtype):
    """bf16: one dx and one dy launch a backward (a partly broadcast operand
    would take the library path); f32: the library products, the rounding
    kernel's launches."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    xs, ys = shapes
    x = torch.randn(xs, device="cuda", generator=gen) * 40
    y = torch.randn(ys, device="cuda", generator=gen) * 40
    if xs[-2] > 1:
        x[..., 0, 0] = 500.0
    if ys[-1] > 1:
        y[..., -1, -1] = -1e4
    moved = check_fp8_grads(x.to(dtype), y.to(dtype))
    if dtype == torch.bfloat16:
        assert moved == {"fp8_matmul_dx": 1, "fp8_matmul_dy": 1}, moved
    else:
        assert moved == {"e4m3_round": 4}, moved


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_e4m3_cast_pass_matches_plain_rounding(cuda_device, dtype):
    """The rounding kernel (fp8_gemm.cu's e4m3_round_kernel, the f32 grads'
    pass) equals e4m3_round_plain bit for bit (NaN as NaN), over values
    across e4m3's range, its subnormals and past 448, in t's dtype."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    t = (torch.randn(3, 37, 45, device="cuda", generator=gen)
         * torch.logspace(-4, 3, 45, device="cuda")).to(dtype)
    t[0, 0, :6] = torch.tensor([464.0, 464.01, -448.5, float("inf"), float("nan"), -0.0])
    before = quant_gemm.kernel_launches()["e4m3_round"]
    got = quant_gemm.e4m3_round(t)
    assert quant_gemm.kernel_launches()["e4m3_round"] == before + 1
    want = quant_gemm.e4m3_round_plain(t)
    torch.cuda.synchronize()
    assert got.dtype == t.dtype and got.shape == t.shape
    got = got.float()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.equal(got[ok].view(torch.int32), want[ok].view(torch.int32))


def _op_by_op():
    from paddle_tpu_torch import profiler

    @contextlib.contextmanager
    def ctx():
        flags.set_flags({"profile_ops": True})
        try:
            with contextlib.redirect_stdout(io.StringIO()), profiler.profiler(profile_path=None):
                yield
        finally:
            flags.set_flags({"profile_ops": False})

    return ctx()


def _bf16_run(per_op, fp8=False, steps=3):
    main, startup, loss = prof.build(SMALL)
    flags.set_flags({"pass_pipeline": "training_fused", "fp8_matmul": fp8})
    fused.reset_stats()
    exe, scope = pt.Executor(pt.CUDAPlace(0)), pt.Scope(seed=0, place=pt.CUDAPlace(0))
    losses, deltas = [], []
    try:
        with pt.scope_guard(scope), (_op_by_op() if per_op else contextlib.nullcontext()):
            exe.run(startup)
            recsys.bf16_transpiled(main)
            for s in range(steps):
                before = fused.stats()
                (lv,) = exe.run(main, feed=prof.make_batch(SMALL, s), fetch_list=[loss.name])
                after = fused.stats()
                losses.append(lv.reshape(-1)[0])
                deltas.append({(kind, k): after[kind][k] - before[kind].get(k, 0)
                               for kind in ("launches", "dispatches") for k in after[kind]
                               if after[kind][k] != before[kind].get(k, 0)})
        runs = dict(pt.Executor.stats()["op_by_op"])
        graphs = sum(getattr(c, "graph", None) is not None for c in exe._cache.values())
        masters = {p.name: scope.vars[p.name].dtype
                   for p in main.global_block().all_parameters()}
    finally:
        flags.set_flags({"pass_pipeline": "", "fp8_matmul": False})
    return np.asarray(losses), deltas, runs, graphs, masters


@pytest.mark.cuda
@pytest.mark.parametrize("fp8", [False, True], ids=["bf16", "bf16_fp8"])
def test_transpiled_block_captures_as_one_graph(cuda_device, fp8):
    g_l, g_d, g_runs, graphs, masters = _bf16_run(False, fp8)
    e_l, e_d, _, _, _ = _bf16_run(True, fp8)
    assert np.isfinite(g_l).all()
    assert g_l.tobytes() == e_l.tobytes(), (g_l, e_l)
    assert g_d == e_d
    assert graphs == 1 and g_runs == {"creates_persistables": 1}, (graphs, g_runs)
    assert set(masters.values()) == {torch.float32}
    for d in g_d:
        assert d[("launches", "multi_adam")] == 1
        for form in ("fp8_matmul", "fp8_matmul_dx", "fp8_matmul_dy"):
            assert (d.get(("launches", form), 0) > 0) == fp8, d
        assert ("launches", "quant_gemm_fp8") not in d, d


@pytest.mark.cuda
def test_fp8_steps_run_no_plain_version(cuda_device, monkeypatch):
    """The fp8 steps, graph and op by op, with every plain fp8 version
    patched to raise: the card runs only the kernels."""

    def refuse(*a, **k):
        raise AssertionError("a plain fp8 version ran on the card")

    for name in ("e4m3_round_plain", "fp8_matmul_plain", "fp8_matmul_grads_plain"):
        monkeypatch.setattr(quant_gemm, name, refuse)
    g_l, g_d, _, graphs, _ = _bf16_run(False, True)
    e_l, _, _, _, _ = _bf16_run(True, True)
    assert np.isfinite(g_l).all() and g_l.tobytes() == e_l.tobytes()
    assert graphs == 1 and all(d.get(("launches", "fp8_matmul_dy"), 0) > 0 for d in g_d)
