"""bf16 training and fp8_matmul on the card (every test is marked `cuda` and
skips without a CUDA device; the file imports no JAX, so on the card it
runs with `python -m pytest --noconftest tests/test_torch_bf16_cuda.py -m
cuda`):

- fp8_matmul's kernels (the e4m3 cast pass and the e4m3 GEMM of
  csrc/quant_gemm.cu) against the plain version at ragged and batched
  shapes (m 1 to 1024, k 1 to 4096 with k % 16 != 0, n 1 to 2064, a
  batched (16 x 8) 256 x 64 @ 64 x 256, an operand broadcast over the
  batch), f32 and bf16 operands, values past e4m3's 448: NaN where the plain
  version has NaN, f32 within rtol 1e-5 of max |out|, bf16 within one bf16
  ulp (or that f32 bar where it is larger); the cast pass's bytes equal the
  plain rounding's; every call repeated bit for bit;
- a Bf16Transpiler'd Transformer (small widths) captured as one CUDA graph:
  3 steps on the graph path against 3 op by op, losses bit for bit, the
  same launches a step, no op-by-op block; then with FLAGS_fp8_matmul its
  products launch the fp8 kernels (graph against op by op again).
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
    assert after["quant_gemm_fp8"] - before["quant_gemm_fp8"] == 2
    assert after["e4m3_cast"] - before["e4m3_cast"] == 4
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_e4m3_cast_pass_matches_plain_rounding(cuda_device, dtype):
    """The cast pass's bytes, widened, equal e4m3_round_plain bit for bit
    (NaN as NaN), over values across e4m3's range, its subnormals and past
    448, with the zero padding in place."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    t = (torch.randn(3, 37, 45, device="cuda", generator=gen)
         * torch.logspace(-4, 3, 45, device="cuda")).to(dtype)
    t[0, 0, :6] = torch.tensor([464.0, 464.01, -448.5, float("inf"), float("nan"), -0.0])
    staged = quant_gemm._stage_e4m3(t, 40, 48)
    torch.cuda.synchronize()
    got = staged.view(torch.float8_e4m3fn).float()
    want = quant_gemm.e4m3_round_plain(t)
    assert (staged[:, 37:, :] == 0).all() and (staged[:, :, 45:] == 0).all()
    body = got[:, :37, :45]
    assert torch.equal(torch.isnan(body), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.equal(body[ok].view(torch.int32), want[ok].view(torch.int32))


def _op_by_op():
    from paddle_tpu_torch import profiler

    @contextlib.contextmanager
    def ctx():
        flags.set_flags({"profile_ops": True})
        try:
            with contextlib.redirect_stdout(io.StringIO()), profiler.profiler():
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
        assert (d.get(("launches", "quant_gemm_fp8"), 0) > 0) == fp8, d
