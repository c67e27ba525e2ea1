"""fp8_matmul's gradient and the arithmetic of its CUDA forms (csrc/fp8_gemm.cu),
on the CPU, held against jax.vjp of the JAX package's fp8_matmul:

- an operand broadcast over the batch gets its gradient summed over the
  batch in f32 and rounded to e4m3 once, as jax.vjp gives it (y broadcast
  over x's batch, x over y's), bit for bit;
- bf16 operands and g: both gradients bit for bit;
- a plain-torch emulation of the forms' arithmetic (operands rounded to
  e4m3 by the integer twin of the rule and widened to bf16; the
  reduction in 64-deep stages, each summed exactly and added to an f32
  accumulator, over batch x rows for a broadcast operand; the gradients'
  e4m3 epilogue) at the bf16 Transformer's product shapes scaled down and
  at the edges (k % 16 != 0, n = 37, values past 448, broadcasts): the
  forward within rtol 1e-5 of max |out| in f32 (one bf16 ulp in bf16), the
  gradients within one e4m3 ulp with at least 99.9 % of the values equal,
  NaN where JAX gives NaN;
- the rule's integer twin (quant_gemm.e4m3_round_twin) bit for bit with
  e4m3_round_plain over all 65536 bf16 patterns and f32 ties, subnormals
  and +-464.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import pallas_kernels as jpk
from paddle_tpu_torch.ops import quant_gemm

FP8_RTOL = 1e-5  # of max |out|: the same e4m3 values, f32 sums in another order
GRAD_EQUAL = 0.999  # share of gradient values equal to JAX's
STAGE = 64  # reduction values a stage of fp8_gemm.cu


def _data(shape, rng, scale):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _as(a, dtype):
    """(numpy for the JAX function, torch tensor) of `a` in `dtype`."""
    if dtype == "bfloat16":
        a = a.astype(ml_dtypes.bfloat16)
        return a, torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return a, torch.from_numpy(a)


def _jax_vjp(x, y, g):
    """(out, dx, dy) of jax.vjp of the JAX function, as f32 numpy."""
    out, vjp = jax.vjp(jpk.fp8_matmul, jnp.asarray(x), jnp.asarray(y))
    dx, dy = vjp(jnp.asarray(g))
    return tuple(np.asarray(v.astype(jnp.float32)) for v in (out, dx, dy))


def _port_grads(xt, yt, gt):
    xt, yt = xt.clone().requires_grad_(), yt.clone().requires_grad_()
    out = quant_gemm.fp8_matmul(xt, yt)
    out.backward(gt)
    return out, xt.grad, yt.grad


def _f32(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# the broadcast gradient and bf16 gradients against jax.vjp
# ---------------------------------------------------------------------------

BROADCAST = {
    "y_over_x_batch": ((4, 6, 20), (20, 5)),
    "x_over_y_batch": ((6, 20), (4, 20, 5)),
    "both_batched": ((4, 6, 20), (4, 20, 5)),
}


@pytest.mark.parametrize("case", sorted(BROADCAST))
def test_fp8_broadcast_grad_matches_jax(case):
    """x (4, 6, 20) @ y (20, 5) (seed 3, scale 2) and its mirror: dy of a y
    shared by x's batch is e4m3(sum over the batch of x8^T g), one rounding
    after the f32 sum, as jax.vjp gives it; dx likewise for a shared x."""
    xs, ys = BROADCAST[case]
    rng = np.random.RandomState(3)
    x, y = _data(xs, rng, 2.0), _data(ys, rng, 2.0)
    batch = np.broadcast_shapes(xs[:-2], ys[:-2])
    g = _data(batch + (xs[-2], ys[-1]), rng, 2.0)
    _, jdx, jdy = _jax_vjp(x, y, g)
    _, dx, dy = _port_grads(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(g))
    np.testing.assert_array_equal(_f32(dx), jdx)
    np.testing.assert_array_equal(_f32(dy), jdy)


@pytest.mark.parametrize("shapes", [((6, 20), (20, 5)), ((3, 9, 40), (40, 11)),
                                    ((2, 3, 16, 24), (2, 3, 24, 8))],
                         ids=["2d", "broadcast_y", "batched"])
def test_fp8_bf16_grads_match_jax(shapes):
    """bf16 x, y and g: dx and dy, in bf16, bit for bit with jax.vjp."""
    xs, ys = shapes
    rng = np.random.RandomState(11)
    x, y = _data(xs, rng, 3.0), _data(ys, rng, 3.0)
    batch = np.broadcast_shapes(xs[:-2], ys[:-2])
    g = _data(batch + (xs[-2], ys[-1]), rng, 3.0)
    (xj, xt), (yj, yt), (gj, gt) = (_as(a, "bfloat16") for a in (x, y, g))
    jout, jdx, jdy = _jax_vjp(xj, yj, gj)
    out, dx, dy = _port_grads(xt, yt, gt)
    assert out.dtype == dx.dtype == dy.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(out), jout)
    np.testing.assert_array_equal(_f32(dx), jdx)
    np.testing.assert_array_equal(_f32(dy), jdy)


# ---------------------------------------------------------------------------
# an emulation of fp8_gemm.cu's arithmetic
# ---------------------------------------------------------------------------


def _widened(v, dtype16):
    """e4m3 values (f32) as the 16-bit type the kernel's tiles hold: exact."""
    w = v.to(dtype16).float()
    fin = torch.isfinite(v)
    assert torch.equal(w[fin], v[fin])
    return w


def _staged_sum(a, b):
    """sum over r of a[r] @ b[r] (lists of [rows, red] and [red, cols] f32
    matrices, the reduced batch): 64-deep stages in order, each summed
    exactly and rounded to f32, each added to an f32 accumulator."""
    acc = torch.zeros(a[0].shape[0], b[0].shape[1], dtype=torch.float32)
    for am, bm in zip(a, b):
        for s in range(0, am.shape[1], STAGE):
            part = (am[:, s:s + STAGE].double() @ bm[s:s + STAGE].double()).float()
            acc = acc + part
    return acc


def _matrices(t, batch):
    """t as a list over the broadcast batch (a shared operand repeated)."""
    t = t.expand(tuple(batch) + tuple(t.shape[-2:]))
    return list(t.reshape((-1,) + tuple(t.shape[-2:])))


def emulate_forms(x, y, g):
    """(out, dx, dy) as fp8_gemm.cu computes them, on e4m3 values widened to
    bf16 (g as it is): the forward in x's dtype; dx = e4m3(g @ y8^T) and
    dy = e4m3(x8^T @ g), each reduced over batch x its rows where its
    operand is shared by the batch."""
    twin = quant_gemm.e4m3_round_twin
    batch = torch.broadcast_shapes(tuple(x.shape[:-2]), tuple(y.shape[:-2]))
    x8, y8 = _widened(twin(x), torch.bfloat16), _widened(twin(y), torch.bfloat16)
    xs, ys = _matrices(x8, batch), _matrices(y8, batch)
    out = torch.stack([_staged_sum([a], [b]) for a, b in zip(xs, ys)])
    out = out.reshape(tuple(batch) + out.shape[-2:]).to(x.dtype)
    gs = list(g.float().reshape((-1,) + tuple(g.shape[-2:])))

    def grad(pairs, shared, shape, dtype):
        if shared:
            r = twin(_staged_sum([p[0] for p in pairs], [p[1] for p in pairs]))
        else:
            r = torch.stack([twin(_staged_sum([a], [b])) for a, b in pairs])
        return r.reshape(shape).to(dtype)

    x_shared = x.dim() == 2 or int(np.prod(x.shape[:-2])) == 1
    y_shared = y.dim() == 2 or int(np.prod(y.shape[:-2])) == 1
    many = len(gs) > 1
    dx = grad([(gm, ym.t()) for gm, ym in zip(gs, ys)], x_shared and many, x.shape, x.dtype)
    dy = grad([(xm.t(), gm) for xm, gm in zip(xs, gs)], y_shared and many, y.shape, y.dtype)
    return out, dx, dy


def _e4m3_ulp(v):
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -6)))
    return 2.0 ** (e - 3)


def _assert_grad_close(got, want, name):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=name)
    ok = ~np.isnan(want)
    err = np.abs(got[ok] - want[ok])
    ulp = _e4m3_ulp(np.maximum(np.abs(got[ok]), np.abs(want[ok])))
    assert (err <= ulp).all(), (name, err.max())
    assert (err == 0).mean() >= GRAD_EQUAL, (name, (err == 0).mean())


# the bf16 Transformer's products (the projections, q k^T and p v over
# heads, the FFN products, the vocab projection) at a quarter of their rows
# and width, and the edges
EMULATED = {
    "proj": ((256, 128), (128, 128)),
    "qk": ((2, 2, 64, 16), (2, 2, 16, 64)),
    "pv": ((2, 2, 64, 64), (2, 2, 64, 16)),
    "ffn1": ((256, 128), (128, 512)),
    "ffn2": ((256, 512), (512, 128)),
    "vocab": ((256, 128), (128, 37)),
    "ragged_k": ((17, 100), (100, 37)),
    "one_row": ((1, 300), (300, 7)),
    "broadcast_y": ((3, 9, 70), (70, 11)),
    "broadcast_x": ((9, 70), (3, 70, 11)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(EMULATED))
def test_fp8_forms_emulation_matches_jax(case, dtype):
    xs, ys = EMULATED[case]
    rng = np.random.RandomState(23)
    x, y = _data(xs, rng, 40.0), _data(ys, rng, 40.0)
    # values past 448 (NaN rows and columns where the operand keeps others
    # finite) and one that rounds to 448
    if xs[-2] > 1:
        x[..., 0, 0] = 500.0
    if ys[-1] > 1:
        y[..., -1, -1] = -1e4
    y.reshape(-1)[3] = 463.0
    batch = np.broadcast_shapes(xs[:-2], ys[:-2])
    g = _data(batch + (xs[-2], ys[-1]), rng, 4.0)
    (xj, xt), (yj, yt) = _as(x, dtype), _as(y, dtype)
    gj, gt = _as(g, dtype)
    jout, jdx, jdy = _jax_vjp(xj, yj, gj)
    out, dx, dy = emulate_forms(xt, yt, gt)
    assert out.dtype == dx.dtype == dy.dtype == xt.dtype
    got = _f32(out)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(jout))
    ok = ~np.isnan(jout)
    scale = np.abs(jout[ok]).max()
    if dtype == "float32":
        np.testing.assert_allclose(got[ok], jout[ok], rtol=0, atol=FP8_RTOL * scale)
    else:
        np.testing.assert_allclose(got[ok], jout[ok], rtol=2 ** -8, atol=FP8_RTOL * scale)
    _assert_grad_close(_f32(dx), jdx, "dx")
    _assert_grad_close(_f32(dy), jdy, "dy")


# ---------------------------------------------------------------------------
# the rounding rule's integer twin
# ---------------------------------------------------------------------------


def _same_bits(got, want):
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))


def test_e4m3_twin_every_bf16_pattern():
    t = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    _same_bits(quant_gemm.e4m3_round_twin(t), quant_gemm.e4m3_round_plain(t))


def test_e4m3_twin_f32_ties_subnormals_and_464():
    codes = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn).astype(np.float32)
    fin = np.sort(codes[np.isfinite(codes)])
    mids = (fin[1:] + fin[:-1]) / 2  # ties, to even
    sub = np.arange(-64, 65, dtype=np.float32) * 2.0 ** -12  # across e4m3's subnormals
    vals = np.concatenate([
        fin, mids, np.nextafter(mids, np.inf, dtype=np.float32),
        np.nextafter(mids, -np.inf, dtype=np.float32), sub,
        np.array([464.0, -464.0, 464.00003, -464.00003, 463.99997, 448.0, 480.0, np.inf,
                  -np.inf, np.nan, 0.0, -0.0, 1e-45, -1e-40, 2.0 ** -6, 2.0 ** -7,
                  2.0 ** -10, 3 * 2.0 ** -11, 1e30], np.float32),
        np.random.RandomState(5).randn(8192).astype(np.float32) * 200,
    ])
    t = torch.from_numpy(vals)
    _same_bits(quant_gemm.e4m3_round_twin(t), quant_gemm.e4m3_round_plain(t))
