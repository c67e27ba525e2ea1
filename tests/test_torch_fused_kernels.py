"""The training kernels of the torch port (paddle_tpu_torch/ops/
gemm_epilogue.py, layer_norm.py, multi_adam.py, fused.py):

- each plain torch version against the JAX package's Pallas kernel in
  interpret mode, on numpy inputs from a seed;
- the port's path predicates against the JAX ones over a grid of shapes,
  so that both packages send the same ops through the same families;
- on a CUDA card (`cuda` marker), each hand-written kernel against its
  plain version.

Tolerances, each with its reason:
- GEMM epilogue vs JAX: atol = rtol = 2e-5 (f32 both sides, k up to 256,
  sums in another order); kernel vs plain on the card: 1e-4 (k up to 2048);
- layer_norm forward: 1e-5 (f32 statistics, Welford vs two-pass); the
  kernel's statistics order, emulated in plain torch, 1e-5 relative at a
  mean of 1e3 (a naive sum of squares misses it);
- layer_norm backward: 2e-4, the JAX package's own bar for its kernel
  against jax.vjp (tests/test_fused_kernels.py), also for the kernel's
  summation order of dscale / dbias emulated in plain torch; on the card dx
  1e-5 and the column sums rtol 1e-4 / atol 1e-3 (sums over up to 4096
  rows); bf16 outputs 1e-2 (one rounding);
- multi-tensor Adam: atol = rtol = 1e-6 (the same f32 expressions, but
  XLA may contract a product and a sum into one FMA, and m1 cancels near
  zero, so an absolute floor is needed beside the relative one; the JAX
  bit-identity test of its own kernel is red on the reference, so these
  hold it to the expressions at a tolerance, not bit for bit). bf16
  moments within one bf16 ulp: an f32 result one ulp apart (an FMA) can
  round to the neighbouring bf16 value.

The JAX reference is imported inside a fixture, so that on the card, where
JAX is not installed, the `cuda` cases run alone
(`python -m pytest --noconftest tests/test_torch_fused_kernels.py -m cuda`).
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import fused
from paddle_tpu_torch.ops import gemm_epilogue as ge
from paddle_tpu_torch.ops import layer_norm as ln
from paddle_tpu_torch.ops import multi_adam as ma

ACTS = [None, "relu", "gelu", "tanh", "sigmoid"]
ADAM_SHAPES = [(256, 384), (384,), (128, 128), (7, 13)]  # incl. a ragged tail


@pytest.fixture(scope="module")
def jax_pk():
    """The JAX package's Pallas kernels (interpret mode on the CPU)."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    return pytest.importorskip("paddle_tpu.ops.pallas_kernels")


def _f32(rng, *shape):
    return rng.randn(*shape).astype("float32")


def _t(a, device="cpu"):
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


# --------------------------------------------------------------------------
# plain versions against the JAX Pallas kernels (interpret mode)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("act", ACTS, ids=[str(a) for a in ACTS])
def test_gemm_plain_matches_jax_kernel(jax_pk, act):
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    m, k, n = 128, 256, 384
    x, w, b = _f32(rng, m, k), _f32(rng, k, n), _f32(rng, n)
    assert jax_pk.gemm_path_taken(m, n, k) and fused.gemm_path_taken(m, n, k)
    jz, jy = jax_pk.gemm_bias_act(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), act,
                                  interpret=True)
    z, y = ge.gemm_bias_act_plain(_t(x), _t(w), _t(b), act)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=2e-5, rtol=2e-5)
    if act is None:
        assert y is None and jy is None
    else:
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
def test_layer_norm_plain_matches_jax_kernel(jax_pk, residual):
    import jax.numpy as jnp

    rng = np.random.RandomState(2)
    rows, cols = 128, 256
    x = _f32(rng, rows, cols) * 3 + 1
    r = _f32(rng, rows, cols) if residual else None
    scale = rng.rand(cols).astype("float32") + 0.5
    bias = _f32(rng, cols)
    assert jax_pk.ln_path_taken(rows, cols) and fused.ln_path_taken(rows, cols)
    js, jy, jmean, jvar = jax_pk.fused_layer_norm(
        jnp.asarray(x), None if r is None else jnp.asarray(r), jnp.asarray(scale),
        jnp.asarray(bias), 1e-5, interpret=True,
    )
    s, y, mean, var = ln.fused_layer_norm_plain(
        _t(x), None if r is None else _t(r), _t(scale), _t(bias), 1e-5
    )
    if residual:
        # the residual sum is the value grads replay from: bit for bit
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    else:
        assert s is None and js is None
    for got, want in ((y, jy), (mean, jmean), (var, jvar)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_layer_norm_grad_plain_matches_jax_kernel(jax_pk):
    import jax.numpy as jnp

    rng = np.random.RandomState(3)
    rows, cols = 128, 256
    x, dy = _f32(rng, rows, cols), _f32(rng, rows, cols)
    scale = rng.rand(cols).astype("float32") + 0.5
    bias = _f32(rng, cols)
    _, _, mean, var = jax_pk.fused_layer_norm(
        jnp.asarray(x), None, jnp.asarray(scale), jnp.asarray(bias), 1e-5, interpret=True
    )
    want = jax_pk.fused_layer_norm_grad(
        jnp.asarray(x), jnp.asarray(scale), mean, var, jnp.asarray(dy), 1e-5, interpret=True
    )
    got = ln.fused_layer_norm_grad_plain(
        _t(x), _t(scale), _t(np.asarray(mean)), _t(np.asarray(var)), _t(dy), 1e-5
    )
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), atol=2e-4, rtol=2e-4)


# --------------------------------------------------------------------------
# the layer_norm kernels' summation orders (csrc/layer_norm.cu), emulated
# in plain torch f32 for f32 rows (16-byte vectors of E = 4 columns)
# --------------------------------------------------------------------------

LN_E = 4  # f32 columns in a 16-byte vector
LN_RUN_MIN, LN_MAX_RUNS, LN_GROUP, LN_BWD_WARPS = 16, 256, 16, 16  # csrc constants


def _ln_vectors_a_lane(cols, sizes):
    """The instantiated vectors-a-lane the kernels pick for `cols` f32
    columns: the smallest of `sizes` that holds the row, else None."""
    need = -(-(-(-cols // LN_E)) // 32)
    return next((nv for nv in sizes if nv >= need), None)


def _chan(cnt, mean, m2, nb, mb, qb):
    """The kernel's chan_merge on tensors (lanes where both counts are 0
    keep their zeros)."""
    tot = cnt + nb
    live = tot > 0
    safe = torch.where(live, tot, torch.ones_like(tot))
    d = mb - mean
    mean = torch.where(live, mean + d * (nb / safe), mean)
    m2 = torch.where(live, m2 + (qb + d * d * (cnt * nb / safe)), m2)
    return tot, mean, m2


def _ln_fwd_stats_emulated(s32):
    """mean and biased var of each row of an f32 [rows, cols] tensor in the
    forward kernel's order: lane l holds vectors l, l + 32, ... (NV a lane,
    chunks of 16 past that); each lane's mean and M2 of s - s[:, 0] over
    its columns in two sequential passes, merged chunk by chunk, then the
    lanes by the butterfly (xor 16, 8, 4, 2, 1), lane 0's result."""
    rows, cols = s32.shape
    nv = _ln_vectors_a_lane(cols, (1, 2, 4, 8)) or 16
    chunk = 32 * nv * LN_E
    k0 = s32[:, :1]
    u = s32 - k0
    zero = torch.zeros(rows, 32, dtype=torch.float32)
    cnt, mean, m2 = zero.clone(), zero.clone(), zero.clone()
    lanes = torch.arange(32)
    for c0 in range(0, cols, chunk):
        # [32, NV * E] column of each lane's registers, in register order
        idx = torch.stack([c0 + (32 * k + lanes) * LN_E + e
                           for k in range(nv) for e in range(LN_E)], dim=1)
        valid = idx < cols
        vals = torch.where(valid, u[:, idx.clamp(max=cols - 1)], torch.zeros(()))
        n = valid.sum(dim=1).to(torch.float32).expand(rows, 32)
        tot = zero.clone()
        for j in range(idx.shape[1]):
            tot = tot + vals[:, :, j]
        bm = torch.where(n > 0, tot / n.clamp(min=1), zero)
        bq = zero.clone()
        for j in range(idx.shape[1]):
            d = torch.where(valid[:, j], vals[:, :, j] - bm, zero)
            bq = bq + d * d
        cnt, mean, m2 = _chan(cnt, mean, m2, n, bm, bq)
    for o in (16, 8, 4, 2, 1):
        p = lanes ^ o
        cnt, mean, m2 = _chan(cnt, mean, m2, cnt[:, p], mean[:, p], m2[:, p])
    return k0[:, 0] + mean[:, 0], m2[:, 0] / cols


@pytest.mark.parametrize("cols", [128, 512, 1024])
def test_layer_norm_kernel_stats_order_matches_jax(jax_pk, cols):
    """The forward kernel's statistics order holds the JAX kernel's mean
    and var within 1e-5 relative at a mean of 1e3 and a std of 1, where a
    naive f32 sum of squares does not; the shift by s[:, 0] keeps var
    within 1e-6 of the f64 variance (the JAX kernel's two 512-column
    chunks at 1024 columns are 8e-6 off it)."""
    import jax.numpy as jnp

    rng = np.random.RandomState(20 + cols)
    rows = 128
    x = (rng.randn(rows, cols) + 1e3).astype("float32")
    assert jax_pk.ln_path_taken(rows, cols)
    _, _, jmean, jvar = jax_pk.fused_layer_norm(jnp.asarray(x), None, None, None, 1e-5,
                                                interpret=True)
    mean, var = _ln_fwd_stats_emulated(_t(x))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5, atol=0)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-5, atol=0)
    np.testing.assert_allclose(var.numpy(), x.astype("float64").var(axis=1), rtol=1e-6, atol=0)
    x32 = _t(x)
    naive = (x32 * x32).mean(dim=1) - x32.mean(dim=1) ** 2
    assert not np.allclose(naive.numpy(), np.asarray(jvar), rtol=1e-5, atol=0)


def _ln_bwd_run(rows):
    run = max(LN_RUN_MIN, -(-rows // LN_MAX_RUNS))
    return -(-run // LN_BWD_WARPS) * LN_BWD_WARPS


def _ln_bwd_plan(rows):
    """(run, CTAs, groups, partial rows, counters) of the backward kernel:
    its layer_norm_bwd_partials."""
    run = _ln_bwd_run(rows)
    n_cta = -(-rows // run)
    n_groups = -(-n_cta // LN_GROUP)
    return run, n_cta, n_groups, n_cta + (n_groups if n_groups > 1 else 0), n_groups + 1


def _ordered_sum(terms):
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def _ln_bwd_sums_emulated(x32, mean, var, dy32, eps):
    """dscale and dbias of f32 rows in the backward kernel's order: CTA b
    takes rows [b R, b R + R); in the register form (up to 32 columns a
    lane) warp w of 16 sums its rows b R + w, + 16, ... in order and the
    CTA sums its warps in warp order; in the wider form the CTA sums its rows in
    order; then the partials in CTA order within each group of 16, and the
    groups in group order."""
    rows, cols = x32.shape
    xhat = (x32 - mean[:, None]) * torch.rsqrt(var + eps)[:, None]
    terms = (dy32 * xhat, dy32)
    run, n_cta, n_groups, _, _ = _ln_bwd_plan(rows)
    register_form = _ln_vectors_a_lane(cols, (1, 2, 4, 8)) is not None
    out = []
    for t in terms:
        parts = []
        for b in range(n_cta):
            r0, r1 = b * run, min(rows, (b + 1) * run)
            if not register_form:
                parts.append(_ordered_sum([t[r] for r in range(r0, r1)]))
                continue
            acc = [torch.zeros(cols) for _ in range(LN_BWD_WARPS)]
            for w in range(LN_BWD_WARPS):
                for r in range(r0 + w, r1, LN_BWD_WARPS):
                    acc[w] = acc[w] + t[r]
            parts.append(_ordered_sum(acc))
        groups = [_ordered_sum(parts[g * LN_GROUP:(g + 1) * LN_GROUP])
                  for g in range(n_groups)]
        out.append(groups[0] if n_groups == 1 else _ordered_sum(groups))
    return out


@pytest.mark.parametrize("rows,cols", [(200, 256), (1000, 256), (1024, 256), (4100, 128),
                                       (300, 2048)])
def test_layer_norm_grad_run_order_matches_jax(jax_pk, rows, cols):
    """The backward kernel's summation order of dscale / dbias (row runs,
    warps, groups; rows not a multiple of the run; the wide form at 2048
    columns) holds the JAX kernel's sums at its 2e-4 bar."""
    import jax.numpy as jnp

    rng = np.random.RandomState(rows + cols)
    x, dy = _f32(rng, rows, cols) * 2 + 0.5, _f32(rng, rows, cols)
    scale = rng.rand(cols).astype("float32") + 0.5
    _, _, mean, var = jax_pk.fused_layer_norm(jnp.asarray(x), None, jnp.asarray(scale), None,
                                              1e-5, interpret=True)
    _, jds, jdb = jax_pk.fused_layer_norm_grad(jnp.asarray(x), jnp.asarray(scale), mean, var,
                                               jnp.asarray(dy), 1e-5, interpret=True)
    ds, db = _ln_bwd_sums_emulated(_t(x), _t(np.asarray(mean)), _t(np.asarray(var)), _t(dy),
                                   1e-5)
    np.testing.assert_allclose(ds.numpy(), np.asarray(jds), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), atol=2e-4, rtol=2e-4)


def _adam_case(rng, moment_dtype):
    params = [_f32(rng, *s) for s in ADAM_SHAPES]
    grads = [_f32(rng, *s) for s in ADAM_SHAPES]
    m1s = [_f32(rng, *s) for s in ADAM_SHAPES]
    m2s = [np.abs(_f32(rng, *s)) for s in ADAM_SHAPES]
    lr_ts = np.asarray([1e-3 * (i + 1) for i in range(len(ADAM_SHAPES))], np.float32)
    return params, grads, m1s, m2s, lr_ts


def _assert_within_bf16_ulp(got, want):
    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    ulp = torch.pow(2.0, torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
    bad = (got - want).abs() > ulp
    assert not bool(bad.any()), "%d values more than one bf16 ulp apart" % int(bad.sum())


def _torch_moment(a, moment_dtype, device="cpu"):
    return _t(a, device).to(torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_multi_adam_plain_matches_jax_kernel(jax_pk, moment_dtype):
    import jax.numpy as jnp

    rng = np.random.RandomState(4)
    b1, b2, eps = 0.9, 0.999, 1e-8
    params, grads, m1s, m2s, lr_ts = _adam_case(rng, moment_dtype)
    jdt = jnp.bfloat16 if moment_dtype == "bfloat16" else jnp.float32
    assert jax_pk.adam_path_taken(len(params)) and fused.adam_path_taken(len(params))
    jp, jm1, jm2 = jax_pk.multi_tensor_adam(
        [jnp.asarray(p) for p in params], [jnp.asarray(g) for g in grads],
        [jnp.asarray(m).astype(jdt) for m in m1s], [jnp.asarray(m).astype(jdt) for m in m2s],
        list(lr_ts), b1, b2, eps, interpret=True,
    )
    tp = [_t(p) for p in params]
    tm1 = [_torch_moment(m, moment_dtype) for m in m1s]
    tm2 = [_torch_moment(m, moment_dtype) for m in m2s]
    ma.multi_tensor_adam_plain(tp, [_t(g) for g in grads], tm1, tm2, _t(lr_ts), b1, b2, eps)
    for i in range(len(params)):
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[i]), rtol=1e-6, atol=1e-6)
        for got, want in ((tm1[i], jm1[i]), (tm2[i], jm2[i])):
            want = np.asarray(want, np.float32)
            if moment_dtype == "bfloat16":
                assert got.dtype == torch.bfloat16
                _assert_within_bf16_ulp(got, torch.from_numpy(want))
            else:
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# path predicates: the port declines exactly where the JAX package does
# --------------------------------------------------------------------------

_DIMS = [1, 7, 100, 128, 256, 384, 500, 512, 640, 1000, 1024, 2048, 4096, 4100]


def test_gemm_predicate_matches_jax(jax_pk):
    for m in _DIMS:
        for n in _DIMS[::2]:
            for k in _DIMS[1::3]:
                assert fused.gemm_path_taken(m, n, k) == jax_pk.gemm_path_taken(m, n, k), (m, n, k)
    assert fused.gemm_path_taken(4096, 2048, 512) and fused.gemm_path_taken(4096, 512, 2048)


def test_ln_predicate_matches_jax(jax_pk):
    for rows in _DIMS + [8192, 16384]:
        for cols in _DIMS + [49152, 65536]:
            for itemsize in (2, 4):
                assert fused.ln_path_taken(rows, cols, itemsize) == jax_pk.ln_path_taken(
                    rows, cols, itemsize), (rows, cols, itemsize)
    assert fused.ln_path_taken(4096, 512)


def test_adam_predicate_matches_jax(jax_pk):
    for n in range(0, 6):
        for zero1 in (False, True):
            for sharded in (False, True):
                assert fused.adam_path_taken(n, zero1, sharded) == jax_pk.adam_path_taken(
                    n, zero1, sharded)


# --------------------------------------------------------------------------
# the kernel's 3xTF32 products (csrc/tf32_mma.cuh), emulated in plain torch
# --------------------------------------------------------------------------

GEMM_TOL = 1e-4  # the kernel against its plain version on the card (chip_smoke.py)


def _tf32(x):
    """x cut to TF32 as the kernel's split and the tensor core's operand
    read do: the 13 low mantissa bits masked off."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


@pytest.mark.parametrize("k", [512, 2048], ids=["ffn1_k", "ffn2_k"])
def test_3xtf32_split_holds_the_gemm_tolerance(k):
    """An emulation of the accuracy argument for 3xTF32, in plain torch: it
    runs no port code, and the `cuda` GEMM cases below are what guard the
    kernel (whose tensor-core sums truncate, which this does not model).
    a = hi + lo cut to TF32 (hi the value masked, lo the exact rest read
    as TF32), the three products lo.hi, hi.lo, hi.hi summed in f32 land
    within GEMM_TOL of the float64 product at the FFN GEMMs' depths; one
    TF32 product (the hi.hi term alone) lands outside it at k = 2048,
    which is why the kernel pays for three."""
    rng = np.random.RandomState(k)
    m = n = 64
    x = _t(_f32(rng, m, k))
    w = _t((_f32(rng, k, n) / np.sqrt(k)).astype("float32"))
    ref = x.double() @ w.double()
    xh, wh = _tf32(x), _tf32(w)
    xl, wl = _tf32(x - xh), _tf32(w - wh)
    assert torch.equal(xh + (x - xh), x)  # the rest is exact in f32
    split = xl @ wh + xh @ wl + xh @ wh  # f32 sums, the small terms first
    torch.testing.assert_close(split.double(), ref, atol=GEMM_TOL, rtol=GEMM_TOL)
    one = float((xh @ wh - ref).abs().max())
    three = float((split - ref).abs().max())
    assert three < one / 100
    if k == 2048:
        assert one > GEMM_TOL


# --------------------------------------------------------------------------
# wrappers on CPU tensors take the plain versions and count no launch
# --------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions_uncounted():
    rng = np.random.RandomState(5)
    x, w, b = _t(_f32(rng, 16, 8)), _t(_f32(rng, 8, 12)), _t(_f32(rng, 12))
    xr = _t(_f32(rng, 16, 8))
    before = fused.stats()["launches"]
    z, y = ge.gemm_bias_act(x, w, b, "relu")
    zp, yp = ge.gemm_bias_act_plain(x, w, b, "relu")
    assert torch.equal(z, zp) and torch.equal(y, yp)
    got = ln.fused_layer_norm(x, xr, None, None, 1e-5)
    want = ln.fused_layer_norm_plain(x, xr, None, None, 1e-5)
    assert all(torch.equal(g, wv) for g, wv in zip(got, want))
    got = ln.fused_layer_norm_grad(x, None, want[2], want[3], xr, 1e-5)
    want = ln.fused_layer_norm_grad_plain(x, None, want[2], want[3], xr, 1e-5)
    assert all(torch.equal(g, wv) for g, wv in zip(got, want))
    p, g, m1, m2 = (_t(_f32(rng, 5)) for _ in range(4))
    p0 = p.clone()
    ma.multi_tensor_adam([p], [g], [m1], [m2.abs()], [1e-3], 0.9, 0.999, 1e-8)
    assert not torch.equal(p, p0)  # updated in place
    assert fused.stats()["launches"] == before


# --------------------------------------------------------------------------
# on the card: each kernel against its plain version
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the training kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


GEMM_CUDA_CASES = {
    "ffn1_relu": (512, 512, 2048, "relu", torch.float32),
    "ffn2_none": (512, 2048, 512, None, torch.float32),
    "ffn1_m4096": (4096, 512, 2048, "relu", torch.float32),
    "ffn2_m4096": (4096, 2048, 512, None, torch.float32),
    # m, n, k off the 128 x 64 CTA tile and off the k depth of 64
    "ragged_tiles": (129, 33, 65, "relu", torch.float32),
    "ragged_k_depth": (300, 1001, 200, "gelu", torch.float32),
    # x rows of 2051 f32 and w rows of 131 f32: not 16-byte aligned
    "misaligned_rows": (130, 2051, 131, None, torch.float32),
    "bf16_misaligned_rows": (70, 75, 97, "relu", torch.bfloat16),
    "gelu": (256, 384, 256, "gelu", torch.float32),
    "tanh_sigmoid_ragged": (100, 200, 130, "tanh", torch.float32),
    "sigmoid_ragged_k": (128, 256, 77, "sigmoid", torch.float32),
    "bf16_relu": (256, 256, 512, "relu", torch.bfloat16),
    "bf16_ragged": (100, 72, 33, None, torch.bfloat16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GEMM_CUDA_CASES))
def test_cuda_gemm_matches_plain(cuda_device, name):
    m, k, n, act, dtype = GEMM_CUDA_CASES[name]
    rng = np.random.RandomState(len(name))
    x = _t(_f32(rng, m, k), cuda_device).to(dtype)
    w = _t(_f32(rng, k, n) / np.sqrt(k), cuda_device).to(dtype)
    b = _t(_f32(rng, n), cuda_device)
    before = ge.kernel_launches()["gemm_epilogue"]
    z, y = ge.gemm_bias_act(x, w, b, act)
    torch.cuda.synchronize()
    assert ge.kernel_launches()["gemm_epilogue"] == before + 1
    zp, yp = ge.gemm_bias_act_plain(x, w, b, act)
    tol = 1e-4 if dtype == torch.float32 else 1e-2  # bf16: one rounding of the output
    torch.testing.assert_close(z.float(), zp.float(), atol=tol, rtol=tol)
    if act is None:
        assert y is None
    else:
        torch.testing.assert_close(y.float(), yp.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_cuda_gemm_repeats_bit_for_bit(cuda_device):
    """A shape that cuts the 128 x 64 CTA tile and the k depth of 64
    raggedly, against the plain version; a second run equals the first bit
    for bit (no atomics)."""
    rng = np.random.RandomState(7)
    m, k, n = 300, 1001, 200
    x = _t(_f32(rng, m, k), cuda_device)
    w = _t((_f32(rng, k, n) / np.sqrt(k)).astype("float32"), cuda_device)
    b = _t(_f32(rng, n), cuda_device)
    z, y = ge.gemm_bias_act(x, w, b, "tanh")
    z2, y2 = ge.gemm_bias_act(x, w, b, "tanh")
    torch.cuda.synchronize()
    zp, yp = ge.gemm_bias_act_plain(x, w, b, "tanh")
    torch.testing.assert_close(z, zp, atol=GEMM_TOL, rtol=GEMM_TOL)
    torch.testing.assert_close(y, yp, atol=GEMM_TOL, rtol=GEMM_TOL)
    assert torch.equal(z, z2) and torch.equal(y, y2)


@pytest.mark.cuda
def test_cuda_gemm_launches_on_every_card(cuda_device):
    """The kernel's shared-memory opt-in is per device: a launch on each
    card in turn, after the first card's, still matches the plain version."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA card")
    rng = np.random.RandomState(11)
    m, k, n = 256, 512, 192
    x, b = _f32(rng, m, k), _f32(rng, n)
    w = (_f32(rng, k, n) / np.sqrt(k)).astype("float32")
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        args = (_t(x, dev), _t(w, dev), _t(b, dev), "relu")
        z, y = ge.gemm_bias_act(*args)
        zp, yp = ge.gemm_bias_act_plain(*args)
        assert z.device == dev
        torch.testing.assert_close(z, zp, atol=GEMM_TOL, rtol=GEMM_TOL)
        torch.testing.assert_close(y, yp, atol=GEMM_TOL, rtol=GEMM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_layer_norm_matches_plain(cuda_device, residual, dtype):
    rng = np.random.RandomState(6)
    rows, cols = 4096, 512
    x = _t(_f32(rng, rows, cols) * 2 + 0.5, cuda_device).to(dtype)
    r = _t(_f32(rng, rows, cols), cuda_device).to(dtype) if residual else None
    scale = _t(rng.rand(cols).astype("float32") + 0.5, cuda_device)
    bias = _t(_f32(rng, cols), cuda_device)
    before = ln.kernel_launches()["layer_norm"]
    got = ln.fused_layer_norm(x, r, scale, bias, 1e-5)
    torch.cuda.synchronize()
    assert ln.kernel_launches()["layer_norm"] == before + 1
    want = ln.fused_layer_norm_plain(x, r, scale, bias, 1e-5)
    if residual:
        assert torch.equal(got[0], want[0])
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got[1].float(), want[1].float(), atol=tol, rtol=tol)
    torch.testing.assert_close(got[2], want[2], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got[3], want[3], atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows,cols", [(4096, 512), (200, 96)], ids=["main", "ragged"])
def test_cuda_layer_norm_grad_matches_plain(cuda_device, rows, cols, dtype):
    rng = np.random.RandomState(7)
    x = _t(_f32(rng, rows, cols), cuda_device).to(dtype)
    dy = _t(_f32(rng, rows, cols), cuda_device).to(dtype)
    scale = _t(rng.rand(cols).astype("float32") + 0.5, cuda_device)
    _, _, mean, var = ln.fused_layer_norm_plain(x, None, scale, None, 1e-5)
    before = ln.kernel_launches()["layer_norm_grad"]
    dx, ds, db = ln.fused_layer_norm_grad(x, scale, mean, var, dy, 1e-5)
    torch.cuda.synchronize()
    assert ln.kernel_launches()["layer_norm_grad"] == before + 1
    pdx, pds, pdb = ln.fused_layer_norm_grad_plain(x, scale, mean, var, dy, 1e-5)
    tol = 1e-5 if dtype == torch.float32 else 1e-2  # bf16: dx rounded once
    torch.testing.assert_close(dx.float(), pdx.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(ds, pds, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(db, pdb, atol=1e-3, rtol=1e-4)
    # no float atomics: the column sums repeat bit for bit
    _, ds2, db2 = ln.fused_layer_norm_grad(x, scale, mean, var, dy, 1e-5)
    assert torch.equal(ds, ds2) and torch.equal(db, db2)


# the edge grid of both kernels: every register width, the chunked forward
# and the wide backward, up to _ln_blocks' widest f32 row (49152); rows of
# 1 and 7 (a CTA barely filled), 200 and 4096 (more than one row run)
LN_EDGE_COLS = [96, 128, 512, 768, 1024, 4096, 8192, 49152]
LN_EDGE_ROWS = [1, 7, 200, 4096]


def _ln_edge_case(rows, cols, dtype, device, seed):
    """x, r, dy (dtype) and scale, bias ([cols] f32), made on the card from
    a seed (a 4096 x 49152 tensor is slow to make on the host)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(rows, cols, generator=g, device=device) * 2 + 0.5).to(dtype)
    r = torch.randn(rows, cols, generator=g, device=device).to(dtype)
    dy = torch.randn(rows, cols, generator=g, device=device).to(dtype)
    scale = torch.rand(cols, generator=g, device=device) + 0.5
    bias = torch.randn(cols, generator=g, device=device)
    return x, r, dy, scale, bias


def _ln_check_fwd(x, r, scale, bias, tol):
    got = ln.fused_layer_norm(x, r, scale, bias, 1e-5)
    want = ln.fused_layer_norm_plain(x, r, scale, bias, 1e-5)
    if r is None:
        assert got[0] is None
    else:
        assert torch.equal(got[0], want[0])  # s = x + r, bit for bit
    torch.testing.assert_close(got[1].float(), want[1].float(), atol=tol, rtol=tol)
    torch.testing.assert_close(got[2], want[2], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got[3], want[3], atol=1e-5, rtol=1e-5)
    return got


def _ln_check_bwd(x, scale, mean, var, dy, tol):
    dx, ds, db = ln.fused_layer_norm_grad(x, scale, mean, var, dy, 1e-5)
    pdx, pds, pdb = ln.fused_layer_norm_grad_plain(x, scale, mean, var, dy, 1e-5)
    torch.testing.assert_close(dx.float(), pdx.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(ds, pds, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(db, pdb, atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cols", LN_EDGE_COLS)
def test_cuda_layer_norm_edge_grid(cuda_device, cols, dtype):
    """Forward (with and without the residual) and backward against the
    plain forms at every row count of the grid, scale and bias null and
    set; one launch each."""
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for rows in LN_EDGE_ROWS:
        x, r, dy, scale, bias = _ln_edge_case(rows, cols, dtype, cuda_device, rows + cols)
        for sc, bi in ((None, None), (scale, bias)):
            for res in (None, r):
                before = dict(ln.kernel_launches())
                _, _, mean, var = _ln_check_fwd(x, res, sc, bi, tol)
                _ln_check_bwd(x, sc, mean, var, dy, tol)
                after = ln.kernel_launches()
                assert {k: after[k] - before[k] for k in after} == {
                    "layer_norm": 1, "layer_norm_grad": 1}, (rows, cols, sc is None)
        del x, r, dy
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cols", [512, 4096])
def test_cuda_layer_norm_misaligned_views(cuda_device, cols, dtype):
    """x, r, dy, scale and bias as views one element past a 16-byte
    boundary: the kernels read and write them element by element."""
    rows, tol = 200, 1e-5 if dtype == torch.float32 else 1e-2
    tensors = _ln_edge_case(rows, cols, dtype, cuda_device, 11)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        v = buf[1:].view(t.shape)
        v.copy_(t)
        assert v.data_ptr() % 16 != 0
        return v

    x, r, dy, scale, bias = (shifted(t) for t in tensors)
    _, _, mean, var = _ln_check_fwd(x, r, scale, bias, tol)
    _ln_check_bwd(x, scale, mean, var, dy, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", [(4100, 512), (1000, 2048)], ids=["registers", "wide"])
def test_cuda_layer_norm_grad_repeats_and_resets_its_counters(cuda_device, rows, cols):
    """More than one row run and more than one group of partials: dscale
    and dbias bit for bit over two calls, every arrival counter back at 0
    after each, and the scratch the kernel asks for the emulated plan's."""
    import ctypes

    from paddle_tpu_torch.ops import _build

    x, _, dy, scale, _ = _ln_edge_case(rows, cols, torch.float32, cuda_device, 12)
    _, _, mean, var = ln.fused_layer_norm_plain(x, None, scale, None, 1e-5)
    counters = ctypes.c_int(0)
    n_part = _build.load("layer_norm").layer_norm_bwd_partials(rows, cols,
                                                               ctypes.byref(counters))
    _, n_cta, n_groups, want_part, want_counters = _ln_bwd_plan(rows)
    assert n_groups > 1 and (n_part, counters.value) == (want_part, want_counters)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    sums = []
    for _ in range(2):
        _, ds, db = ln.fused_layer_norm_grad(x, scale, mean, var, dy, 1e-5)
        torch.cuda.synchronize()
        arrivals = _build.arrival_counters(cuda_device, stream, counters.value)
        assert int(arrivals[:counters.value].abs().sum()) == 0
        sums.append((ds, db))
    assert torch.equal(sums[0][0], sums[1][0]) and torch.equal(sums[0][1], sums[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_cuda_multi_adam_matches_plain(cuda_device, moment_dtype):
    rng = np.random.RandomState(8)
    params, grads, m1s, m2s, lr_ts = _adam_case(rng, moment_dtype)
    args = []
    for _ in range(2):
        args.append((
            [_t(p, cuda_device) for p in params], [_t(g, cuda_device) for g in grads],
            [_torch_moment(m, moment_dtype, cuda_device) for m in m1s],
            [_torch_moment(m, moment_dtype, cuda_device) for m in m2s],
            _t(lr_ts, cuda_device),
        ))
    before = ma.kernel_launches()["multi_adam"]
    ma.multi_tensor_adam(*args[0], 0.9, 0.999, 1e-8)
    torch.cuda.synchronize()
    assert ma.kernel_launches()["multi_adam"] == before + 1
    ma.multi_tensor_adam_plain(*args[1], 0.9, 0.999, 1e-8)
    for slot in (0, 2, 3):
        for got, want in zip(args[0][slot], args[1][slot]):
            if got.dtype == torch.bfloat16:
                _assert_within_bf16_ulp(got.cpu(), want.cpu())
            else:
                torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


# ragged sizes around the kernel's 4-element vectors and its chunks, and
# element offsets of a view into a larger buffer: 0 (aligned), 1-3 (a base
# not on 16 bytes, all four operands at one phase: a scalar head, then
# vectors), and "mixed" (the parameter one element off, the rest aligned:
# element by element)
def _adam_ragged():
    chunk = ma.chunk_elems()
    return [(7, 13), (1,), (3,), (chunk + 1,), (chunk + 5,), (33, chunk - 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 1, 2, 3, "mixed"])
def test_cuda_multi_adam_views_and_ragged_sizes(cuda_device, offset, moment_dtype):
    """Bit for bit with the plain version (bf16 moments: each is the
    plain version's f32 value rounded once, so one bf16 ulp at most)."""
    rng = np.random.RandomState(9)
    mdt = torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32
    ragged = _adam_ragged()
    sets = []
    for _ in range(2):
        rng_i = np.random.RandomState(10)
        quads = []
        for shape in ragged:
            n = int(np.prod(shape))
            views = []
            for slot, (scale, dt) in enumerate(((0.05, torch.float32), (1e-3, torch.float32),
                                                (1e-4, mdt), (1e-7, mdt))):
                at = (1 if slot == 0 else 0) if offset == "mixed" else offset
                buf = torch.zeros(n + 8, dtype=dt, device=cuda_device)
                x = rng_i.randn(n).astype("float32") * scale
                buf[at:at + n] = torch.from_numpy(np.abs(x) if slot == 3 else x).to(buf)
                views.append(buf[at:at + n].view(shape))
            quads.append(views)
        sets.append(quads)
    lr = torch.from_numpy((1e-3 * (1 + rng.rand(len(ragged)))).astype("float32"))
    before = ma.kernel_launches()["multi_adam"]
    got = [list(slot) for slot in zip(*sets[0])]
    want = [list(slot) for slot in zip(*sets[1])]
    ma.multi_tensor_adam(*got, lr.to(cuda_device), 0.9, 0.999, 1e-8)
    torch.cuda.synchronize()
    assert ma.kernel_launches()["multi_adam"] == before + 1
    ma.multi_tensor_adam_plain(*want, lr.to(cuda_device), 0.9, 0.999, 1e-8)
    for slot in (0, 2, 3):
        for g, w in zip(got[slot], want[slot]):
            if g.dtype == torch.bfloat16:
                _assert_within_bf16_ulp(g.cpu(), w.cpu())
            else:
                assert torch.equal(g, w)
