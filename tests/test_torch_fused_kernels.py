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
- layer_norm forward: 1e-5 (f32 statistics, Welford vs two-pass);
- layer_norm backward: 2e-4, the JAX package's own bar for its kernel
  against jax.vjp (tests/test_fused_kernels.py); on the card dx 1e-5 and the
  column sums rtol 1e-4 / atol 1e-3 (sums over up to 4096 rows);
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
@pytest.mark.parametrize("rows,cols", [(4096, 512), (200, 96)], ids=["main", "ragged"])
def test_cuda_layer_norm_grad_matches_plain(cuda_device, rows, cols):
    rng = np.random.RandomState(7)
    x = _t(_f32(rng, rows, cols), cuda_device)
    dy = _t(_f32(rng, rows, cols), cuda_device)
    scale = _t(rng.rand(cols).astype("float32") + 0.5, cuda_device)
    _, _, mean, var = ln.fused_layer_norm_plain(x, None, scale, None, 1e-5)
    before = ln.kernel_launches()["layer_norm_grad"]
    dx, ds, db = ln.fused_layer_norm_grad(x, scale, mean, var, dy, 1e-5)
    torch.cuda.synchronize()
    assert ln.kernel_launches()["layer_norm_grad"] == before + 1
    pdx, pds, pdb = ln.fused_layer_norm_grad_plain(x, scale, mean, var, dy, 1e-5)
    torch.testing.assert_close(dx, pdx, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(ds, pds, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(db, pdb, atol=1e-3, rtol=1e-4)
    # no float atomics: the column sums repeat bit for bit
    _, ds2, db2 = ln.fused_layer_norm_grad(x, scale, mean, var, dy, 1e-5)
    assert torch.equal(ds, ds2) and torch.equal(db, db2)


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
