"""Paged attention in the torch port (paddle_tpu_torch/ops/paged_flash.py):
the plain torch version against the JAX package's Pallas kernel (interpret
mode) and its dense lowering, and — on a CUDA card — the hand-written
kernel against the plain version. Both block-table forms, rows that end
exactly on and just past a page boundary, partly filled last pages, pos < 0
rows and scratch-page table entries.

Tolerance: atol = rtol = 1e-5. All sides compute in f32; the online softmax
of the kernels reassociates the sums, which moves results by a few ulp."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import flags as jax_flags
from paddle_tpu.ops import pallas_kernels as jax_pk
from paddle_tpu.ops import registry as jax_registry
from paddle_tpu_torch import flags as pt_flags
from paddle_tpu_torch.ops import paged_flash as pf
from paddle_tpu_torch.ops import registry as pt_registry

ATOL = RTOL = 1e-5

# (rows, n_head, d, page_size, table pages, pool pages, positions); a table
# entry of 0 is the scratch page
DECODE_CASES = {
    "boundaries": (6, 2, 8, 4, 3, 12, [2, 3, 4, 7, 11, -1]),
    "beyond_table": (3, 3, 16, 8, 2, 9, [15, 16, 40]),
    "single_page": (4, 1, 4, 16, 1, 3, [0, 15, -5, 9]),
    # more table entries than one CTA walks: the kernel splits the walk
    "split_walk": (4, 2, 8, 4, 10, 45, [39, 17, 16, 3]),
}
SHARED_CASES = {
    "mid_page_chunk": (6, 2, 8, 4, 3, 10, list(range(5, 11))),
    "chunk_from_zero": (8, 2, 8, 4, 4, 9, list(range(8))),
    "padded_tail": (5, 3, 8, 4, 2, 7, [6, 7, 8, 9, -1]),
    "split_walk_chunk": (40, 2, 8, 4, 12, 14, list(range(6, 46))),
}


def _case(spec, shared, seed):
    rows, n_head, d, ps, p, n_pages, pos = spec
    rng = np.random.RandomState(seed)
    feat = n_head * d
    q = rng.randn(rows, feat).astype("float32")
    kp = rng.randn(n_pages * ps, feat).astype("float32")
    vp = rng.randn(n_pages * ps, feat).astype("float32")
    if shared:
        bt = rng.choice(np.arange(1, n_pages), p, replace=False).astype(np.int32)
        bt[-1] = 0  # the last table entry is the scratch page
    else:
        bt = np.stack([
            rng.choice(np.arange(1, n_pages), p, replace=False) for _ in range(rows)
        ]).astype(np.int32)
        bt[0, -1] = 0
    return q, kp, vp, bt, np.asarray(pos, np.int32), n_head, ps


def _torch_args(q, kp, vp, bt, pos, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in (q, kp, vp, bt, pos)]


def _all_cases():
    return [(k, DECODE_CASES[k], False) for k in DECODE_CASES] + [
        (k, SHARED_CASES[k], True) for k in SHARED_CASES
    ]


@pytest.mark.parametrize(
    "name,spec,shared", _all_cases(), ids=[c[0] for c in _all_cases()]
)
def test_plain_matches_jax_pallas_kernel(name, spec, shared):
    q, kp, vp, bt, pos, n_head, ps = _case(spec, shared, seed=len(name))
    want = jax_pk.paged_flash_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(pos), n_head=n_head, page_size=ps, interpret=True,
    )
    got = pf.paged_attention_plain(*_torch_args(q, kp, vp, bt, pos), n_head=n_head, page_size=ps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    dead = pos < 0
    assert np.all(got.numpy()[dead] == 0.0)  # exact zeros for pos < 0


@pytest.mark.parametrize(
    "name,spec,shared", _all_cases(), ids=[c[0] for c in _all_cases()]
)
def test_op_matches_jax_dense_lowering(name, spec, shared):
    """The paged_attention op of both packages with FLAGS_paged_flash="off"
    (the dense gather forms), through each package's registry."""
    q, kp, vp, bt, pos, n_head, ps = _case(spec, shared, seed=7 + len(name))
    attrs = {"n_head": n_head, "page_size": ps}
    jsaved = jax_flags.get_flags("paged_flash")
    jax_flags.set_flags({"paged_flash": "off"})
    try:
        ins = {k: [jnp.asarray(a)] for k, a in zip(
            ("Q", "KPool", "VPool", "BlockTable", "Pos"), (q, kp, vp, bt, pos))}
        want = jax_registry.get("paged_attention").lower(None, ins, attrs)["Out"][0]
    finally:
        jax_flags.set_flags(jsaved)
    psaved = pt_flags.get_flags("paged_flash")
    pt_flags.set_flags({"paged_flash": "off"})
    try:
        ins = {k: [t] for k, t in zip(
            ("Q", "KPool", "VPool", "BlockTable", "Pos"), _torch_args(q, kp, vp, bt, pos))}
        ctx = pt_registry.LowerCtx("cpu")
        got = pt_registry.get("paged_attention").lower(ctx, ins, attrs)["Out"][0]
    finally:
        pt_flags.set_flags(psaved)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_cpu_tensors_take_the_plain_version_uncounted():
    """On CPU tensors the wrapper runs the plain version and the launch
    counter does not move: it counts kernel launches only."""
    q, kp, vp, bt, pos, n_head, ps = _case(DECODE_CASES["boundaries"], False, seed=3)
    args = _torch_args(q, kp, vp, bt, pos)
    before = pf.kernel_launches()
    got = pf.paged_flash_attention(*args, n_head=n_head, page_size=ps)
    want = pf.paged_attention_plain(*args, n_head=n_head, page_size=ps)
    assert torch.equal(got, want)
    assert pf.kernel_launches() == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the paged flash kernel has no CPU form")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name,spec,shared", _all_cases(), ids=[c[0] for c in _all_cases()]
)
def test_cuda_kernel_matches_plain(cuda_device, name, spec, shared):
    q, kp, vp, bt, pos, n_head, ps = _case(spec, shared, seed=31 + len(name))
    args = _torch_args(q, kp, vp, bt, pos, cuda_device)
    key = "paged_flash_shared" if shared else "paged_flash"
    before = pf.kernel_launches()[key]
    got = pf.paged_flash_attention(*args, n_head=n_head, page_size=ps)
    torch.cuda.synchronize()
    assert pf.kernel_launches()[key] == before + 1
    want = pf.paged_attention_plain(*args, n_head=n_head, page_size=ps)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=ATOL, rtol=RTOL)
    assert np.all(got.cpu().numpy()[pos < 0] == 0.0)
