"""Paged attention in the torch port (paddle_tpu_torch/ops/paged_flash.py):
the plain torch version against the JAX package's Pallas kernel (interpret
mode) and its dense lowering, plain-torch emulations of the decode
kernel's walk and of the shared-table kernel's 3xTF32 arithmetic, and — on
a CUDA card — the hand-written
kernels against the plain version. Both block-table forms, rows that end
exactly on and just past a page boundary, partly filled last pages, pos < 0
rows and scratch-page table entries; for the shared table also chunks of 1,
17, 32 and 48 rows, chunks across a stage or a split boundary, pos = 0,
f32 and int8 pools, head widths 6 to 160, and bit-for-bit repeats; for
the per-slot table also 1 to 64 slots at page sizes 8, 16 and 32, head
widths 6 to 160, pos of -1, 0, a page boundary, the table's last position
and past it, and a corrupt table entry.

Tolerance: atol = rtol = 1e-5. All sides compute in f32 (the shared form's
products as 3xTF32); the online softmax of the kernels reassociates the
sums, which moves results by a few ulp.

The JAX reference is imported inside a fixture, so that on the card, where
JAX is not installed, the `cuda` cases run alone
(`python -m pytest --noconftest tests/test_torch_paged_attention.py -m cuda`)."""

import numpy as np
import pytest
import torch

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
    # d = 64 heads over tables longer than one 128-position split of the
    # decode kernel, at page sizes 8 and 32
    "ps8_long_table": (4, 2, 64, 8, 40, 90, [319, 200, 128, -1]),
    "ps32_long_table": (3, 2, 64, 32, 12, 20, [383, 127, 129]),
    "ps16_split_edges": (4, 3, 64, 16, 24, 60, [255, 256, 383, 0]),
    # a head of 256 over pages of 128 rows: a whole page of K and V passes a
    # CTA's shared memory (the wide kernel gathers by position); a split (64
    # positions) and a page boundary
    "d256_ps128": (3, 1, 256, 128, 3, 6, [300, 128, -1]),
}
SHARED_CASES = {
    "mid_page_chunk": (6, 2, 8, 4, 3, 10, list(range(5, 11))),
    "chunk_from_zero": (8, 2, 8, 4, 4, 9, list(range(8))),
    "padded_tail": (5, 3, 8, 4, 2, 7, [6, 7, 8, 9, -1]),
    "split_walk_chunk": (40, 2, 8, 4, 12, 14, list(range(6, 46))),
    # a chunk of heads of 512 over pages of 32 rows (the same fault, shared
    # form), across a split and a page boundary, with a dead row
    "d512_ps32": (4, 1, 512, 32, 4, 7, [40, 70, 100, -1]),
}


@pytest.fixture(scope="module")
def jax_ref():
    """(jax.numpy, flags, pallas_kernels, registry) of the JAX package."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    from paddle_tpu import flags
    from paddle_tpu.ops import pallas_kernels, registry

    return jax.numpy, flags, pallas_kernels, registry


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
def test_plain_matches_jax_pallas_kernel(jax_ref, name, spec, shared):
    jnp, _, jax_pk, _ = jax_ref
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
def test_op_matches_jax_dense_lowering(jax_ref, name, spec, shared):
    """The paged_attention op of both packages with FLAGS_paged_flash="off"
    (the dense gather forms), through each package's registry."""
    jnp, jax_flags, _, jax_registry = jax_ref
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


# --------------------------------------------------------------------------
# the shared-table kernel's arithmetic, emulated in plain torch
# --------------------------------------------------------------------------


def _tf32(x):
    """x cut to TF32 as the kernel's split and the tensor core's operand
    read do: the 13 low mantissa bits masked off."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _shared_3xtf32(q, k, v, pos, scale, stages_per_split):
    """One head of the shared-table kernel: splits of 64 * stages_per_split
    positions, each stage's 64 keys halved over two warps' online softmax
    (3xTF32 q k^T and p v, each stage's p v part summed from 0), the halves
    merged, then the splits merged in order. q [rows, d], k/v [n_keys, d]
    gathered up to the rows' max(pos)."""
    neg = float("-inf")
    live_pos = pos[:, None]
    span = 64 * stages_per_split
    parts = []
    for s0 in range(0, k.shape[0], span):
        halves = []
        for kh in range(2):
            m = torch.full((q.shape[0], 1), neg)
            l = torch.zeros(q.shape[0], 1)
            o = torch.zeros(q.shape[0], v.shape[1])
            for k0 in range(s0 + 32 * kh, min(s0 + span, k.shape[0]), 64):
                keys = torch.arange(k0, min(k0 + 32, k.shape[0]))
                s = _mm_3xtf32(q, k[keys].T) * scale
                s = torch.where(keys[None, :] <= live_pos, s, torch.full((), neg))
                m_new = torch.maximum(m, s.amax(dim=1, keepdim=True))
                alpha = torch.where(m == neg, torch.zeros(()), torch.exp(m - m_new))
                p = torch.where(s == neg, torch.zeros(()), torch.exp(s - m_new))
                l = l * alpha + p.sum(dim=1, keepdim=True)
                o = o * alpha + _mm_3xtf32(p, v[keys])
                m = m_new
            halves.append((m, l, o))
        (m0, l0, o0), (m1, l1, o1) = halves
        mm = torch.maximum(m0, m1)
        a0 = torch.where(m0 == neg, torch.zeros(()), torch.exp(m0 - mm))
        a1 = torch.where(m1 == neg, torch.zeros(()), torch.exp(m1 - mm))
        parts.append((mm, l0 * a0 + l1 * a1, o0 * a0 + o1 * a1))
    mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    w = [torch.where(m == neg, torch.zeros(()), torch.exp(m - mx)) for m, _, _ in parts]
    lsum = sum(l * wi for (_, l, _), wi in zip(parts, w))
    acc = sum(o * wi for (_, _, o), wi in zip(parts, w))
    return acc / torch.where(lsum > 0, lsum, torch.ones(()))


SHARED_STAGES = 2  # 64-key stages a split of the shared kernel (kSStages in paged_flash.cu)


def test_3xtf32_shared_kernel_holds_the_paged_tolerance():
    """An emulation of the accuracy argument for the tensor-core shared-table
    kernel, in plain torch: it runs no port kernel and guards none (the
    `cuda` cases below and chip_smoke.py do; the tensor core's truncating
    sums are not modelled). At chip_smoke.py's prefill chunk (32 rows of 12
    heads x 64 over a 64-entry table of 16-row pages, positions 600-629 and
    two dead rows), the split products, the per-stage sums from 0 and the
    two merges land within the paged tolerance, atol = rtol = 1e-5, of
    paged_attention_plain."""
    rng = np.random.RandomState(0)
    rows, n_head, d, ps, n_pages = 32, 12, 64, 16, 64
    feat = n_head * d
    q = rng.randn(rows, feat).astype("float32")
    kp = rng.randn((n_pages + 1) * ps, feat).astype("float32")
    vp = rng.randn((n_pages + 1) * ps, feat).astype("float32")
    pos = np.arange(600, 600 + rows, dtype=np.int32)
    pos[-2:] = -1
    bt = rng.permutation(np.arange(1, n_pages + 1)).astype(np.int32)
    args = _torch_args(q, kp, vp, bt, pos)
    want = pf.paged_attention_plain(*args, n_head=n_head, page_size=ps)
    n_keys = int(pos.max()) + 1
    flat = (torch.from_numpy(bt).long()[:, None] * ps + torch.arange(ps)).reshape(-1)[:n_keys]
    got = torch.zeros(rows, feat)
    for h in range(n_head):
        cols = slice(h * d, (h + 1) * d)
        got[:, cols] = _shared_3xtf32(args[0][:, cols], args[1][flat, cols], args[2][flat, cols],
                                      args[4].long(), d ** -0.5, SHARED_STAGES)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    assert torch.equal(got[-2:], torch.zeros(2, feat))


# --------------------------------------------------------------------------
# the decode kernel's walk, emulated in plain torch
# --------------------------------------------------------------------------

DECODE_SPLIT, DECODE_WARP = 128, 32  # context positions a CTA, and a warp
LOG2E = 1.4426950408889634


def _decode_walk(q, k, v, n_keys, scale):
    """One (slot, head) of the decode kernel: splits of DECODE_SPLIT
    positions, each of warps of DECODE_WARP positions taken as one softmax
    step in the base-2 domain (s * scale * log2(e)), the warps merged in
    order, then the splits merged in order; a warp with no live position
    adds exactly 0. q [d], k/v [ctx, d] gathered in position order."""
    neg = torch.tensor(float("-inf"))
    parts = []
    for s0 in range(0, n_keys, DECODE_SPLIT):
        warps = []
        for w0 in range(s0, s0 + DECODE_SPLIT, DECODE_WARP):
            if w0 >= n_keys:
                warps.append((neg, torch.zeros(()), torch.zeros(q.shape[0])))
                continue
            keys = torch.arange(w0, min(w0 + DECODE_WARP, n_keys))
            s = (k[keys] @ q) * (scale * LOG2E)
            m = s.max()
            p = torch.exp2(s - m)
            warps.append((m, p.sum(), p @ v[keys]))
        parts.append(_merge_in_order(warps))
    m, l, acc = _merge_in_order(parts)
    return acc / l


def _merge_in_order(states):
    """(M, L, acc) of (m, l, acc) states, weights 2^(m - M), added in order;
    a state with m = -inf weighs exactly 0."""
    mx = torch.stack([m for m, _, _ in states]).max()
    l_sum, acc = torch.zeros(()), torch.zeros_like(states[0][2])
    for m, l, a in states:
        w = torch.zeros(()) if m == float("-inf") else torch.exp2(m - mx)
        l_sum = l_sum + l * w
        acc = acc + a * w
    return mx, l_sum, acc


def test_decode_walk_holds_the_paged_tolerance():
    """An emulation of the decode kernel's argument, in plain torch: it runs
    no port kernel and guards none (the `cuda` cases below and
    chip_smoke.py do). At chip_smoke.py's decode step (8 slots of 12 heads x
    64 over 64-entry tables of 16-row pages, positions -1, 0, 15, 16, 333,
    700, 871 and 1023), splits of 128 positions and warps of 32, each
    warp's (m, l, acc), the merges in warp and split order, and a warp with
    no live position adding exactly 0 land within the paged tolerance,
    atol = rtol = 1e-5, of paged_attention_plain; the pos < 0 slot is exact
    zeros."""
    rng = np.random.RandomState(1)
    slots, n_head, d, ps, n_pages = 8, 12, 64, 16, 64
    feat = n_head * d
    pos = np.array([-1, 0, 15, 16, 333, 700, 871, 1023], np.int32)
    pool_pages = slots * n_pages + 1
    q = rng.randn(slots, feat).astype("float32")
    kp = rng.randn(pool_pages * ps, feat).astype("float32")
    vp = rng.randn(pool_pages * ps, feat).astype("float32")
    bt = rng.permutation(np.arange(1, pool_pages))[: slots * n_pages]
    bt = bt.reshape(slots, n_pages).astype(np.int32)
    args = _torch_args(q, kp, vp, bt, pos)
    want = pf.paged_attention_plain(*args, n_head=n_head, page_size=ps)
    got = torch.zeros(slots, feat)
    for r in range(slots):
        n_keys = min(int(pos[r]) + 1, n_pages * ps) if pos[r] >= 0 else 0
        if n_keys == 0:
            continue  # the kernel writes exact zeros and loads nothing
        flat = (torch.from_numpy(bt[r]).long()[:, None] * ps + torch.arange(ps)).reshape(-1)
        flat = flat[:n_keys]
        for h in range(n_head):
            cols = slice(h * d, (h + 1) * d)
            got[r, cols] = _decode_walk(args[0][r, cols], args[1][flat, cols],
                                        args[2][flat, cols], n_keys, d ** -0.5)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    assert torch.equal(want[0], torch.zeros(feat))


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
    key = pf.launch_key(shared, spec[2], False)
    before = pf.kernel_launches()[key]
    got = pf.paged_flash_attention(*args, n_head=n_head, page_size=ps)
    torch.cuda.synchronize()
    assert pf.kernel_launches()[key] == before + 1
    want = pf.paged_attention_plain(*args, n_head=n_head, page_size=ps)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=ATOL, rtol=RTOL)
    assert np.all(got.cpu().numpy()[pos < 0] == 0.0)


# the shared (prefill-chunk) form at chunk shapes: (rows, n_head, d,
# positions); page_size 16 over a 64-entry table, as chip_smoke.py's chunk.
# A stage is 64 positions, a split 64 * SHARED_STAGES
CHUNK_CASES = {
    "rows1": (1, 4, 64, [600]),
    "rows17": (17, 4, 64, list(range(600, 617))),
    "rows32_dead_tail": (32, 4, 64, list(range(600, 630)) + [-1, -1]),
    "rows48": (48, 4, 64, list(range(580, 628))),
    "across_stage": (8, 4, 64, list(range(60, 68))),
    "across_split": (8, 4, 64, list(range(124, 132))),
    "one_split": (6, 4, 64, list(range(90, 96))),
    "pos0": (4, 4, 64, [0, 0, -1, 1]),
    "all_dead": (3, 4, 64, [-1, -1, -1]),
    "d6_unaligned": (9, 3, 6, list(range(200, 209))),
    "d32": (16, 4, 32, list(range(300, 316))),
    "d128": (20, 2, 128, list(range(500, 520))),
    "d160_wide": (12, 2, 160, list(range(300, 312))),  # past the tensor-core form
}


def _chunk_case(spec, quant, seed, device):
    rows, n_head, d, pos = spec
    ps, n_pages = 16, 64
    rng = np.random.RandomState(seed)
    feat = n_head * d
    q = rng.randn(rows, feat).astype("float32")
    pools = [rng.randn((n_pages + 1) * ps, feat).astype("float32") for _ in range(2)]
    kw = dict(n_head=n_head, page_size=ps)
    if quant:
        scales = [(np.abs(x).max(axis=1) / 127.0).astype("float32") for x in pools]
        pools = [np.clip(np.round(x / s[:, None]), -127, 127).astype(np.int8)
                 for x, s in zip(pools, scales)]
        kw.update(k_scales=torch.from_numpy(scales[0]).to(device),
                  v_scales=torch.from_numpy(scales[1]).to(device))
    bt = rng.permutation(np.arange(1, n_pages + 1)).astype(np.int32)
    bt[-1] = 0  # the scratch page
    args = [torch.from_numpy(a).to(device) for a in (q, pools[0], pools[1], bt,
                                                      np.asarray(pos, np.int32))]
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("name", list(CHUNK_CASES))
def test_cuda_shared_kernel_at_chunk_shapes(cuda_device, name, quant):
    args, kw = _chunk_case(CHUNK_CASES[name], quant, len(name), cuda_device)
    key = pf.launch_key(True, CHUNK_CASES[name][2], quant)
    before = pf.kernel_launches()[key]
    got = pf.paged_flash_attention(*args, **kw)
    torch.cuda.synchronize()
    assert pf.kernel_launches()[key] == before + 1
    want = pf.paged_attention_plain(*args, **kw)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=ATOL, rtol=RTOL)
    dead = args[4] < 0
    if dead.any():
        assert float(got[dead].abs().max()) == 0.0
    # one owner for every sum: the output repeats bit for bit
    assert torch.equal(got, pf.paged_flash_attention(*args, **kw))


# the per-slot (decode) form at decode-step shapes: slots x page sizes x
# head widths (160 takes the wide kernel past the decode kernel's 128),
# over tables of 1024 positions; positions -1, 0, a page's last and the
# next page's first, a split boundary (127, 128), the table's last position
# and past the table, then seeded; one corrupt table entry (the kernel
# clamps it into the pool, as the JAX gather clamps: the plain version gets
# the clamped table)
DECODE_SLOTS = [1, 8, 16, 64]
DECODE_PAGE_SIZES = [8, 16, 32]
DECODE_WIDTHS = [6, 64, 80, 128, 160]


def _decode_step_case(slots, ps, d, quant, seed, device):
    rng = np.random.RandomState(seed)
    n_head = 2 if d > 64 else 4
    feat, n_pages = n_head * d, 1024 // ps
    pool_pages = n_pages + 2
    pools = [rng.randn(pool_pages * ps, feat).astype("float32") for _ in range(2)]
    kw = dict(n_head=n_head, page_size=ps)
    if quant:
        scales = [(np.abs(x).max(axis=1) / 127.0).astype("float32") for x in pools]
        pools = [np.clip(np.round(x / s[:, None]), -127, 127).astype(np.int8)
                 for x, s in zip(pools, scales)]
        kw.update(k_scales=torch.from_numpy(scales[0]).to(device),
                  v_scales=torch.from_numpy(scales[1]).to(device))
    edges = [-1, 0, ps - 1, ps, 127, 128, n_pages * ps - 1, n_pages * ps + 40]
    pos = np.array([edges[r] if r < len(edges) else rng.randint(-1, n_pages * ps)
                    for r in range(slots)], np.int32)
    bt = rng.randint(1, pool_pages, size=(slots, n_pages)).astype(np.int32)
    bt[0, 0] = 10 ** 6  # corrupt: clamped to the pool's last page
    q = rng.randn(slots, feat).astype("float32")
    args = [torch.from_numpy(a).to(device) for a in (q, pools[0], pools[1], bt, pos)]
    clamped = list(args)
    clamped[3] = args[3].clamp(0, pool_pages - 1)
    return args, clamped, kw


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("slots", DECODE_SLOTS)
def test_cuda_decode_kernel_at_step_shapes(cuda_device, slots, quant):
    for ps in DECODE_PAGE_SIZES:
        for d in DECODE_WIDTHS:
            args, clamped, kw = _decode_step_case(slots, ps, d, quant, slots + ps + d, cuda_device)
            key = pf.launch_key(False, d, quant)
            before = pf.kernel_launches()[key]
            got = pf.paged_flash_attention(*args, **kw)
            torch.cuda.synchronize()
            assert pf.kernel_launches()[key] == before + 1
            want = pf.paged_attention_plain(*clamped, **kw)
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=ATOL,
                                       rtol=RTOL, err_msg="page size %d, d %d" % (ps, d))
            dead = args[4] < 0
            if dead.any():
                assert float(got[dead].abs().max()) == 0.0
            # the splits merge in a fixed order: the output repeats bit for bit
            assert torch.equal(got, pf.paged_flash_attention(*args, **kw))


# heads past 128 on the wide kernel, both forms, at page sizes up to 128
# over tables of 1024 positions: the decode form at 9 slots (positions -1,
# 0, a page's last and the next page's first, a split boundary (63, 64),
# 127, the table's last position and past it), chunks of 1, 32 and 48 rows
# (pos = 0 and pos < 0 rows, up to the table's last position and past it);
# a corrupt table entry on a live position, clamped as the JAX gather
# clamps. A whole page of K and V passes a CTA's shared memory at d = 256
# with page size 128 and at d = 512 with page sizes 32 and 128: the kernel
# gathers position by position.
WIDE_PAGE_SIZES = [16, 32, 128]
WIDE_CASES = [("decode", None, d) for d in (256, 512)] + [
    ("chunk", rows, d) for rows in (1, 32, 48) for d in (160, 256, 512)]
WIDE_CHUNK_POS = {1: [1000], 32: list(range(50, 80)) + [0, -1],
                  48: list(range(980, 1024)) + [0, -1, 1023, 1064]}


def _wide_case(form, rows, d, ps, quant, seed, device):
    rng = np.random.RandomState(seed)
    n_head, n_pages = 2, 1024 // ps
    feat, pool_pages = n_head * d, n_pages + 2
    pools = [rng.randn(pool_pages * ps, feat).astype("float32") for _ in range(2)]
    kw = dict(n_head=n_head, page_size=ps)
    if quant:
        scales = [(np.abs(x).max(axis=1) / 127.0).astype("float32") for x in pools]
        pools = [np.clip(np.round(x / s[:, None]), -127, 127).astype(np.int8)
                 for x, s in zip(pools, scales)]
        kw.update(k_scales=torch.from_numpy(scales[0]).to(device),
                  v_scales=torch.from_numpy(scales[1]).to(device))
    if form == "chunk":
        pos = np.asarray(WIDE_CHUNK_POS[rows], np.int32)
        bt = rng.permutation(np.arange(1, pool_pages))[:n_pages].astype(np.int32)
        bt[1] = 10 ** 6  # corrupt: read by every chunk whose positions reach ps
    else:
        pos = np.array([-1, 0, ps - 1, ps, 63, 64, 127, 1023, 1064], np.int32)
        bt = rng.randint(1, pool_pages, size=(len(pos), n_pages)).astype(np.int32)
        bt[7, 1] = 10 ** 6  # corrupt, in the slot that reads every entry
    q = rng.randn(len(pos), feat).astype("float32")
    args = [torch.from_numpy(a).to(device) for a in (q, pools[0], pools[1], bt, pos)]
    clamped = list(args)
    clamped[3] = args[3].clamp(0, pool_pages - 1)
    return args, clamped, kw


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("ps", WIDE_PAGE_SIZES)
@pytest.mark.parametrize("form,rows,d", WIDE_CASES,
                         ids=["%s%s-d%d" % (f, r or "", d) for f, r, d in WIDE_CASES])
def test_cuda_wide_kernel_at_any_page_size(cuda_device, form, rows, d, ps, quant):
    args, clamped, kw = _wide_case(form, rows, d, ps, quant, (rows or 0) + d + ps, cuda_device)
    key = pf.launch_key(form == "chunk", d, quant)
    before = pf.kernel_launches()[key]
    got = pf.paged_flash_attention(*args, **kw)
    torch.cuda.synchronize()
    assert pf.kernel_launches()[key] == before + 1
    want = pf.paged_attention_plain(*clamped, **kw)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=ATOL, rtol=RTOL)
    dead = args[4] < 0
    if dead.any():
        assert float(got[dead].abs().max()) == 0.0
    # the splits merge in a fixed order: the output repeats bit for bit
    assert torch.equal(got, pf.paged_flash_attention(*args, **kw))
