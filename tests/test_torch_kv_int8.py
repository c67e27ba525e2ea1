"""Int8 paged KV generation in the torch port (paddle_tpu_torch
ops/paged_flash.py int8 forms, ops/generation_ops.py int8 kv_cache_write,
serving/generation.py int8 pools) against the JAX package, at the small
size of tests/test_quant.py (KV_KW), and — on a CUDA card — the int8 paged
kernels against their plain version.

Tolerances, each with its reason:
- int8 paged attention, plain vs the JAX Pallas kernel (interpret mode)
  and vs the JAX dense lowering: atol = rtol = 1e-5. Both sides dequantize
  as float(level) * scale[row], one rounding, and sum in f32 in another
  order.
- int8 kv_cache_write: levels within +-1 of JAX's (a row that differs by
  an ulp may round to the neighbouring level) and scales at rtol 1e-6; rows
  the scatter never touched keep scale 1.0.
- the int8 GenerationEngine against JAX's on the same weights: last logits
  within 1e-4 (f32 on both sides, over 2 layers), equal greedy tokens; and
  against the port's own f32-pool engine, a drift below 0.05 (the JAX
  package's bar, tests/test_quant.py).
- on the card: kernel vs plain, atol = rtol = 1e-5.

The JAX package is imported inside a fixture, so that on the card, where
JAX is not installed, the `cuda` cases run alone
(`python -m pytest --noconftest tests/test_torch_kv_int8.py -m cuda`)."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import CPUPlace, Scope, convert
from paddle_tpu_torch import flags as pt_flags
from paddle_tpu_torch.models import GPTDecoder
from paddle_tpu_torch.ops import paged_flash as pf
from paddle_tpu_torch.ops import registry as pt_registry
from paddle_tpu_torch.serving import GenerationEngine, GenRequest

ATOL = RTOL = 1e-5
LOGIT_ATOL = LOGIT_RTOL = 1e-4
KV_KW = dict(vocab_size=48, n_layer=2, n_head=2, d_model=16, d_inner=32, max_context=16)
ENGINE_KW = dict(page_size=4, prefill_buckets=(16,))
NO_EOS = 999

# (rows, n_head, d, page_size, table pages, pool pages, positions); a table
# entry of 0 is the scratch page
DECODE_CASES = {
    "boundaries": (6, 2, 8, 4, 3, 12, [2, 3, 4, 7, 11, -1]),
    "beyond_table": (3, 3, 16, 8, 2, 9, [15, 16, 40]),
    # d = 64 takes the kernel's 16-byte level vectors
    "vector_rows": (4, 2, 64, 4, 5, 30, [19, 0, 7, -1]),
    "split_walk": (4, 2, 8, 4, 10, 45, [39, 17, 16, 3]),
    # d = 64 heads over tables longer than one 128-position split of the
    # decode kernel, at page sizes 8 and 32
    "ps8_long_table": (4, 2, 64, 8, 40, 90, [319, 200, 128, -1]),
    "ps32_long_table": (3, 2, 64, 32, 12, 20, [383, 127, 129]),
    "ps16_split_edges": (4, 3, 64, 16, 24, 60, [255, 256, 383, 0]),
    # a head of 256 over pages of 128 rows (a whole page of K and V passes
    # a CTA's shared memory: the wide kernel gathers by position), across a
    # split and a page boundary
    "d256_ps128": (3, 1, 256, 128, 3, 6, [300, 128, -1]),
}
SHARED_CASES = {
    "mid_page_chunk": (6, 2, 8, 4, 3, 10, list(range(5, 11))),
    "padded_tail": (5, 3, 8, 4, 2, 7, [6, 7, 8, 9, -1]),
    "vector_chunk": (8, 2, 64, 4, 4, 9, list(range(6, 14))),
    "split_walk_chunk": (40, 2, 8, 4, 12, 14, list(range(6, 46))),
    # a chunk of heads of 512 over pages of 32 rows (the same fault, shared
    # form), with a dead row
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
    """Seeded int8 pools with per-row scales (row absmax / 127 of f32 rows,
    as kv_cache_write makes them)."""
    rows, n_head, d, ps, p, n_pages, pos = spec
    rng = np.random.RandomState(seed)
    feat = n_head * d
    q = rng.randn(rows, feat).astype("float32")
    pools = []
    for _ in range(2):
        x = rng.randn(n_pages * ps, feat).astype("float32")
        scale = (np.abs(x).max(axis=1) / 127.0).astype("float32")
        pools += [np.clip(np.round(x / scale[:, None]), -127, 127).astype(np.int8), scale]
    if shared:
        bt = rng.choice(np.arange(1, n_pages), p, replace=False).astype(np.int32)
        bt[-1] = 0
    else:
        bt = np.stack([rng.choice(np.arange(1, n_pages), p, replace=False)
                       for _ in range(rows)]).astype(np.int32)
        bt[0, -1] = 0
    kp, ks, vp, vs = pools
    return (q, kp, vp, bt, np.asarray(pos, np.int32), ks, vs), n_head, ps


def _torch(arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _all_cases():
    return [(k, DECODE_CASES[k], False) for k in DECODE_CASES] + [
        (k, SHARED_CASES[k], True) for k in SHARED_CASES]


def _call(fn, arrays, n_head, ps):
    q, kp, vp, bt, pos, ks, vs = arrays
    return fn(q, kp, vp, bt, pos, n_head=n_head, page_size=ps, k_scales=ks, v_scales=vs)


@pytest.mark.parametrize("name,spec,shared", _all_cases(), ids=[c[0] for c in _all_cases()])
def test_int8_plain_matches_jax_pallas_kernel(jax_ref, name, spec, shared):
    jnp, _, jax_pk, _ = jax_ref
    arrays, n_head, ps = _case(spec, shared, seed=len(name))
    q, kp, vp, bt, pos, ks, vs = (jnp.asarray(a) for a in arrays)
    want = jax_pk.paged_flash_attention(q, kp, vp, bt, pos, n_head=n_head, page_size=ps,
                                        k_scales=ks, v_scales=vs, interpret=True)
    got = _call(pf.paged_attention_plain, _torch(arrays), n_head, ps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    assert np.all(got.numpy()[arrays[4] < 0] == 0.0)


@pytest.mark.parametrize("name,spec,shared", _all_cases(), ids=[c[0] for c in _all_cases()])
def test_int8_op_matches_jax_dense_lowering(jax_ref, name, spec, shared):
    """The paged_attention op with KScales/VScales in both packages with
    FLAGS_paged_flash="off" (the dense gather forms)."""
    jnp, jax_flags, _, jax_registry = jax_ref
    arrays, n_head, ps = _case(spec, shared, seed=7 + len(name))
    slots = ("Q", "KPool", "VPool", "BlockTable", "Pos", "KScales", "VScales")
    attrs = {"n_head": n_head, "page_size": ps}
    jsaved, psaved = jax_flags.get_flags("paged_flash"), pt_flags.get_flags("paged_flash")
    jax_flags.set_flags({"paged_flash": "off"})
    pt_flags.set_flags({"paged_flash": "off"})
    try:
        want = jax_registry.get("paged_attention").lower(
            None, {k: [jnp.asarray(a)] for k, a in zip(slots, arrays)}, attrs)["Out"][0]
        got = pt_registry.get("paged_attention").lower(
            pt_registry.LowerCtx("cpu"), {k: [t] for k, t in zip(slots, _torch(arrays))},
            attrs)["Out"][0]
    finally:
        jax_flags.set_flags(jsaved)
        pt_flags.set_flags(psaved)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shared", [False, True], ids=["decode", "chunk"])
def test_int8_kv_cache_write_matches_jax(jax_ref, shared):
    jnp, _, _, jax_registry = jax_ref
    rng = np.random.RandomState(11 + shared)
    ps, n_pages, feat = 4, 8, 12
    rows = rng.randn(6, feat).astype("float32") * 3
    rows[2] = 0.0  # an all-zero row: the 1e-8 floor keeps its scale finite
    if shared:
        bt = np.array([3, 5, 1, 0], np.int32)
        pos = np.arange(4, 10, dtype=np.int32)
    else:
        bt = rng.choice(np.arange(1, n_pages), (6, 2)).astype(np.int32)
        pos = np.array([0, 5, 3, 7, 6, 1], np.int32)
    pool = np.zeros((n_pages * ps, feat), np.int8)
    scales = np.ones(n_pages * ps, np.float32)
    attrs = {"page_size": ps}
    jout = jax_registry.get("kv_cache_write").lower(None, {
        "Pool": [jnp.asarray(pool)], "Rows": [jnp.asarray(rows)], "BlockTable": [jnp.asarray(bt)],
        "Pos": [jnp.asarray(pos)], "Scales": [jnp.asarray(scales)]}, attrs)
    ppool, pscales = torch.from_numpy(pool.copy()), torch.from_numpy(scales.copy())
    pout = pt_registry.get("kv_cache_write").lower(pt_registry.LowerCtx("cpu"), {
        "Pool": [ppool], "Rows": [torch.from_numpy(rows)], "BlockTable": [torch.from_numpy(bt)],
        "Pos": [torch.from_numpy(pos)], "Scales": [pscales]}, attrs)
    assert pout["Out"][0] is ppool and pout["OutScales"][0] is pscales  # in place
    want_q, want_s = np.asarray(jout["Out"][0]), np.asarray(jout["OutScales"][0])
    assert ppool.dtype == torch.int8
    assert np.abs(ppool.numpy().astype(int) - want_q.astype(int)).max() <= 1
    np.testing.assert_allclose(pscales.numpy(), want_s, rtol=1e-6)
    written = np.zeros(n_pages * ps, bool)
    flat = (bt[pos // ps] if shared else bt[np.arange(6), pos // ps]) * ps + pos % ps
    written[flat] = True
    assert (pscales.numpy()[~written] == 1.0).all()


def test_int8_cpu_tensors_take_the_plain_version_uncounted():
    arrays, n_head, ps = _case(DECODE_CASES["boundaries"], False, seed=3)
    args = _torch(arrays)
    before = pf.kernel_launches()
    got = _call(pf.paged_flash_attention, args, n_head, ps)
    assert torch.equal(got, _call(pf.paged_attention_plain, args, n_head, ps))
    assert pf.kernel_launches() == before


@pytest.fixture(scope="module")
def int8_engines(jax_ref):
    """(JAX int8 engine, port int8 engine carrying its weights, port f32
    engine on the same weights), 2 f32 slots / 4 int8 slots as in the JAX
    package's test."""
    from paddle_tpu.executor import Scope as JScope
    from paddle_tpu.models.gpt_decoder import GPTDecoder as JGPTDecoder
    from paddle_tpu.serving import GenerationEngine as JEngine

    jeng = JEngine(JGPTDecoder(kv_dtype="int8", **KV_KW), name="tkv_jax_i8", max_slots=4,
                   cache_dir=None, scope=JScope(seed=5), **ENGINE_KW)
    jeng.warmup()
    model = GPTDecoder(kv_dtype="int8", **KV_KW)
    peng = GenerationEngine(model, name="tkv_port_i8", max_slots=4,
                            scope=Scope(seed=5, place=CPUPlace()), **ENGINE_KW)
    f32 = GenerationEngine(GPTDecoder(**KV_KW), name="tkv_port_f32", max_slots=2,
                           scope=Scope(seed=5, place=CPUPlace()), **ENGINE_KW)
    arrays = {n: np.asarray(jeng.scope.vars[n]) for n in model.param_names()}
    for eng in (peng, f32):
        eng.warmup()
        convert.load_into_scope(eng.scope, arrays, model.param_names())
    return jeng, peng, f32


def test_int8_engine_pools(int8_engines):
    jeng, peng, f32 = int8_engines
    st = peng.stats()
    assert st["kv"]["dtype"] == "int8" and st["pool"]["storage_dtype"] == "int8"
    for (k, v), (ks, vs) in zip(peng.model.kv_pool_names(), peng.model.kv_scale_names()):
        assert peng.scope.vars[k].dtype == torch.int8
        assert peng.scope.vars[ks].dtype == torch.float32
    # level pools + scale pools, as the JAX engine counts them
    assert peng.kv_state_bytes == jeng.kv_state_bytes
    assert peng.pool.row_bytes == jeng.pool.row_bytes
    # twice the slots in fewer bytes than the f32 pools
    assert peng.kv_state_bytes < 0.75 * f32.kv_state_bytes
    assert set(st["kernel_dispatches"]) >= {"paged_flash_int8", "paged_flash_shared_int8"}


@pytest.mark.parametrize("prompt,n_new", [([3, 7, 11, 2, 9], 4), ([1, 2], 6),
                                          ([9, 8, 7, 6, 5, 4, 3, 2, 1], 5)])
def test_int8_engine_matches_jax_engine(int8_engines, prompt, n_new):
    jeng, peng, _ = int8_engines
    want = jeng.generate(prompt, max_new_tokens=n_new, eos_id=NO_EOS)
    want_logits = np.array(jeng.last_logits[0])
    got = peng.generate(prompt, max_new_tokens=n_new, eos_id=NO_EOS)
    np.testing.assert_allclose(np.array(peng.last_logits[0]), want_logits,
                               atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    assert got.tokens == want.tokens


def test_int8_engine_drift_against_f32_pools(int8_engines):
    _, peng, f32 = int8_engines
    rng = np.random.RandomState(2)
    for _ in range(2):
        p = [int(t) for t in rng.randint(0, KV_KW["vocab_size"], size=int(rng.randint(3, 10)))]
        r32 = f32.generate(p, max_new_tokens=4, eos_id=NO_EOS)
        l32 = np.array(f32.last_logits[0])
        ri8 = peng.generate(p, max_new_tokens=4, eos_id=NO_EOS)
        li8 = np.array(peng.last_logits[0])
        assert len(r32.tokens) == len(ri8.tokens)
        assert np.abs(l32 - li8).max() / (np.abs(l32).max() + 1e-9) < 0.05


def test_int8_engine_write_trail(int8_engines):
    """Written pool rows hold int8 levels with a positive scale; rows the
    scatter never touched keep the 1.0 boot scale."""
    _, peng, _ = int8_engines
    run = peng.start(GenRequest([1, 2, 3, 4, 5], max_new_tokens=3, eos_id=NO_EOS))
    try:
        while not run.done:
            peng.decode_step([run])
        wrote = 0
        for (k, _), (ks, _) in zip(peng.model.kv_pool_names(), peng.model.kv_scale_names()):
            lv, sc = peng._state[k].numpy(), peng._state[ks].numpy()
            written = np.abs(lv).max(axis=1) > 0
            wrote += int(written.sum())
            assert (sc[written] > 0).all()
        assert wrote >= 5 * peng.model.n_layer
    finally:
        peng.finish(run)


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the int8 paged flash kernels have no CPU form")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,spec,shared", _all_cases(), ids=[c[0] for c in _all_cases()])
def test_cuda_int8_kernel_matches_plain(cuda_device, name, spec, shared):
    arrays, n_head, ps = _case(spec, shared, seed=31 + len(name))
    args = _torch(arrays, cuda_device)
    key = pf.launch_key(shared, spec[2], True)
    before = pf.kernel_launches()[key]
    got = _call(pf.paged_flash_attention, args, n_head, ps)
    torch.cuda.synchronize()
    assert pf.kernel_launches()[key] == before + 1
    want = _call(pf.paged_attention_plain, args, n_head, ps)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=ATOL, rtol=RTOL)
    assert np.all(got.cpu().numpy()[arrays[4] < 0] == 0.0)
