"""Flash attention in the torch port (paddle_tpu_torch/ops/flash_attention.py,
layers.flash_attention, the fuse_attention pass, the use_flash Transformer):

- the op pair flash_attention / flash_attention_grad through both packages'
  Executor.run, the JAX side running its Pallas kernels in interpret mode
  (or its dense form where its path predicate declines a ragged length);
- the streamed (long-context) tiers of the JAX package, forced at a small
  length, against the port's plain versions;
- the path predicates and the Lse declaration equal to the JAX package's;
- FlashAttention.apply grads against jax.grad of the JAX flash_attention;
- the fuse_attention pass tag for tag against the JAX pass;
- a small use_flash Transformer trained 3 steps in both packages;
- the forward kernel's 3xTF32 online softmax, emulated in plain torch;
- on a CUDA card (`cuda` marker), each kernel against its plain version at
  head widths from 6 to 512 and at b * h past 65535, the tiny flash
  Transformer (d_key 8) and a small program of 160-wide heads against
  their CPU runs.

Tolerances, each with its reason:
- f32 against the JAX package: rtol 2e-4, atol 2e-5, the JAX package's own
  CPU bar for its flash kernel (tests/test_pallas_kernels.py:20-21): online
  vs one-pass softmax, sums in another order;
- the small Transformer: step-1 grads rtol 1e-4 (atol 1e-4 of the largest
  magnitude), losses and state rtol 2e-3 atol 2e-4, as in
  tests/test_torch_training.py;
- kernel vs plain on the card, f32: out and lse atol = rtol = 1e-5, grads
  rtol 1e-4 with atol 1e-4 of the plain result's largest magnitude (sums
  of up to tk terms in another order); bf16 against the f32 plain version
  on the same bf16-rounded inputs: 2e-2, the JAX package's on-chip bar;
- the tiny flash Transformer and the 160-wide program on the card against
  the CPU: losses rtol 2e-3, atol 2e-4, the fused-vs-unfused bar of
  tests/test_torch_training.py.

The JAX package is imported inside fixtures, so that on the card, where JAX
is not installed, the `cuda` cases run alone
(`python -m pytest --noconftest tests/test_torch_flash_attention.py -m cuda`).
"""

import collections

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.ops import flash_attention as fa

RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module")
def jax_mods():
    """(jax, jax.numpy, paddle_tpu.fluid, pallas_kernels) on the CPU."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import paddle_tpu.fluid as jfluid
    from paddle_tpu.ops import pallas_kernels

    return jax, jnp, jfluid, pallas_kernels


def _qkvg(seed, b, h, tq, tk, d):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, tq, d).astype("float32")
    k = rng.randn(b, h, tk, d).astype("float32")
    v = rng.randn(b, h, tk, d).astype("float32")
    g = rng.randn(b, h, tq, d).astype("float32")
    return q, k, v, g


# --------------------------------------------------------------------------
# the op pair through both packages' Executor.run
# --------------------------------------------------------------------------

OP_CASES = {
    # name: (b, h, tq, tk, d, causal)
    "t128": (2, 2, 128, 128, 16, False),
    "t128_causal": (2, 2, 128, 128, 16, True),
    "t32_unpacked_lse": (2, 2, 32, 32, 16, False),
    "t32_unpacked_lse_causal": (2, 2, 32, 32, 16, True),
    "tq512_tk600": (1, 2, 512, 600, 16, False),
    # 100 is one whole tile (under every block target): Lse is declared
    "t100_whole_tile_causal": (2, 2, 100, 100, 16, True),
    # 600 is ragged under the causal 512 target: no Lse, the JAX package
    # runs its dense form and its recompute-vjp
    "ragged_t600_no_lse": (1, 2, 600, 600, 16, True),
    "causal_tq256_tk128_masked_rows": (1, 2, 256, 128, 16, True),
    # head widths off 16: the kernels pad d to their built widths
    "d8_causal": (2, 2, 128, 128, 8, True),
    "d32": (2, 2, 128, 128, 32, False),
    "d96": (1, 2, 128, 128, 96, False),
    "d96_causal": (1, 2, 128, 128, 96, True),
    # heads wider than 128: the kernels take 128-wide column blocks
    "d160": (1, 2, 64, 64, 160, False),
    "d256_causal": (1, 2, 64, 64, 256, True),
}


def _op_program(pkg, backward, b, h, tq, tk, d, causal):
    """out = flash_attention(q, k, v); loss = sum(out * g), differentiated
    to q, k and v."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        L = pkg.layers
        q = L.data(name="q", shape=[h, tq, d], dtype="float32")
        k = L.data(name="k", shape=[h, tk, d], dtype="float32")
        v = L.data(name="v", shape=[h, tk, d], dtype="float32")
        g = L.data(name="g", shape=[h, tq, d], dtype="float32")
        for x in (q, k, v):
            x.stop_gradient = False
        out = L.flash_attention(q, k, v, causal=causal, sm_scale=d ** -0.5)
        loss = L.reduce_sum(L.elementwise_mul(out, g))
        backward.append_backward(loss)
    return main, startup, [out.name, "q@GRAD", "k@GRAD", "v@GRAD"]


@pytest.mark.parametrize("case", list(OP_CASES))
def test_op_pair_matches_jax(jax_mods, case):
    _, _, jfluid, _ = jax_mods
    from paddle_tpu.executor import Scope as JScope
    from paddle_tpu.executor import scope_guard as jscope_guard

    b, h, tq, tk, d, causal = OP_CASES[case]
    q, k, v, g = _qkvg(len(case), b, h, tq, tk, d)
    feed = {"q": q, "k": k, "v": v, "g": g}

    jmain, jstartup, fetch = _op_program(jfluid, jfluid.backward, b, h, tq, tk, d, causal)
    with jscope_guard(JScope(seed=0)):
        exe = jfluid.Executor()
        exe.run(jstartup)
        want = [np.asarray(x) for x in exe.run(jmain, feed=feed, fetch_list=fetch)]

    pmain, pstartup, _ = _op_program(pt, pt.backward, b, h, tq, tk, d, causal)
    with pt.scope_guard(pt.Scope(seed=0, place=pt.CPUPlace())):
        exe = pt.Executor(pt.CPUPlace())
        exe.run(pstartup)
        got = exe.run(pmain, feed=feed, fetch_list=fetch)

    def ops(prog):
        return [(op.type, sorted(op.outputs)) for op in prog.global_block().ops]

    assert ops(pmain) == ops(jmain)
    has_lse = fa.flash_path_taken(tq, tk, causal)
    fwd = next(op for op in pmain.global_block().ops if op.type == "flash_attention")
    assert ("Lse" in fwd.outputs) == has_lse == (case != "ragged_t600_no_lse")
    grad = next(op for op in pmain.global_block().ops if op.type == "flash_attention_grad")
    assert ("Lse" in grad.inputs) == has_lse
    assert "Lse@GRAD" not in grad.inputs  # a stop-gradient output: no cotangent
    for name, gv, wv in zip(fetch, got, want):
        np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=ATOL, err_msg=name)
    if tq > tk and causal:
        masked = tq - tk  # rows that see no key
        assert np.all(got[0][:, :, :masked] == 0.0) and np.all(got[1][:, :, :masked] == 0.0)
        assert np.all(want[0][:, :, :masked] == 0.0)


# --------------------------------------------------------------------------
# the JAX package's streamed tiers against the plain versions
# --------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_streamed_tiers_match_plain(jax_mods, monkeypatch, causal):
    _, jnp, _, pk = jax_mods
    monkeypatch.setattr(pk, "_resident_ok", lambda *a: False)
    b, h, t, d = 2, 2, 256, 32
    q, k, v, g = _qkvg(3, b, h, t, t, d)
    scale = d ** -0.5
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    jout, jlse = pk._flash_forward(jq, jk, jv, causal, scale, None, None, True, with_lse=True)
    jgrads = pk._flash_backward(jq, jk, jv, jout, jlse, jg, causal, scale, None, None, True)
    tq_, tk_, tv_, tg_ = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = fa.flash_forward_plain(tq_, tk_, tv_, causal, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=RTOL, atol=ATOL)
    grads = fa.flash_backward_plain(tq_, tk_, tv_, out, lse, tg_, causal, scale)
    for name, got, want in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL,
                                   err_msg="d" + name)


# --------------------------------------------------------------------------
# path predicates and the Lse declaration
# --------------------------------------------------------------------------

LENGTHS = [0, 1, 8, 32, 100, 128, 256, 384, 512, 600, 640, 1024, 1100, 1536, 2048, 3000,
           4096, 16384]


def test_predicates_match_jax(jax_mods):
    _, _, _, pk = jax_mods
    for t in LENGTHS:
        assert fa.flash_tiles_ok(t) == pk.flash_tiles_ok(t), t
        for block in (128, 256):
            assert fa.flash_tiles_ok(t, block) == pk.flash_tiles_ok(t, block), (t, block)
        for tk in LENGTHS:
            for causal in (False, True):
                assert fa.flash_path_taken(t, tk, causal) == pk.flash_path_taken(
                    t, tk, causal), (t, tk, causal)
    assert fa.flash_path_taken(512, 600, False) and not fa.flash_path_taken(512, 600, True)


@pytest.mark.parametrize("tq,tk,causal", [(512, 600, False), (512, 600, True), (32, 32, True),
                                          (100, 100, False), (4096, 4096, True)])
def test_lse_declared_in_the_same_programs(jax_mods, tq, tk, causal):
    _, _, jfluid, _ = jax_mods

    def declares(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            q = pkg.layers.data(name="q", shape=[2, tq, 8], dtype="float32")
            k = pkg.layers.data(name="k", shape=[2, tk, 8], dtype="float32")
            pkg.layers.flash_attention(q, k, k, causal=causal)
        (op,) = [o for o in main.global_block().ops if o.type == "flash_attention"]
        return "Lse" in op.outputs

    assert declares(pt) == declares(jfluid) == fa.flash_path_taken(tq, tk, causal)


# --------------------------------------------------------------------------
# autograd against jax.grad
# --------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_autograd_matches_jax_grad(jax_mods, causal):
    jax, jnp, _, pk = jax_mods
    q, k, v, g = _qkvg(11, 2, 2, 128, 128, 16)
    jg = jnp.asarray(g)

    def loss(a, b, c):
        return jnp.sum(pk.flash_attention(a, b, c, causal, None) * jg)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*ts, causal=causal)
    (out * torch.from_numpy(g)).sum().backward()
    for name, t, w in zip("qkv", ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg="d" + name)


# --------------------------------------------------------------------------
# fuse_attention against the JAX pass
# --------------------------------------------------------------------------


def _tiny_decoder(models):
    dec = models.GPTDecoder(vocab_size=64, d_model=32, n_head=4, n_layer=2, max_context=16,
                            prefix="tfa")
    return dec.build_forward(batch=1, t=8)


def _op_view(program):
    return [(op.type, sorted(op.input_arg_names), sorted(op.output_arg_names),
             {k: v for k, v in op.attrs.items() if k in ("causal", "sm_scale")})
            for op in program.global_block().ops]


@pytest.mark.parametrize("pipeline", [["fuse_attention"], ["constant_fold", "fuse_attention"]],
                         ids=["fuse_attention", "constant_fold_first"])
def test_fuse_attention_matches_jax_pass(jax_mods, pipeline):
    _, _, jfluid, _ = jax_mods
    from paddle_tpu import models as jmodels
    from paddle_tpu.executor import Scope as JScope
    from paddle_tpu.executor import scope_guard as jscope_guard
    from paddle_tpu.passes import PassManager as JPassManager

    from paddle_tpu_torch import models as pmodels
    from paddle_tpu_torch.passes import PassManager

    toks = np.random.RandomState(3).randint(0, 64, size=(1, 8, 1)).astype("int64")
    jmain, jstartup, feeds, fetches = _tiny_decoder(jmodels)
    jscope = JScope(seed=11)
    with jscope_guard(jscope):
        jfluid.Executor().run(jstartup)
        jfused = JPassManager(pipeline).apply(jmain, scope=jscope, feed_names=feeds,
                                              fetch_names=fetches)
    main, startup, pfeeds, pfetches = _tiny_decoder(pmodels)
    assert (pfeeds, pfetches) == (feeds, fetches)
    scope = pt.Scope(seed=11, place=pt.CPUPlace())
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(scope):
        exe.run(startup)
        (ref,) = exe.run(main, feed={feeds[0]: toks}, fetch_list=fetches)
        fused = PassManager(pipeline).apply(main, scope=scope, feed_names=feeds,
                                            fetch_names=fetches)
        (got,) = exe.run(fused, feed={feeds[0]: toks}, fetch_list=fetches)
    assert fused._pass_results["fuse_attention"] == jfused._pass_results["fuse_attention"]
    assert fused._pass_results["fuse_attention"]["fused"] == 2
    assert _op_view(fused) == _op_view(jfused)
    types = [op.type for op in fused.global_block().ops]
    assert "softmax" not in types and types.count("flash_attention") == 2
    assert np.abs(got - ref).max() < 1e-4


def test_fuse_attention_declines_on_fetched_softmax(jax_mods):
    from paddle_tpu import models as jmodels
    from paddle_tpu.passes import PassManager as JPassManager

    from paddle_tpu_torch import models as pmodels
    from paddle_tpu_torch.passes import PassManager

    results = []
    for models, manager, scope in ((jmodels, JPassManager, None),
                                   (pmodels, PassManager, pt.Scope(place=pt.CPUPlace()))):
        main, _, feeds, fetches = _tiny_decoder(models)
        sm_out = [op.output("Out")[0] for op in main.global_block().ops
                  if op.type == "softmax"][0]
        res = manager(["fuse_attention"]).apply(main, scope=scope, feed_names=feeds,
                                                fetch_names=list(fetches) + [sm_out])
        results.append((res._pass_results["fuse_attention"]["fused"], _op_view(res)))
    assert results[0][0] == results[1][0] == 1
    assert results[0][1] == results[1][1]


# --------------------------------------------------------------------------
# the small use_flash Transformer trained 3 steps in both packages
# --------------------------------------------------------------------------

STEPS = 3


@pytest.fixture(scope="module")
def flash_runs(jax_mods):
    from torch_transformer_case import SMALL_FLASH, jax_run, port_run

    j = jax_run(SMALL_FLASH, "training_fused", STEPS)
    p = port_run(SMALL_FLASH, "training_fused", j["init"], STEPS)
    return j, p


def test_flash_transformer_same_program(flash_runs):
    j, p = flash_runs
    assert j["grads"] == p["grads"] and j["names"] == p["names"]
    ops = collections.Counter(op.type for op in p["program"].global_block().ops)
    assert ops == j["ops"]
    # encoder self, decoder self (causal) and cross attention, each one op
    assert ops["flash_attention"] == ops["flash_attention_grad"] == 3
    assert "softmax" not in ops
    assert p["stats"]["dispatches"] == {k: STEPS * v for k, v in j["dispatches"].items()}
    assert not any(p["stats"]["launches"].values())  # the CPU takes the plain versions


def test_flash_transformer_step1_grads_match(flash_runs):
    j, p = flash_runs
    for g in j["grads"]:
        want = j["step1"][g]
        np.testing.assert_allclose(p["step1"][g], want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()), err_msg=g)


def test_flash_transformer_losses_and_state_match(flash_runs):
    j, p = flash_runs
    assert np.all(np.isfinite(p["losses"]))
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=2e-3, atol=2e-4)
    for n in j["names"]:
        np.testing.assert_allclose(p["final"][n], j["final"][n], rtol=2e-3, atol=2e-4,
                                   err_msg=n)


def test_tiny_flash_transformer_builds_the_same_program(jax_mods):
    _, _, jfluid, _ = jax_mods
    from paddle_tpu.models import transformer as jtransformer

    from paddle_tpu_torch.models import transformer as ptransformer

    views = []
    for pkg, tr in ((jfluid, jtransformer), (pt, ptransformer)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            feeds, loss = tr.build_tiny_flash_transformer()
        views.append((sorted(feeds), [(op.type, sorted(op.output_arg_names))
                                      for op in main.global_block().ops]))
    assert views[0] == views[1]
    feed = ptransformer.tiny_flash_transformer_feed(2)
    want = jtransformer.tiny_flash_transformer_feed(2)
    assert feed.keys() == want.keys()
    assert all(np.array_equal(feed[n], want[n]) for n in feed)


# --------------------------------------------------------------------------
# the forward kernel's 3xTF32 online softmax, emulated in plain torch
# --------------------------------------------------------------------------


def _tf32(x):
    """x cut to TF32 as the kernels' split and the tensor core's operand
    read do: the 13 low mantissa bits masked off."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def mm_3xtf32(a, b):
    """a @ b as 3xTF32: hi = the value cut to TF32, lo = the exact rest read
    as TF32, the three products lo.hi + hi.lo + hi.hi in f32 (the small
    terms first), summed from 0."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def online_softmax_3xtf32(q, k, v, causal, scale, keys=64, halves=1):
    """(out, lse) of one (b, h) slice as the tensor-core forward computes it:
    key tiles of `keys`, s = q k^T by 3xTF32 (over `halves` equal column
    groups of d, each summed from 0, then added in f32 in group order, as
    the wide forward's two warp groups do), an f32 online softmax, p rounded
    to the operand dtype before p v, and each tile's p v part summed from 0
    in 3xTF32 and added to the f32 accumulator."""
    tq, tk = q.shape[0], k.shape[0]
    rows = torch.arange(tq)[:, None]
    m = torch.full((tq, 1), float("-inf"))
    l = torch.zeros(tq, 1)
    o = torch.zeros(tq, v.shape[1])
    w = q.shape[1] // halves
    for k0 in range(0, tk, keys):
        s = mm_3xtf32(q[:, :w].float(), k[k0:k0 + keys, :w].float().T)
        for c in range(w, q.shape[1], w):
            s = s + mm_3xtf32(q[:, c:c + w].float(), k[k0:k0 + keys, c:c + w].float().T)
        s = s * scale
        cols = torch.arange(k0, min(k0 + keys, tk))[None, :]
        if causal:
            s = s.masked_fill(cols > rows + (tk - tq), float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=1, keepdim=True))
        alpha = torch.where(m == float("-inf"), torch.zeros(()), torch.exp(m - m_new))
        p = torch.where(s == float("-inf"), torch.zeros(()), torch.exp(s - m_new))
        l = l * alpha + p.sum(dim=1, keepdim=True)
        o = o * alpha + mm_3xtf32(p.to(q.dtype).float(), v[k0:k0 + keys].float())
        m = m_new
    denom = l.clamp_min(1e-20)
    lse = torch.where(m == float("-inf"), torch.zeros(()), m + torch.log(denom))
    return (o / denom).to(q.dtype), lse.squeeze(1)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_3xtf32_online_softmax_holds_the_flash_tolerance(causal):
    """An emulation of the accuracy argument for the tensor-core forward, in
    plain torch: it runs no port kernel and guards none (the `cuda` cases
    below and chip_smoke.py do; the tensor core's truncating sums are not
    modelled). At (2, 2, 256, 64), the split products, p rounded to the
    operand dtype and the per-key-tile sums from 0 land within the forward's
    kernel-vs-plain tolerance, atol = rtol = 1e-5, of flash_forward_plain;
    one TF32 product for each (hi.hi alone) misses it."""
    q, k, v, _ = (torch.from_numpy(x) for x in _qkvg(17, 2, 2, 256, 256, 64))
    scale = 64 ** -0.5
    want_out, want_lse = fa.flash_forward_plain(q, k, v, causal, scale)
    for bi in range(2):
        for hi in range(2):
            out, lse = online_softmax_3xtf32(q[bi, hi], k[bi, hi], v[bi, hi], causal, scale)
            torch.testing.assert_close(out, want_out[bi, hi], atol=1e-5, rtol=1e-5)
            torch.testing.assert_close(lse, want_lse[bi, hi], atol=1e-5, rtol=1e-5)
    one = _tf32(q[0, 0]) @ _tf32(k[0, 0]).T * scale
    exact = (q[0, 0].double() @ k[0, 0].double().T * scale)
    assert float((one.double() - exact).abs().max()) > 1e-5


@pytest.mark.parametrize("d, keys", [(256, 32), (512, 16)], ids=["d256", "d512"])
def test_wide_forward_score_halves_hold_the_flash_tolerance(d, keys):
    """An emulation of the accuracy argument for the wide forward (heads of
    129 to 512), in plain torch: it runs no port kernel and guards none (the
    `cuda` cases below and chip_smoke.py do; the tensor core's truncating
    sums are not modelled). Each of its two warp groups forms q k^T over its
    half of d (128 columns at d = 256, 256 at d = 512) by 3xTF32 summed
    from 0; the halves are added in f32, then the online softmax runs over
    key stages of 32 (d = 256) or 16 (d = 512, f32) keys. At (1, 2, 128,
    d), causal and not, this lands within the forward's kernel-vs-plain
    tolerance, atol = rtol = 1e-5, of flash_forward_plain."""
    q, k, v, _ = (torch.from_numpy(x) for x in _qkvg(d, 1, 2, 128, 128, d))
    scale = d ** -0.5
    for causal in (False, True):
        want_out, want_lse = fa.flash_forward_plain(q, k, v, causal, scale)
        for hi in range(2):
            out, lse = online_softmax_3xtf32(q[0, hi], k[0, hi], v[0, hi], causal, scale,
                                             keys=keys, halves=2)
            torch.testing.assert_close(out, want_out[0, hi], atol=1e-5, rtol=1e-5)
            torch.testing.assert_close(lse, want_lse[0, hi], atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# CPU tensors take the plain versions, uncounted
# --------------------------------------------------------------------------


@pytest.mark.parametrize("tk, d, fused", [
    (256, 64, True),  # the train-flash path's (16, 8, 256, 64) in chip_smoke.py
    (16384, 64, False),  # chip_smoke.py's long case takes the dK/dV + dQ pair
    (1, 64, True),
    (128, 64, True),
    (129, 64, True),  # two key tiles, the second ragged
    (257, 64, False),  # three key tiles: dQ partials past 2x dQ
    (256, 128, False),  # past the fused tier's padded head width of 64
    (256, 8, True),  # any head width up to 64 pads to it
    (200, 33, True),
    (256, 65, False),
    (257, 8, False),
])
def test_fused_backward_tier_predicate(tk, d, fused):
    assert fa.flash_bwd_fused_ok(tk, d) is fused
    n_parts = -(-tk // fa.FUSED_BWD_KEYS)
    assert (n_parts <= fa.FUSED_BWD_MAX_PARTIALS) or not fused


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_delta_matches_jax_expression(jax_mods, dtype):
    """delta = rowsum(dO * O) in f32, which the pair's delta kernel computes
    once per query row: the plain form the CPU takes against the JAX
    package's expression (pallas_kernels.py, _flash_backward_streamed)."""
    _, jnp, _, _ = jax_mods
    rng = np.random.RandomState(17)
    out = rng.randn(2, 3, 77, 96).astype("float32")
    dout = rng.randn(2, 3, 77, 96).astype("float32")
    to = torch.from_numpy(out).to(getattr(torch, dtype))
    tdo = torch.from_numpy(dout).to(getattr(torch, dtype))
    got = fa.flash_bwd_delta_plain(to, tdo)
    jdt = getattr(jnp, dtype)
    jo = jnp.asarray(to.float().numpy()).astype(jdt)
    jdo = jnp.asarray(tdo.float().numpy()).astype(jdt)
    want = np.asarray(jnp.sum(jdo.astype(jnp.float32) * jo.astype(jnp.float32), -1))
    assert got.dtype == torch.float32 and got.shape == (2, 3, 77)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_versions_uncounted():
    q, k, v, g = (torch.from_numpy(x) for x in _qkvg(5, 1, 2, 64, 64, 64))
    before = fa.kernel_launches()
    out, lse = fa.flash_forward(q, k, v, True, 0.125)
    want = fa.flash_forward_plain(q, k, v, True, 0.125)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    got = fa.flash_backward(q, k, v, out, lse, g, True, 0.125)
    want = fa.flash_backward_plain(q, k, v, out, lse, g, True, 0.125)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fa.kernel_launches() == before


# --------------------------------------------------------------------------
# on the card: each kernel against its plain version
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


CUDA_CASES = {
    # name: (b, h, tq, tk, d, causal, dtype, strided)
    "main": (4, 8, 256, 256, 64, False, torch.float32, True),
    "main_causal": (4, 8, 256, 256, 64, True, torch.float32, True),
    "ragged": (2, 3, 100, 77, 64, False, torch.float32, False),
    "ragged_causal_tk_longer": (2, 3, 77, 200, 64, True, torch.float32, False),
    "causal_masked_rows": (1, 2, 200, 128, 64, True, torch.float32, False),
    "d128": (2, 4, 256, 256, 128, False, torch.float32, True),
    "d128_causal": (2, 4, 192, 192, 128, True, torch.float32, False),
    "bf16": (2, 8, 256, 256, 64, False, torch.bfloat16, True),
    "bf16_causal_d128": (2, 4, 256, 256, 128, True, torch.bfloat16, False),
    # either side of the fused backward tier's cap (two 128-key tiles)
    "fused_at_cap": (2, 4, 192, 256, 64, False, torch.float32, True),
    "pair_past_cap": (2, 4, 192, 257, 64, False, torch.float32, False),
    "pair_past_cap_causal": (1, 4, 384, 384, 64, True, torch.float32, True),
    # causal with tq != tk inside the fused tier, both ways
    "fused_causal_tq_longer": (2, 3, 300, 200, 64, True, torch.float32, False),
    "fused_causal_tk_longer": (2, 3, 130, 256, 64, True, torch.float32, True),
    "bf16_fused_causal": (2, 4, 192, 256, 64, True, torch.bfloat16, False),
    # a long query side in the fused tier: dK and dV sum over 4096 rows
    "fused_long_queries": (1, 2, 4096, 128, 64, False, torch.float32, True),
}


def _cuda_case(name, device):
    b, h, tq, tk, d, causal, dtype, strided = CUDA_CASES[name]
    arrs = _qkvg(len(name), b, h, tq, tk, d)
    if strided:  # (b, t, h, d) memory seen as (b, h, t, d), as the model hands it over
        ts = [torch.from_numpy(a.transpose(0, 2, 1, 3).copy()).to(device).transpose(1, 2)
              for a in arrs]
    else:
        ts = [torch.from_numpy(a).to(device) for a in arrs]
    return [t.to(dtype) for t in ts], causal, d ** -0.5


def _grad_close(got, want, tol_r, tol_a):
    atol = tol_a * float(want.abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=tol_r, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CUDA_CASES))
def test_cuda_kernels_match_plain(cuda_device, name):
    (q, k, v, g), causal, scale = _cuda_case(name, cuda_device)
    form = "_causal" if causal else ""
    before = fa.kernel_launches()
    out, lse = fa.flash_forward(q, k, v, causal, scale)
    grads = fa.flash_backward(q, k, v, out, lse, g, causal, scale)
    torch.cuda.synchronize()
    after = fa.kernel_launches()
    fused = fa.flash_bwd_fused_ok(k.shape[2], k.shape[3])
    moved = ("flash_fwd", "flash_bwd_fused") if fused else (
        "flash_fwd", "flash_bwd_delta", "flash_bwd_dkv", "flash_bwd_dq")
    for kern in ("flash_fwd", "flash_bwd_fused", "flash_bwd_delta", "flash_bwd_dkv",
                 "flash_bwd_dq"):
        assert after[kern + form] == before[kern + form] + (kern in moved), kern
    # the plain version in f32 on the same (rounded) inputs
    f32 = [t.float() for t in (q, k, v, g)]
    pout, plse = fa.flash_forward_plain(*f32[:3], causal, scale)
    pgrads = fa.flash_backward_plain(*f32[:3], out.float(), lse, f32[3], causal, scale)
    if q.dtype == torch.float32:
        torch.testing.assert_close(out, pout, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(lse, plse, atol=1e-5, rtol=1e-5)
        for got, want in zip(grads, pgrads):
            _grad_close(got, want, 1e-4, 1e-4)
    else:
        torch.testing.assert_close(out.float(), pout, atol=2e-2, rtol=2e-2)
        for got, want in zip(grads, pgrads):
            scale_ = max(1.0, float(want.abs().max()))
            torch.testing.assert_close(got.float() / scale_, want / scale_, atol=2e-2, rtol=2e-2)
    tq, tk = q.shape[2], k.shape[2]
    if causal and tq > tk:
        assert float(out[:, :, : tq - tk].abs().max()) == 0.0
        assert float(lse[:, :, : tq - tk].abs().max()) == 0.0
        assert float(grads[0][:, :, : tq - tk].abs().max()) == 0.0
    # no float atomics: the backward repeats bit for bit
    again = fa.flash_backward(q, k, v, out, lse, g, causal, scale)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


# the dK/dV + dQ pair off its usual shapes: t past a 64-row tile, causal
# with tq < tk and tq > tk, bf16, and head widths 80, 160 and 256 (the last
# two in 128-wide column blocks: K / V, or q / dO, resident over every
# chunk); (b, h, tq, tk, d, causal, dtype)
PAIR_CASES = {
    "ragged_t": (1, 2, 577, 577, 64, False, torch.float32),
    "ragged_t_causal": (1, 2, 577, 577, 64, True, torch.float32),
    "causal_tq_300_tk_1000": (1, 2, 300, 1000, 64, True, torch.float32),
    "causal_tq_1000_tk_300": (1, 2, 1000, 300, 64, True, torch.float32),
    "bf16": (2, 2, 513, 513, 64, False, torch.bfloat16),
    "bf16_causal_tq_300_tk_1000": (1, 2, 300, 1000, 64, True, torch.bfloat16),
    "d80": (1, 3, 333, 333, 80, False, torch.float32),
    "d80_bf16_causal": (1, 3, 333, 333, 80, True, torch.bfloat16),
    "d160": (1, 3, 300, 420, 160, False, torch.float32),
    "d160_causal": (1, 3, 420, 300, 160, True, torch.float32),
    "d256": (1, 2, 290, 290, 256, False, torch.float32),
    "d256_bf16_causal": (1, 2, 290, 290, 256, True, torch.bfloat16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(PAIR_CASES))
def test_cuda_pair_matches_plain(cuda_device, name):
    """Each case takes the pair (past the fused tier's cap, or wider than
    64), matches the plain versions and repeats bit for bit."""
    b, h, tq, tk, d, causal, dtype = PAIR_CASES[name]
    q, k, v, g = _width_case(len(name) + d, b, h, tq, tk, d, dtype, cuda_device, tq == tk)
    assert _check_against_plain(q, k, v, g, causal, d ** -0.5) == "pair"


@pytest.mark.cuda
def test_cuda_autograd_matches_plain(cuda_device):
    (q, k, v, g), causal, scale = _cuda_case("main_causal", cuda_device)
    ts = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    (fa.flash_attention(*ts, causal=True) * g).sum().backward()
    out, lse = fa.flash_forward_plain(q, k, v, True, scale)
    want = fa.flash_backward_plain(q, k, v, out, lse, g, True, scale)
    for t, w in zip(ts, want):
        _grad_close(t.grad, w, 1e-4, 1e-4)


# head widths other than 64 and 128: up to 128 each kernel pads d to a built
# width and zero-fills the columns past it; wider heads take the wide
# forward (up to 512) or the chunked one (640), and the pair's 128-wide
# column blocks. tk = 200 takes the fused backward tier (d <= 64), tk = 300
# the dK/dV + dQ pair; rows of d % 4 != 0 elements load element by element
ANY_WIDTHS = [6, 8, 16, 32, 80, 96, 129, 160, 192, 256, 512, 640]


def _width_case(seed, b, h, tq, tk, d, dtype, device, strided):
    arrs = _qkvg(seed, b, h, tq, tk, d)
    if strided:
        ts = [torch.from_numpy(a.transpose(0, 2, 1, 3).copy()).to(device).transpose(1, 2)
              for a in arrs]
    else:
        ts = [torch.from_numpy(a).to(device) for a in arrs]
    return [t.to(dtype) for t in ts]


def _check_against_plain(q, k, v, g, causal, scale):
    """Forward and backward kernels against the plain versions (bf16
    against the f32 plain version on the same rounded inputs), and the
    backward repeated bit for bit; returns the tier the backward took."""
    form = "_causal" if causal else ""
    before = fa.kernel_launches()
    out, lse = fa.flash_forward(q, k, v, causal, scale)
    grads = fa.flash_backward(q, k, v, out, lse, g, causal, scale)
    torch.cuda.synchronize()
    after = fa.kernel_launches()
    fused = fa.flash_bwd_fused_ok(k.shape[2], k.shape[3])
    moved = ("flash_fwd", "flash_bwd_fused") if fused else (
        "flash_fwd", "flash_bwd_delta", "flash_bwd_dkv", "flash_bwd_dq")
    for kern in ("flash_fwd", "flash_bwd_fused", "flash_bwd_delta", "flash_bwd_dkv",
                 "flash_bwd_dq"):
        assert after[kern + form] == before[kern + form] + (kern in moved), kern
    f32 = [t.float() for t in (q, k, v, g)]
    pout, plse = fa.flash_forward_plain(*f32[:3], causal, scale)
    pgrads = fa.flash_backward_plain(*f32[:3], out.float(), lse, f32[3], causal, scale)
    assert out.shape == q.shape and all(a.shape == b.shape for a, b in zip(grads, (q, k, v)))
    if q.dtype == torch.float32:
        torch.testing.assert_close(out, pout, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(lse, plse, atol=1e-5, rtol=1e-5)
        for got, want in zip(grads, pgrads):
            _grad_close(got, want, 1e-4, 1e-4)
    else:
        torch.testing.assert_close(out.float(), pout, atol=2e-2, rtol=2e-2)
        for got, want in zip(grads, pgrads):
            scale_ = max(1.0, float(want.abs().max()))
            torch.testing.assert_close(got.float() / scale_, want / scale_, atol=2e-2, rtol=2e-2)
    again = fa.flash_backward(q, k, v, out, lse, g, causal, scale)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    return "fused" if fused else "pair"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", ANY_WIDTHS)
def test_cuda_takes_any_head_width(cuda_device, d, dtype):
    tiers = set()
    for i, (tq, tk, causal, strided) in enumerate([(200, 200, False, True),
                                                   (150, 200, True, False),
                                                   (300, 300, False, False),
                                                   (300, 300, True, True)]):
        q, k, v, g = _width_case(d + i, 2, 3, tq, tk, d, dtype, cuda_device, strided)
        tiers.add(_check_against_plain(q, k, v, g, causal, d ** -0.5))
    assert tiers == ({"fused", "pair"} if d <= fa.FUSED_BWD_HEAD_DIM else {"pair"})


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [256, 512])
def test_cuda_wide_forward_repeats_bit_for_bit(cuda_device, d, dtype, causal):
    """The wide forward at a timed width: out and lse against the plain
    version (bf16 against the f32 plain version on the same rounded
    inputs), and both repeated bit for bit (both warp groups sum the same
    s in the same order, no float atomics)."""
    q, k, v, _ = _width_case(d + causal, 2, 4, 256, 256, d, dtype, cuda_device, True)
    out, lse = fa.flash_forward(q, k, v, causal, d ** -0.5)
    torch.cuda.synchronize()
    pout, plse = fa.flash_forward_plain(q.float(), k.float(), v.float(), causal, d ** -0.5)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), pout, atol=tol, rtol=tol)
    if dtype == torch.float32:
        torch.testing.assert_close(lse, plse, atol=1e-5, rtol=1e-5)
    for _ in range(3):
        out2, lse2 = fa.flash_forward(q, k, v, causal, d ** -0.5)
        assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_cuda_takes_b_times_h_past_65535(cuda_device, causal):
    """b * h rides grid x with the tile index, so (65600, 1, 32, 16) runs:
    past the 65535 of grid y, where it once rode."""
    q, k, v, g = _width_case(3, 65600, 1, 32, 32, 16, torch.float32, cuda_device, False)
    assert _check_against_plain(q, k, v, g, causal, 0.25) == "fused"


@pytest.mark.cuda
def test_cuda_tiny_flash_transformer_matches_cpu(cuda_device):
    """build_tiny_flash_transformer (d_key 8) trained 3 Adam steps on the
    card, through the flash kernels, against the same steps on the CPU
    from the same weights."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.models import transformer as ptransformer

    init, runs = None, []
    for place in (pt.CPUPlace(), pt.CUDAPlace(0)):
        main, startup = pt.Program(), pt.Program()
        with pt.unique_name.guard(), pt.program_guard(main, startup):
            _, loss = ptransformer.build_tiny_flash_transformer()
            pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
        names = convert.persistable_names(main)
        scope = pt.Scope(seed=0, place=place)
        exe = pt.Executor(place)
        before = fa.kernel_launches()
        with pt.scope_guard(scope):
            exe.run(startup)
            if init is None:
                init = convert.scope_to_numpy(scope, names)
            else:
                convert.load_into_scope(scope, init, names)
            losses = [float(np.asarray(exe.run(
                main, feed=ptransformer.tiny_flash_transformer_feed(2, seed=s),
                fetch_list=[loss.name])[0]).reshape(-1)[0]) for s in range(3)]
        moved = {k: n - before[k] for k, n in fa.kernel_launches().items() if n != before[k]}
        runs.append((np.asarray(losses), moved))
    (cpu, cpu_moved), (card, card_moved) = runs
    assert not cpu_moved
    # 3 steps, each with its encoder self, decoder self (causal) and cross
    # attention forward and backward (the fused tier: d_key 8, t = 16)
    assert card_moved == {"flash_fwd": 6, "flash_fwd_causal": 3, "flash_bwd_fused": 6,
                          "flash_bwd_fused_causal": 3}
    assert np.all(np.isfinite(card))
    np.testing.assert_allclose(card, cpu, rtol=2e-3, atol=2e-4)


def _wide_head_program(h, t, d):
    """x [t, h * d] -> q, k, v by fc, as (1, h, t, d) heads, causal
    flash_attention, an fc back to h * d, loss = mean of its square."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        L = pt.layers
        x = L.data(name="x", shape=[t, h * d], dtype="float32", append_batch_size=False)
        heads = [L.transpose(L.reshape(L.fc(x, h * d), [1, t, h, d]), [0, 2, 1, 3])
                 for _ in range(3)]
        out = L.flash_attention(*heads, causal=True, sm_scale=d ** -0.5)
        y = L.fc(L.reshape(L.transpose(out, [0, 2, 1, 3]), [t, h * d]), h * d)
        loss = L.mean(L.elementwise_mul(y, y))
        pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


@pytest.mark.cuda
def test_cuda_wide_head_program_matches_cpu(cuda_device):
    """A program of 160-wide heads (the kernels' column blocks, the
    backward's dK/dV + dQ pair) trained 3 Adam steps on the card against
    the same steps on the CPU from the same weights."""
    from paddle_tpu_torch import convert

    h, t, d = 2, 96, 160
    feeds = [{"x": np.random.RandomState(s).randn(t, h * d).astype("float32")}
             for s in range(3)]
    init, runs = None, []
    for place in (pt.CPUPlace(), pt.CUDAPlace(0)):
        main, startup, loss = _wide_head_program(h, t, d)
        names = convert.persistable_names(main)
        scope = pt.Scope(seed=0, place=place)
        exe = pt.Executor(place)
        before = fa.kernel_launches()
        with pt.scope_guard(scope):
            exe.run(startup)
            if init is None:
                init = convert.scope_to_numpy(scope, names)
            else:
                convert.load_into_scope(scope, init, names)
            losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss.name])[0])
                            .reshape(-1)[0]) for f in feeds]
        moved = {k: n - before[k] for k, n in fa.kernel_launches().items() if n != before[k]}
        runs.append((np.asarray(losses), moved))
    (cpu, cpu_moved), (card, card_moved) = runs
    assert not cpu_moved
    assert card_moved == {"flash_fwd_causal": 3, "flash_bwd_delta_causal": 3,
                          "flash_bwd_dkv_causal": 3, "flash_bwd_dq_causal": 3}
    assert np.all(np.isfinite(card))
    np.testing.assert_allclose(card, cpu, rtol=2e-3, atol=2e-4)


def test_wide_head_program_trains_on_the_cpu():
    """The 160-wide program of the card test above runs its 3 steps on the
    CPU (the plain versions, no kernel launch) with finite, falling
    losses."""
    main, startup, loss = _wide_head_program(2, 96, 160)
    before = fa.kernel_launches()
    with pt.scope_guard(pt.Scope(seed=0, place=pt.CPUPlace())):
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup)
        feed = {"x": np.random.RandomState(0).randn(96, 320).astype("float32")}
        losses = [float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss.name])[0])
                        .reshape(-1)[0]) for _ in range(3)]
    assert fa.kernel_launches() == before
    assert np.all(np.isfinite(losses)) and losses[2] < losses[0]
