"""The generation slice of the torch port as a whole (paddle_tpu_torch
serving/generation.py, models/gpt_decoder.py, executor.py, convert.py)
against the JAX package, at the small size of tests/test_generation.py.

- Parameters made by the JAX engine's startup program are carried into the
  port by convert.load_into_scope; prefill logits and every decode step's
  logits then match the JAX GenerationEngine within atol = rtol = 1e-4
  (f32 on both sides; XLA and torch sum matmuls, layer_norm and softmax in
  different orders, over 2 layers), and greedy token streams are equal.
- Inside the port: continuous batching against serial decode, chunked
  prefill against whole-prompt prefill, and no variant rebuilt after
  warmup.
- The three GPTDecoder programs build to the same ops and var shapes in
  both packages (shape inference on meta tensors vs jax.eval_shape).
"""

import numpy as np
import pytest

from paddle_tpu.models.gpt_decoder import GPTDecoder as JaxGPTDecoder
from paddle_tpu.serving import GenerationEngine as JaxEngine
from paddle_tpu.serving import GenRequest as JaxGenRequest
from paddle_tpu_torch import CPUPlace, convert
from paddle_tpu_torch.executor import aot_serve_lowering, scope_guard
from paddle_tpu_torch.models import GPTDecoder
from paddle_tpu_torch.serving import GenerationEngine, GenerationScheduler, GenRequest

MODEL_KW = dict(
    vocab_size=24, n_layer=2, n_head=2, d_model=16, d_inner=32, max_context=16
)
ENGINE_KW = dict(max_slots=3, page_size=4, max_context=16)
NO_EOS = 999  # never sampled: every request runs to its length
ATOL = RTOL = 1e-4

CASES = [
    ([3, 7, 11, 2, 9], 3),
    ([1, 2], 6),
    ([5, 6, 7], 5),
    ([9, 8, 7, 6, 5, 4, 3], 7),
    ([2, 4], 4),
    ([13, 12, 11, 10], 5),
]


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine on the CPU carrying the JAX parameters)."""
    jeng = JaxEngine(JaxGPTDecoder(**MODEL_KW), name="tt_jax", cache_dir=None, **ENGINE_KW)
    jeng.warmup()
    model = GPTDecoder(**MODEL_KW)
    peng = GenerationEngine(model, name="tt_port", place=CPUPlace(), **ENGINE_KW)
    peng.warmup()
    arrays = {n: np.asarray(jeng.scope.vars[n]) for n in model.param_names()}
    convert.load_into_scope(peng.scope, arrays, model.param_names())
    return jeng, peng


def _stepwise_logits(eng, req_cls, prompt, n_new):
    run = eng.start(req_cls(prompt, max_new_tokens=n_new, eos_id=NO_EOS))
    rows = [np.array(eng.last_prefill_logits)]
    try:
        while not run.done:
            eng.decode_step([run])
            rows.append(np.array(eng.last_logits[run.slot]))
    finally:
        eng.finish(run)
    return rows, list(run.tokens)


@pytest.mark.parametrize("prompt,n_new", CASES[:4])
def test_logits_and_greedy_tokens_match_jax_engine(engines, prompt, n_new):
    jeng, peng = engines
    want, want_tokens = _stepwise_logits(jeng, JaxGenRequest, prompt, n_new)
    got, got_tokens = _stepwise_logits(peng, GenRequest, prompt, n_new)
    assert len(got) == len(want) == n_new
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg="step %d" % step)
    assert got_tokens == want_tokens


def test_continuous_batch_matches_serial_decode(engines):
    _, eng = engines
    serial = [eng.generate(p, max_new_tokens=m, eos_id=NO_EOS) for p, m in CASES]
    sched = GenerationScheduler(eng, timeout_ms=60000.0)
    try:
        futs = [sched.submit(p, max_new_tokens=m, eos_id=NO_EOS) for p, m in CASES]
        results = [f.result(60) for f in futs]
    finally:
        assert sched.close(drain=True)
    for (p, m), want, got in zip(CASES, serial, results):
        assert got.tokens == want.tokens, (p, got.tokens, want.tokens)
        assert got.finish_reason == want.finish_reason == "length"
    assert eng.pool.stats()["slots_in_use"] == 0
    assert eng.traces == len(eng._variants) == 5, "hot loop rebuilt a variant"


def test_chunked_prefill_matches_whole_prompt(engines):
    """Chunks of 4 rows (several calls crossing pages) give the prefill
    logits of one whole-prompt chunk, and the same greedy stream."""
    _, src = engines
    names = src.model.param_names()
    arrays = {n: src.scope.vars[n].numpy() for n in names}
    out = []
    for chunk in (16, 4):
        eng = GenerationEngine(
            GPTDecoder(**MODEL_KW), name="tt_chunk%d" % chunk, place=CPUPlace(),
            prefill_chunk=chunk, prefix_cache=False, **ENGINE_KW,
        )
        convert.load_into_scope(eng.scope, arrays, names)
        res = eng.generate([4, 9, 1, 13, 2, 8, 21, 5, 3, 17, 6], max_new_tokens=4, eos_id=NO_EOS)
        out.append((eng.stats()["prefill_chunks"], np.array(eng.last_prefill_logits), res.tokens))
    (n_whole, whole, t_whole), (n_chunked, chunked, t_chunked) = out
    assert (n_whole, n_chunked) == (1, 3)  # 11 rows; then 4 + 4 + 3 rows
    np.testing.assert_allclose(chunked, whole, atol=1e-5, rtol=1e-5)
    assert t_chunked == t_whole


def test_paged_decode_matches_dense_forward(engines):
    """The paged prefill/decode logits against the whole-sequence dense
    program (build_forward) on the same parameters, within 1e-5: same math,
    different cache plumbing and summation order."""
    _, eng = engines
    T = 16
    main, _, feeds, fetches = eng.model.build_forward(1, T)
    with scope_guard(eng.scope):
        serve, ro, mut = aot_serve_lowering(main, feeds, fetches, eng.scope)
    assert not mut

    def dense_row(tokens):
        buf = np.zeros((1, T, 1), np.int64)
        buf[0, :len(tokens), 0] = tokens
        (lg,) = serve({"fwd_tokens": buf}, ro, {})
        return lg.numpy()[0, len(tokens) - 1]

    prompt = [3, 7, 11, 2, 9]
    rows, tokens = _stepwise_logits(eng, GenRequest, prompt, 5)
    seq = list(prompt)
    for step, row in enumerate(rows):
        np.testing.assert_allclose(row, dense_row(seq), atol=1e-5, rtol=1e-5, err_msg="step %d" % step)
        seq.append(tokens[step])


def test_no_rebuild_after_warmup(engines):
    _, eng = engines
    before = eng.traces
    for p, m in CASES[:3]:
        eng.generate(p, max_new_tokens=m)
    st = eng.stats()
    assert st["traces"] == before == st["variants"]
    assert st["tokens_generated"] > 0


@pytest.mark.parametrize("builder", ["forward", "prefill", "decode"])
def test_programs_build_identically(builder):
    """Same op list (types, slots, attrs) and same var shapes/dtypes in both
    packages for each GPTDecoder program."""
    progs = []
    for cls in (JaxGPTDecoder, GPTDecoder):
        m = cls(**MODEL_KW)
        if builder == "forward":
            main = m.build_forward(2, 8)[0]
        elif builder == "prefill":
            main = m.build_prefill(8, 4, 4, 36)[0]
        else:
            main = m.build_decode(3, 4, 4, 36)[0]
        progs.append(main.global_block())
    jb, pb = progs
    strip = lambda a: {k: v for k, v in a.items() if k != "op_role"}  # noqa: E731
    assert [(op.type, op.inputs, op.outputs, strip(op.attrs)) for op in pb.ops] == [
        (op.type, op.inputs, op.outputs, strip(op.attrs)) for op in jb.ops
    ]
    assert {n: (v.shape, v.dtype) for n, v in pb.vars.items()} == {
        n: (v.shape, v.dtype) for n, v in jb.vars.items()
    }


# a head of 256 over pages of 128 rows: a whole page of K and V passes a
# CTA's shared memory (the wide kernel gathers by position); on the CPU
# both engines take their plain forms
WIDE_MODEL_KW = dict(vocab_size=24, n_layer=1, n_head=1, d_model=256, d_inner=32,
                     max_context=256)
WIDE_ENGINE_KW = dict(max_slots=2, page_size=128, max_context=256)


@pytest.fixture(scope="module")
def wide_engines():
    """(JAX engine, port engine on the CPU carrying the JAX parameters) of
    the 256-wide-head model."""
    jeng = JaxEngine(JaxGPTDecoder(**WIDE_MODEL_KW), name="tt_wide_jax", cache_dir=None,
                     **WIDE_ENGINE_KW)
    jeng.warmup()
    model = GPTDecoder(**WIDE_MODEL_KW)
    peng = GenerationEngine(model, name="tt_wide_port", place=CPUPlace(), **WIDE_ENGINE_KW)
    peng.warmup()
    arrays = {n: np.asarray(jeng.scope.vars[n]) for n in model.param_names()}
    convert.load_into_scope(peng.scope, arrays, model.param_names())
    return jeng, peng


@pytest.mark.parametrize("prompt,n_new", [([3, 7, 11, 2, 9], 6),
                                          (list(range(1, 24)) * 6, 4)],
                         ids=["short", "past_a_page"])
def test_wide_head_logits_and_greedy_tokens_match_jax_engine(wide_engines, prompt, n_new):
    """Prefill and every decode step's logits of the 256-wide-head model at
    page_size 128 match the JAX engine within atol = rtol = 1e-4, and the
    greedy streams are equal; the second prompt (138 tokens) crosses a
    page."""
    jeng, peng = wide_engines
    want, want_tokens = _stepwise_logits(jeng, JaxGenRequest, prompt, n_new)
    got, got_tokens = _stepwise_logits(peng, GenRequest, prompt, n_new)
    assert len(got) == len(want) == n_new
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg="step %d" % step)
    assert got_tokens == want_tokens


# ---- warmup on scratch-only feeds, prefix hits and seeded sampling --------


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_warmup_writes_only_the_scratch_page(kv_dtype):
    """warmup() runs every variant on feeds whose rows all land in the
    scratch page (page 0): every other page of every pool is untouched
    (f32 levels 0; int8 levels 0 and scales 1.0)."""
    eng = GenerationEngine(GPTDecoder(kv_dtype=kv_dtype, **MODEL_KW), name="tt_scratch",
                           place=CPUPlace(), **ENGINE_KW)
    eng.warmup()
    ps = eng.page_size
    wrote_scratch = False
    for name, pool in eng._state.items():
        fresh = 1.0 if pool.dim() == 1 else 0.0  # the scale pools start at 1.0
        assert np.all(pool[ps:].numpy() == fresh), name
        wrote_scratch |= bool(np.any(pool[:ps].numpy() != fresh))
    assert wrote_scratch, "warmup ran no variant"
    assert eng.traces == len(eng._variants) == 1 + len(eng.prefill_buckets)


def _serve_pages_hit(eng, req_cls, prompt, n_new):
    """(tokens, pages taken from the prefix cache) of one request run
    alone."""
    run = eng.admit(req_cls(prompt, max_new_tokens=n_new, eos_id=NO_EOS))
    hit = run.pf_pos // eng.page_size
    try:
        while not eng.prefill_step(run):
            pass
        while not run.done:
            eng.decode_step([run])
    finally:
        eng.finish(run)
    return list(run.tokens), hit


def test_prefix_hit_prompt_served_twice_matches_jax_engine(engines):
    """One 9-token prompt served twice: the second admission takes its two
    full pages (page_size 4) from the prefix cache on both sides, and both
    passes give the JAX engine's tokens."""
    jeng, peng = engines
    prompt = [21, 3, 17, 5, 8, 13, 1, 22, 6]
    got = [_serve_pages_hit(peng, GenRequest, prompt, 4) for _ in range(2)]
    want = [_serve_pages_hit(jeng, JaxGenRequest, prompt, 4) for _ in range(2)]
    assert got == want
    assert [hit for _, hit in got] == [0, 2]


@pytest.mark.parametrize("kw", [dict(temperature=0.8, seed=7),
                                dict(temperature=1.3, top_k=5, seed=11)],
                         ids=["t0.8_seed7", "t1.3_topk5_seed11"])
def test_seeded_sampling_matches_jax_engine(engines, kw):
    jeng, peng = engines
    prompt = [4, 9, 1, 13, 2]
    want = jeng.generate(prompt, max_new_tokens=6, eos_id=NO_EOS, **kw).tokens
    got = peng.generate(prompt, max_new_tokens=6, eos_id=NO_EOS, **kw).tokens
    assert got == want


def test_default_seed_sampling_matches_jax_engine():
    """Temperature 0.9 with no seed: each engine draws from (scope seed, its
    count of unseeded requests), so two fresh engines on the same weights
    give the same tokens."""
    jeng = JaxEngine(JaxGPTDecoder(**MODEL_KW), name="tt_seed_jax", cache_dir=None,
                     **ENGINE_KW)
    jeng.warmup()
    model = GPTDecoder(**MODEL_KW)
    peng = GenerationEngine(model, name="tt_seed_port", place=CPUPlace(), **ENGINE_KW)
    peng.warmup()
    arrays = {n: np.asarray(jeng.scope.vars[n]) for n in model.param_names()}
    convert.load_into_scope(peng.scope, arrays, model.param_names())
    for prompt in ([3, 7, 11, 2, 9], [1, 2]):
        want = jeng.generate(prompt, max_new_tokens=6, eos_id=NO_EOS, temperature=0.9).tokens
        got = peng.generate(prompt, max_new_tokens=6, eos_id=NO_EOS, temperature=0.9).tokens
        assert got == want
