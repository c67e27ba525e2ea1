"""The executor's compile step on the card (paddle_tpu_torch/executor.py
_CompiledBlock / _ServeBlock): a block captured as a CUDA graph and
replayed against the same block run op by op (the profiler with
FLAGS_profile_ops), at small widths. Every case needs a CUDA card and is
marked `cuda`; on the card they run with
`python -m pytest --noconftest tests/test_torch_cuda_graph.py -m cuda`.

What is held, and how:
- decode, every prefill bucket and an interleaved decode/prefill mix, f32
  and int8 pools: every call's logits bit for bit, and each call's paged
  kernel launches equal;
- 3 training steps with dropout 0.1 (fused, and use_flash): losses and
  the whole persistable state bit for bit, and each step's launch and
  dispatch counts equal;
- a pinned-seed dropout draws the same mask at every replay;
- a paged_flash flip takes a graph of its own;
- a parameter rebound in the scope between steps is followed as the
  op-by-op path follows it, and a rebinding of another shape raises;
- return_numpy=False fetches are not overwritten by the next replay;
- random ops in a main program draw fresh values at every replay, the
  same as op by op, and a pinned seed the same values;
- the graphs of one executor (several feed shapes) and of one engine share
  one memory pool, and interleaved replays still match op by op;
- use_program_cache=False reaches a graph on the card as well.
Both sides run the same kernels in the same order, so bit identity is the
contract; a library call that differed under capture would be named here
with its tolerance.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import CUDAPlace, flags, profiler
from paddle_tpu_torch.models import GPTDecoder
from paddle_tpu_torch.ops import fused
from paddle_tpu_torch.ops import paged_flash as pf
from paddle_tpu_torch.serving import GenerationEngine, GenRequest

from torch_transformer_case import SMALL, SMALL_FLASH, build, make_batch

MODEL_KW = dict(vocab_size=64, n_layer=2, n_head=2, d_model=32, d_inner=64, max_context=32)
ENGINE_KW = dict(max_slots=3, page_size=4, max_context=32)
PROMPT_LENS = (2, 3, 7, 13, 30)  # buckets 2, 4, 8, 16 and 32 (two chunks: 32 is the cap)
NEW_TOKENS = 5
NO_EOS = 999


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the hand-written kernels")
    return torch.device("cuda", 0)


@contextlib.contextmanager
def op_by_op():
    """The op-by-op path: the profiler on, FLAGS_profile_ops set (its table
    is printed into a buffer)."""
    flags.set_flags({"profile_ops": True})
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            with profiler.profiler(profile_path=None):
                yield
    finally:
        flags.set_flags({"profile_ops": False})


def _engine(kv_dtype, name):
    eng = GenerationEngine(GPTDecoder(kv_dtype=kv_dtype, **MODEL_KW), name=name,
                           place=CUDAPlace(0), **ENGINE_KW)
    eng.warmup()
    return eng


def _serve_mix(eng):
    """A fixed interleaving of prefill chunks and decode steps over every
    bucket (more requests than slots): the logits and the paged kernel
    launches of every engine call, in order."""
    rng = np.random.RandomState(3)
    pending = [GenRequest(rng.randint(1, MODEL_KW["vocab_size"], n).tolist(),
                          max_new_tokens=NEW_TOKENS, eos_id=NO_EOS) for n in PROMPT_LENS]
    calls = []
    call = eng._call

    def recorded(variant, feeds):
        before = pf.kernel_launches()
        out = call(variant, feeds)
        after = pf.kernel_launches()
        calls.append((out[0].copy(), {k: after[k] - before[k] for k in after}))
        return out

    eng._call = recorded
    try:
        live, filling = [], []
        while pending or live or filling:
            while pending and eng.can_admit(pending[0]):
                filling.append(eng.admit(pending.pop(0)))
            if filling and eng.prefill_step(filling[0]):
                run = filling.pop(0)
                live.append(run)
            if live:
                eng.decode_step(live)
                for run in [r for r in live if r.done]:
                    live.remove(run)
                    eng.finish(run)
    finally:
        del eng._call
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_serving_graph_matches_op_by_op(cuda_device, kv_dtype):
    graph_eng = _engine(kv_dtype, "graph_" + kv_dtype)
    eager_eng = _engine(kv_dtype, "eager_" + kv_dtype)
    traces, captures = graph_eng.traces, graph_eng.captures()
    assert traces == captures == len(graph_eng._variants) == 1 + len(graph_eng.prefill_buckets)
    got = _serve_mix(graph_eng)
    with op_by_op():
        want = _serve_mix(eager_eng)
    assert graph_eng.traces == traces, "a variant was prepared again"
    assert graph_eng.captures() == captures, "a variant was captured again"
    pools = {c.graph.graph.pool() for v in graph_eng._variants.values()
             for c in v.fn.compiled.values()}
    assert len(pools) == 1, "the variants capture into one memory pool"
    assert len(got) == len(want)
    kinds = set()
    for i, ((g, gl), (w, wl)) in enumerate(zip(got, want)):
        assert g.shape == w.shape and np.array_equal(g, w), "call %d" % i
        assert gl == wl, "call %d: launches %s vs %s" % (i, gl, wl)
        kinds.update(k for k, v in gl.items() if v)
    want_kinds = {pf.launch_key(shared, 16, kv_dtype == "int8") for shared in (False, True)}
    assert kinds == want_kinds


def _train(cfg, steps, per_op, rebind=None):
    """`steps` steps of the small Transformer under training_fused from seed
    0: losses, each step's counter deltas and the final state. `rebind`,
    (step, name, fn), rebinds a persistable in the scope to fn(tensor)
    before that step."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.models import transformer

    flags.set_flags({"pass_pipeline": "training_fused"})
    try:
        main, startup, loss = build(pt, transformer, cfg)
        names = convert.persistable_names(main)
        place = CUDAPlace(0)
        scope, exe = pt.Scope(seed=0, place=place), pt.Executor(place)
        with pt.scope_guard(scope):
            exe.run(startup)
        losses, counts = [], []
        with (op_by_op() if per_op else contextlib.nullcontext()), pt.scope_guard(scope):
            for s in range(steps):
                if rebind is not None and rebind[0] == s:
                    scope.set_var(rebind[1], rebind[2](scope.vars[rebind[1]]))
                before = fused.stats()
                (lv,) = exe.run(main, feed=make_batch(cfg, s), fetch_list=[loss.name])
                after = fused.stats()
                losses.append(lv)
                counts.append({(kind, k): after[kind][k] - before[kind].get(k, 0)
                               for kind in after for k in after[kind]})
        return losses, counts, convert.scope_to_numpy(scope, names)
    finally:
        flags.set_flags({"pass_pipeline": ""})


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [dict(SMALL, dropout=0.1), dict(SMALL_FLASH, dropout=0.1)],
                         ids=["fused", "use_flash"])
def test_training_graph_matches_op_by_op(cuda_device, cfg):
    g_loss, g_counts, g_state = _train(cfg, 3, per_op=False)
    e_loss, e_counts, e_state = _train(cfg, 3, per_op=True)
    for s, (g, e) in enumerate(zip(g_loss, e_loss)):
        assert np.array_equal(g, e), "step %d: loss %r vs %r" % (s, g, e)
    for name in e_state:
        assert np.array_equal(g_state[name], e_state[name]), name
    assert g_counts == e_counts
    moved = {k for c in g_counts for k, v in c.items() if v}
    assert ("launches", "multi_adam") in moved and ("dispatches", "layer_norm") in moved
    if cfg.get("use_flash"):
        assert ("launches", "flash_bwd_fused") in moved


@pytest.mark.cuda
def test_rebound_parameter_is_followed(cuda_device):
    cfg = dict(SMALL, dropout=0.1)
    name = "fc_0.w_0"  # a parameter the first layer reads

    def halve(t):
        return (t * 0.5).clone()

    g_loss, _, g_state = _train(cfg, 4, per_op=False, rebind=(3, name, halve))
    e_loss, _, e_state = _train(cfg, 4, per_op=True, rebind=(3, name, halve))
    assert all(np.array_equal(g, e) for g, e in zip(g_loss, e_loss)), (g_loss, e_loss)
    for n in e_state:
        assert np.array_equal(g_state[n], e_state[n]), n


@pytest.mark.cuda
def test_rebinding_another_shape_raises(cuda_device):
    main, startup, loss = _tiny_program()
    x = np.random.RandomState(1).rand(16, 64).astype("float32")
    scope, exe = pt.Scope(seed=0, place=CUDAPlace(0)), pt.Executor(CUDAPlace(0))
    with pt.scope_guard(scope):
        exe.run(startup)
        for _ in range(2):  # warm, then capture
            exe.run(main, feed={"x": x}, fetch_list=[loss])
        scope.set_var("fc_0.w_0", torch.zeros(3, device="cuda"))
        with pytest.raises(RuntimeError, match="fc_0.w_0"):
            exe.run(main, feed={"x": x}, fetch_list=[loss])


def _tiny_program(dropout_seed=None):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[64], dtype="float32")
        if dropout_seed is not None:
            out = pt.layers.dropout(x, 0.5, seed=dropout_seed)
            return main, startup, out
        h = pt.layers.fc(x, 32, act="relu")
        loss = pt.layers.mean(pt.layers.fc(h, 1))
        pt.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return main, startup, loss


@pytest.mark.cuda
def test_pinned_seed_dropout_same_mask_every_replay(cuda_device):
    main, startup, out = _tiny_program(dropout_seed=123)
    x = np.random.RandomState(0).rand(8, 64).astype("float32") + 1.0
    runs = []
    for per_op in (False, True):
        scope, exe = pt.Scope(seed=0, place=CUDAPlace(0)), pt.Executor(CUDAPlace(0))
        with (op_by_op() if per_op else contextlib.nullcontext()), pt.scope_guard(scope):
            exe.run(startup)
            runs.append([exe.run(main, feed={"x": x}, fetch_list=[out])[0] for _ in range(4)])
    graph, eager = runs
    assert 0 < np.count_nonzero(graph[0]) < graph[0].size
    for a in graph + eager:
        assert np.array_equal(a, graph[0])


@pytest.mark.cuda
def test_paged_flash_flip_takes_its_own_graph(cuda_device):
    eng = _engine("float32", "flip")
    run = eng.start(GenRequest(list(range(1, 10)), max_new_tokens=12, eos_id=NO_EOS))
    try:
        captures = eng.captures()
        eng.decode_step([run])
        before = sum(pf.kernel_launches().values())
        flags.set_flags({"paged_flash": "off"})
        try:
            for _ in range(3):  # warm, capture, replay
                eng.decode_step([run])
                assert np.all(np.isfinite(eng.last_logits))
        finally:
            flags.set_flags({"paged_flash": "auto"})
        assert sum(pf.kernel_launches().values()) == before, "a kernel ran with paged_flash off"
        assert eng.captures() == captures + 1
        eng.decode_step([run])
        assert sum(pf.kernel_launches().values()) > before
        assert eng.captures() == captures + 1
    finally:
        eng.finish(run)


@pytest.mark.cuda
def test_return_numpy_false_fetches_survive_the_next_replay(cuda_device):
    main, startup, loss = _tiny_program()
    x = np.random.RandomState(1).rand(16, 64).astype("float32")
    scope, exe = pt.Scope(seed=0, place=CUDAPlace(0)), pt.Executor(CUDAPlace(0))
    held, seen = [], []
    with pt.scope_guard(scope):
        exe.run(startup)
        for _ in range(5):
            (lv,) = exe.run(main, feed={"x": x}, fetch_list=[loss], return_numpy=False)
            held.append(lv)
            seen.append(lv.cpu().numpy().copy())
    assert len({float(v.reshape(-1)[0]) for v in seen}) == 5, "the loss did not move"
    for lv, v in zip(held, seen):
        assert np.array_equal(lv.cpu().numpy(), v)


def _noise_program():
    """(main, [x + gaussian noise, uniform noise with a pinned seed])."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[4, 8], dtype="float32", append_batch_size=False)
        noise = pt.layers.gaussian_random([4, 8], mean=1.0, std=2.0)
        pinned = pt.layers.uniform_random([4, 8], min=-1.0, max=1.0, seed=7)
        out = pt.layers.elementwise_add(x, noise)
    return main, [out, pinned]


def _captured(exe):
    return [c for c in exe._cache.values() if getattr(c, "graph", None) is not None]


@pytest.mark.cuda
def test_main_program_random_ops_graph_matches_op_by_op(cuda_device):
    main, outs = _noise_program()
    x = np.random.RandomState(0).rand(4, 8).astype("float32")
    runs = []
    for per_op in (False, True):
        scope, exe = pt.Scope(seed=5, place=CUDAPlace(0)), pt.Executor(CUDAPlace(0))
        with (op_by_op() if per_op else contextlib.nullcontext()), pt.scope_guard(scope):
            runs.append([exe.run(main, feed={"x": x}, fetch_list=outs) for _ in range(3)])
        if not per_op:
            assert len(_captured(exe)) == 1
    graph, eager = runs
    for s, (g, e) in enumerate(zip(graph, eager)):
        for a, b in zip(g, e):
            assert np.array_equal(a, b), "step %d" % s
    noise = [step[0] for step in graph]
    assert not np.array_equal(noise[0], noise[1]) and not np.array_equal(noise[1], noise[2])
    assert all(np.array_equal(step[1], graph[0][1]) for step in graph)


@pytest.mark.cuda
def test_executor_graphs_share_one_pool(cuda_device):
    main, startup, loss = _tiny_program()
    rng = np.random.RandomState(2)
    feeds = [rng.rand(rows, 64).astype("float32") for rows in (16, 8, 16, 8, 16, 8, 16, 8)]
    runs = []
    for per_op in (False, True):
        scope, exe = pt.Scope(seed=0, place=CUDAPlace(0)), pt.Executor(CUDAPlace(0))
        with (op_by_op() if per_op else contextlib.nullcontext()), pt.scope_guard(scope):
            exe.run(startup)
            runs.append([exe.run(main, feed={"x": f}, fetch_list=[loss])[0] for f in feeds])
        if not per_op:
            graphs = _captured(exe)
            assert len(graphs) == 2
            assert graphs[0].graph.graph.pool() == graphs[1].graph.graph.pool()
    for s, (g, e) in enumerate(zip(*runs)):
        assert np.array_equal(g, e), "step %d" % s


@pytest.mark.cuda
def test_no_program_cache_still_replays(cuda_device):
    main, startup, loss = _tiny_program()
    x = np.random.RandomState(1).rand(16, 64).astype("float32")
    runs = []
    for per_op in (False, True):
        scope, exe = pt.Scope(seed=0, place=CUDAPlace(0)), pt.Executor(CUDAPlace(0))
        with (op_by_op() if per_op else contextlib.nullcontext()), pt.scope_guard(scope):
            exe.run(startup)
            runs.append([exe.run(main, feed={"x": x}, fetch_list=[loss],
                                 use_program_cache=False)[0] for _ in range(4)])
        if not per_op:
            assert len(_captured(exe)) == 1
    for s, (g, e) in enumerate(zip(*runs)):
        assert np.array_equal(g, e), "step %d" % s


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 4])
def test_back_to_back_multistep_calls_equal_single_runs(cuda_device, k):
    """Three steps_per_run=k calls in a row with return_numpy=False (nothing
    waits on the host between them) equal 3k single runs bit for bit:
    a call's stacked feeds are not overwritten by the next call's before
    the card has copied them. Dropout 0.1 draws on every step."""
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.models import transformer

    cfg = dict(SMALL_FLASH, dropout=0.1)
    batches = [make_batch(cfg, s) for s in range(3 * k)]
    flags.set_flags({"pass_pipeline": "training_fused"})
    try:
        runs = []
        for multi in (False, True):
            main, startup, loss = build(pt, transformer, cfg)
            names = convert.persistable_names(main)
            scope, exe = pt.Scope(seed=0, place=CUDAPlace(0)), pt.Executor(CUDAPlace(0))
            with pt.scope_guard(scope):
                exe.run(startup)
                if multi:
                    held = [exe.run(main, feed=batches[c * k:(c + 1) * k],
                                    fetch_list=[loss.name], steps_per_run=k,
                                    return_numpy=False)[0] for c in range(3)]
                    losses = [v for h in held for v in h.cpu().numpy().reshape(-1)]
                else:
                    losses = [exe.run(main, feed=b, fetch_list=[loss.name])[0].reshape(-1)[0]
                              for b in batches]
            runs.append((losses, convert.scope_to_numpy(scope, names)))
    finally:
        flags.set_flags({"pass_pipeline": ""})
    (single, s_state), (multi, m_state) = runs
    assert len(set(single)) == len(single), "the loss did not move"
    for s, (a, b) in enumerate(zip(single, multi)):
        assert np.array_equal(a, b), "step %d: %r vs %r" % (s, a, b)
    for name in s_state:
        assert np.array_equal(s_state[name], m_state[name]), name
