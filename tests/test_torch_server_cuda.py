"""Serving on CUDA graphs on the card (paddle_tpu_torch/serving/engine.py,
generation.py, compile_cache.py; executor._ServeBlock), at small widths.
Every case needs a CUDA card and is marked `cuda`; on the card they run
with `python -m pytest --noconftest tests/test_torch_server_cuda.py -m cuda`
(no JAX is imported).

What is held:
- ServingEngine.warmup() captures one graph per bucket; later calls replay
  (no capture, no preparation), equal bit for bit to the same variant run
  op by op;
- a hot swap copies into the captured tensors once: their addresses stay,
  no replay copies state afterwards, and the output follows the new
  parameters (as an engine built on them gives);
- a swap from a third thread while clients replay through the batcher's
  dispatcher thread: every reply equals the outputs of the parameter set
  its version names;
- the compile cache's second boot on the card: no preparation, one hit per
  bucket, one capture per bucket, equal outputs;
- GenerationEngine.set_params on graphs: no state copy afterwards, tokens
  of an engine built on the new parameters.
"""

import threading

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import CPUPlace, CUDAPlace, convert
from paddle_tpu_torch.executor import Scope, scope_guard
from paddle_tpu_torch.models import GPTDecoder
from paddle_tpu_torch.ops import fused
from paddle_tpu_torch.serving import ContinuousBatcher, GenerationEngine, ServingEngine

BUCKETS = (1, 2, 4, 8)
WIDTH = 32
GPT_KW = dict(vocab_size=64, n_layer=2, n_head=2, d_model=32, d_inner=64, max_context=32)
GEN_KW = dict(max_slots=2, page_size=4, max_context=32)
NO_EOS = 999


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture
def model_dir(tmp_path):
    """An fc stack saved by the port's io on the CPU."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[WIDTH], dtype="float32")
        h = fluid.layers.fc(x, size=64, act="relu")
        y = fluid.layers.fc(h, size=8, act="softmax")
    md = str(tmp_path / "m")
    with scope_guard(Scope(seed=3, place=CPUPlace())):
        exe = fluid.Executor(CPUPlace())
        exe.run(startup)
        fluid.io.save_inference_model(md, ["x"], [y], exe, main_program=main)
    return md


def _params(eng, seed):
    rng = np.random.RandomState(seed)
    return {n: rng.randn(*eng.scope.vars[n].shape).astype("float32") * 0.3
            for n in eng.param_names()}


@pytest.mark.cuda
def test_warmup_captures_each_bucket_and_calls_replay(cuda_device, model_dir):
    eng = ServingEngine(model_dir, name="cu_cap", batch_buckets=BUCKETS, place=CUDAPlace(0))
    assert eng.warmup() == len(BUCKETS)
    st = eng.stats()
    assert st["captures"] == st["traces"] == len(BUCKETS)
    fused.reset_stats()
    x = np.random.RandomState(0).randn(7, WIDTH).astype("float32")
    for rows in (1, 2, 3, 7):
        (got,) = eng.run({"x": x[:rows]})
        (want,) = eng.run_op_by_op({"x": x[:rows]})
        assert got.shape == (rows, 8)
        np.testing.assert_array_equal(got, want)
    assert fused.GRAPHS.get("replays", 0) == 4 and not fused.GRAPHS.get("captures")
    st = eng.stats()
    assert st["captures"] == st["traces"] == len(BUCKETS) and st["state_copies"] == 0


@pytest.mark.cuda
def test_swap_copies_once_and_no_call_copies_after(cuda_device, model_dir):
    eng = ServingEngine(model_dir, name="cu_swap", batch_buckets=BUCKETS, place=CUDAPlace(0))
    eng.warmup()
    ptrs = {n: t.data_ptr() for n, t in eng._ro.items()}
    x = np.random.RandomState(1).randn(5, WIDTH).astype("float32")
    new = _params(eng, 7)
    assert eng.set_params(new) == len(new)
    assert {n: t.data_ptr() for n, t in eng._ro.items()} == ptrs
    for _ in range(3):
        (got,) = eng.run({"x": x})
    assert eng.stats()["state_copies"] == 0 and eng.stats()["captures"] == len(BUCKETS)
    fresh = ServingEngine(model_dir, name="cu_swap_ref", batch_buckets=BUCKETS,
                          place=CUDAPlace(0))
    fresh.set_params(new)
    np.testing.assert_array_equal(got, fresh.run_op_by_op({"x": x})[0])
    cpu = ServingEngine(model_dir, name="cu_swap_cpu", batch_buckets=BUCKETS, place=CPUPlace())
    cpu.set_params(new)
    np.testing.assert_allclose(got, cpu.run({"x": x})[0], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_swap_from_a_third_thread_during_replays(cuda_device, model_dir):
    """Clients replay through the batcher's dispatcher thread while a third
    thread swaps between two parameter sets: each reply equals the outputs
    of the set its version names."""
    eng = ServingEngine(model_dir, name="cu_thr", batch_buckets=BUCKETS, place=CUDAPlace(0))
    eng.warmup()
    sets = [_params(eng, 11), _params(eng, 12)]
    x = np.random.RandomState(2).randn(3, WIDTH).astype("float32")
    want = []
    for p in sets:
        eng.set_params(p)
        want.append(eng.run({"x": x})[0])
    assert not np.allclose(want[0], want[1])
    base = eng.model_version
    batcher = ContinuousBatcher(eng, max_batch_delay_ms=0.5, timeout_ms=60000.0)
    replies, errors, stop = [], [], threading.Event()

    def client():
        try:
            while not stop.is_set():
                fut = batcher.submit({"x": x})
                (out,) = fut.result(60)
                replies.append((fut.model_version, out))
        except Exception as e:  # surfaced below
            errors.append(e)

    clients = [threading.Thread(target=client) for _ in range(3)]
    for t in clients:
        t.start()
    swaps = 0
    try:
        for k in range(40):
            eng.set_params(sets[k % 2], version=base + 1 + k)
            swaps += 1
            threading.Event().wait(0.002)
    finally:
        stop.set()
        for t in clients:
            t.join(60)
        assert batcher.close(drain=True)
    assert not errors, errors
    assert len(replies) > swaps // 2
    for version, out in replies:
        k = version - base - 1
        ref = want[k % 2] if k >= 0 else want[1]
        np.testing.assert_array_equal(out, ref)
    assert eng.stats()["state_copies"] == 0 and eng.stats()["captures"] == len(BUCKETS)


@pytest.mark.cuda
def test_compile_cache_second_boot_on_the_card(cuda_device, model_dir, tmp_path):
    cache = str(tmp_path / "cache")
    x = np.random.RandomState(3).randn(6, WIDTH).astype("float32")
    outs = []
    for boot in range(2):
        eng = ServingEngine(model_dir, name="cu_cc%d" % boot, batch_buckets=BUCKETS,
                            cache_dir=cache, place=CUDAPlace(0))
        eng.warmup()
        st = eng.stats()
        want = (len(BUCKETS), 0) if boot == 0 else (0, len(BUCKETS))
        assert (st["traces"], st["cache_hits"]) == want
        assert st["captures"] == len(BUCKETS)
        outs.append(eng.run({"x": x})[0])
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.cuda
def test_generation_set_params_on_graphs(cuda_device):
    model = GPTDecoder(**GPT_KW)
    eng = GenerationEngine(model, name="cu_gen", place=CUDAPlace(0), **GEN_KW)
    eng.warmup()
    captures = eng.captures()
    rng = np.random.RandomState(5)
    new = {n: rng.randn(*eng.scope.vars[n].shape).astype("float32") * 0.2
           for n in model.param_names()}
    ptrs = {n: eng.scope.vars[n].data_ptr() for n in model.param_names()}
    assert eng.set_params(new) == len(new)
    assert {n: eng.scope.vars[n].data_ptr() for n in model.param_names()} == ptrs
    got = eng.generate([3, 1, 4, 1, 5], max_new_tokens=6, eos_id=NO_EOS).tokens
    st = eng.stats()
    assert st["state_copies"] == 0 and eng.captures() == captures
    fresh = GenerationEngine(GPTDecoder(**GPT_KW), name="cu_gen_ref", place=CUDAPlace(0),
                             **GEN_KW)
    fresh.warmup()
    convert.load_into_scope(fresh.scope, new, model.param_names())
    assert fresh.generate([3, 1, 4, 1, 5], max_new_tokens=6, eos_id=NO_EOS).tokens == got
