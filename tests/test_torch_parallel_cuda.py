"""The parallel slice on the card (no JAX imported; run with `python -m
pytest --noconftest tests/test_torch_parallel_cuda.py -m cuda`): the
ParallelExecutor at world 1 on NCCL and CUDA graphs against the Executor
bit for bit, the gloo refusal on a card, and ring attention's per-step
path on the flash kernels against the whole sequence."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _group(tmp_path, backend):
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import init_distributed

    init_distributed(store=dist.FileStore(str(tmp_path / "store"), 1), world_size=1, rank=0,
                     backend=backend)


def _mlp(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, size=32, act="relu")
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            fluid.layers.fc(h, size=4), y))
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss


def _batches(n):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        x = rng.randn(64, 16).astype("float32")
        out.append({"x": x, "y": np.abs(x[:, :4]).argmax(1).astype("int64").reshape(64, 1)})
    return out


def test_pe_world1_nccl_equals_executor_on_graphs(card, tmp_path):
    import torch.distributed as dist

    import paddle_tpu_torch.fluid as fluid

    runs = {}
    _group(tmp_path, "nccl")
    try:
        for use_pe in (False, True):
            main, startup, loss = _mlp(fluid)
            place = fluid.CUDAPlace(0)
            scope = fluid.Scope(seed=3, place=place)
            exe = fluid.Executor(place)
            exe.run(startup, scope=scope)
            if use_pe:
                pe = fluid.ParallelExecutor(loss_name=loss.name, main_program=main, scope=scope)
                step = lambda f: pe.run([loss.name], feed=f)[0]  # noqa: E731
            else:
                step = lambda f: exe.run(main, feed=f, fetch_list=[loss.name],  # noqa: E731
                                         scope=scope)[0]
            runs[use_pe] = [step(f) for f in _batches(5)]
    finally:
        dist.destroy_process_group()
    for a, b in zip(runs[True], runs[False]):
        np.testing.assert_array_equal(a, b)


def test_pe_on_card_refuses_gloo(card, tmp_path):
    import torch.distributed as dist

    import paddle_tpu_torch.fluid as fluid

    main, startup, loss = _mlp(fluid)
    scope = fluid.Scope(place=fluid.CUDAPlace(0))
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=scope)
    _group(tmp_path, "gloo")
    try:
        with pytest.raises(RuntimeError, match="NCCL"):
            fluid.ParallelExecutor(loss_name=loss.name, main_program=main, scope=scope)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("causal", [False, True])
def test_ring_per_step_flash_kernels(card, causal):
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parallel.ring_attention import ring_backward_chunks, ring_forward_chunks

    gen = torch.Generator(device=card).manual_seed(0)
    q, k, v, do = (torch.randn((2, 4, 256, 64), generator=gen, device=card) for _ in range(4))
    scale = 64 ** -0.5
    out, lse = fa.flash_forward(q, k, v, causal, scale)
    dq, dk, dv = fa.flash_backward(q, k, v, out, lse, do, causal, scale)
    qs, ks, vs, dos = ([c.contiguous() for c in x.chunk(4, 2)] for x in (q, k, v, do))
    fwd = ring_forward_chunks(qs, ks, vs, causal, scale)
    outs, lses = [o for o, _ in fwd], [s for _, s in fwd]
    assert float((torch.cat(outs, 2) - out).abs().max()) <= 1e-5
    assert float((torch.cat(lses, 2) - lse).abs().max()) <= 1e-5
    for got, ref in zip(ring_backward_chunks(qs, ks, vs, outs, lses, dos, causal, scale),
                        (dq, dk, dv)):
        got = torch.cat(got, 2)
        lim = 1e-4 * ref.abs() + 1e-4 * float(ref.abs().max())
        assert bool(((got - ref).abs() <= lim).all())
