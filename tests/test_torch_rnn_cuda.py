"""The recurrent slice's invariants on the card (every test is marked
`cuda` and skips without a CUDA device; the file imports no JAX, so on the
card it runs with `python -m pytest --noconftest
tests/test_torch_rnn_cuda.py -m cuda`):

- the capture rule: a block holding an open-ended while runs op by op and
  is counted under "open_ended_while", a bounded while's block is captured,
  through Executor.run and through a serve lowering alike;
- the stacked LSTM and the NMT model at small widths: 3 steps on the graph
  path against 3 op by op from the same seed, losses bit for bit with the
  same launches and dispatches a step, 1 multi_adam launch a step; the
  beam decode op by op for "open_ended_while";
- a learning-rate schedule on replayed graphs advances the step counter;
- the book's word2vec with the nce head (its custom_dist sampler drawing on
  the device inside the graph): graph against op by op bit for bit.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import flags
from paddle_tpu_torch.executor import aot_serve_lowering
from paddle_tpu_torch.ops import fused
from paddle_tpu_torch.tools import profile_rnn as rnn

LSTM_SMALL = dict(rnn.LSTM, dict_dim=50, emb_dim=16, hid_dim=16, stacked_num=3, batch=4,
                  seq_len=7)
NMT_SMALL = dict(rnn.NMT, dict_size=40, emb_dim=16, hid_dim=16, seq_len=6, batch=4,
                 beam_size=3, max_out_len=6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the hand-written kernels")
    return torch.device("cuda", 0)


@contextlib.contextmanager
def op_by_op():
    from paddle_tpu_torch import profiler

    flags.set_flags({"profile_ops": True})
    try:
        with contextlib.redirect_stdout(io.StringIO()), profiler.profiler(profile_path=None):
            yield
    finally:
        flags.set_flags({"profile_ops": False})


def _counting_while(max_iters):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        n = L.fill_constant(shape=[1], dtype="int64", value=10)
        acc = L.fill_constant(shape=[1], dtype="float32", value=0.0)
        L.create_parameter([2], "float32", name="p")
        cond = L.less_than(i, n)
        w = L.While(cond, maximum_iterations=max_iters)
        with w.block():
            L.assign(L.elementwise_add(acc, L.fill_constant([1], "float32", 2.0)), acc)
            L.increment(i, value=1, in_place=True)
            L.less_than(i, n, cond=cond)
    return main, startup, [acc.name, i.name]


@pytest.mark.cuda
@pytest.mark.parametrize("max_iters,reasons,graphs", [
    (None, {"creates_persistables": 1, "open_ended_while": 3}, 0),
    (12, {"creates_persistables": 1}, 1)])
def test_capture_rule(cuda_device, max_iters, reasons, graphs):
    main, startup, fetch = _counting_while(max_iters)
    exe, scope = pt.Executor(pt.CUDAPlace(0)), pt.Scope(seed=0, place=pt.CUDAPlace(0))
    fused.reset_stats()
    with pt.scope_guard(scope):
        exe.run(startup)
        outs = [exe.run(main, fetch_list=fetch) for _ in range(3)]
    for acc_v, i_v in outs:
        assert i_v[0] == 10 and acc_v[0] == 20.0
    assert pt.Executor.stats()["op_by_op"] == reasons
    assert sum(getattr(c, "graph", None) is not None for c in exe._cache.values()) == graphs


@pytest.mark.cuda
@pytest.mark.parametrize("max_iters,reasons,captures", [
    (None, {"open_ended_while": 3}, 0), (12, {}, 1)])
def test_capture_rule_serving(cuda_device, max_iters, reasons, captures):
    main, startup, fetch = _counting_while(max_iters)
    scope = pt.Scope(seed=0, place=pt.CUDAPlace(0))
    with pt.scope_guard(scope):
        pt.Executor(pt.CUDAPlace(0)).run(startup)
    fused.reset_stats()
    serve, ro, mut = aot_serve_lowering(main, [], fetch, scope, return_state=True)
    for _ in range(3):
        (acc_v, i_v), mut = serve({}, ro, mut)
        assert int(i_v.reshape(-1)[0]) == 10 and float(acc_v.reshape(-1)[0]) == 20.0
    assert pt.Executor.stats()["op_by_op"] == reasons
    assert serve.captures() == captures


def _run(model, feeds, per_op):
    """Losses and each step's counter deltas of `feeds`, from a fresh scope."""
    flags.set_flags({"pass_pipeline": "training_fused"})
    exe, scope = pt.Executor(pt.CUDAPlace(0)), pt.Scope(seed=0, place=pt.CUDAPlace(0))
    losses, deltas = [], []
    try:
        with pt.scope_guard(scope), (op_by_op() if per_op else contextlib.nullcontext()):
            exe.run(model["startup"])
            for f in feeds:
                before = fused.stats()
                (lv,) = exe.run(model["main"], feed=f, fetch_list=[model["loss"].name])
                after = fused.stats()
                losses.append(lv.reshape(-1)[0])
                deltas.append({(kind, k): after[kind][k] - before[kind].get(k, 0)
                               for kind in ("launches", "dispatches") for k in after[kind]
                               if after[kind][k] != before[kind].get(k, 0)})
    finally:
        flags.set_flags({"pass_pipeline": ""})
    return np.asarray(losses), deltas, scope


def _graph_equals_op_by_op(model, feeds):
    g_losses, g_deltas, scope = _run(model, feeds, False)
    e_losses, e_deltas, _ = _run(model, feeds, True)
    assert g_losses.tobytes() == e_losses.tobytes(), (g_losses, e_losses)
    assert g_deltas == e_deltas
    for d in g_deltas:
        assert d == g_deltas[0] and d[("launches", "multi_adam")] == 1, g_deltas
    return scope


@pytest.mark.cuda
def test_stacked_lstm_graph_equals_op_by_op(cuda_device):
    model = rnn.build_lstm(LSTM_SMALL)
    feeds = [rnn.lstm_feed(LSTM_SMALL, 0), rnn.lstm_feed(LSTM_SMALL, 1, ragged=True),
             rnn.lstm_feed(LSTM_SMALL, 2, ragged=True)]
    _graph_equals_op_by_op(model, feeds)


@pytest.mark.cuda
def test_nmt_graph_equals_op_by_op_and_decodes_op_by_op(cuda_device):
    model = rnn.build_nmt_train(NMT_SMALL)
    rng = np.random.RandomState(0)
    feeds = [rnn.nmt_batch(NMT_SMALL, rng) for _ in range(3)]
    scope = _graph_equals_op_by_op(model, feeds)
    infer = rnn.build_nmt_infer(NMT_SMALL)
    fused.reset_stats()
    with pt.scope_guard(scope):
        ids, scores, lens = pt.Executor(pt.CUDAPlace(0)).run(
            infer["main"], feed={"src": feeds[0]["src"], "src_len": feeds[0]["src_len"]},
            fetch_list=[infer["ids"].name, infer["scores"].name, infer["hyp_len"].name])
    assert pt.Executor.stats()["op_by_op"] == {"open_ended_while": 1}
    assert ids.shape[:2] == (NMT_SMALL["batch"], NMT_SMALL["beam_size"])
    assert np.isfinite(scores).all()
    assert lens.min() >= 1 and lens.max() <= NMT_SMALL["max_out_len"]


@pytest.mark.cuda
def test_schedule_advances_on_replayed_graphs(cuda_device):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[3], dtype="float32")
        loss = fluid.layers.mean(fluid.layers.fc(x, size=1))
        lr = fluid.layers.exponential_decay(0.1, decay_steps=2, decay_rate=0.5)
        fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    exe, scope = pt.Executor(pt.CUDAPlace(0)), pt.Scope(seed=0, place=pt.CUDAPlace(0))
    xs = np.ones((2, 3), np.float32)
    with pt.scope_guard(scope):
        exe.run(startup)
        lrs = [float(exe.run(main, feed={"x": xs}, fetch_list=[lr.name])[0].reshape(-1)[0])
               for _ in range(6)]
    assert any(getattr(c, "graph", None) is not None for c in exe._cache.values())
    np.testing.assert_allclose(lrs, [0.1 * 0.5 ** (k / 2.0) for k in range(6)], rtol=1e-6)


@pytest.mark.cuda
def test_nce_word2vec_graph_equals_op_by_op(cuda_device):
    V, E, N, B = 40, 16, 4, 32
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        words = [fluid.layers.data(name="w%d" % i, shape=[1], dtype="int64") for i in range(N)]
        target = fluid.layers.data(name="t", shape=[1], dtype="int64")
        embs = [fluid.layers.embedding(w, size=[V, E], param_attr=fluid.ParamAttr(name="emb"))
                for w in words]
        hidden = fluid.layers.fc(fluid.layers.concat(embs, axis=1), size=32, act="relu")
        dist = np.linspace(1.0, 2.0, V) / np.linspace(1.0, 2.0, V).sum()
        cost = fluid.layers.nce(hidden, target, num_total_classes=V, num_neg_samples=8,
                                custom_dist=dist)
        loss = fluid.layers.mean(cost)
        fluid.optimizer.Adam(0.02).minimize(loss)
    rng = np.random.RandomState(3)
    ws = rng.randint(0, V, (B, N)).astype("int64")
    feed = {"w%d" % i: ws[:, i:i + 1] for i in range(N)}
    feed["t"] = ((ws.sum(1) * 7 + 3) % V).astype("int64")[:, None]
    model = dict(main=main, startup=startup, loss=loss)
    g_losses, g_deltas, _ = _run(model, [feed] * 4, False)
    e_losses, e_deltas, _ = _run(model, [feed] * 4, True)
    assert g_losses.tobytes() == e_losses.tobytes(), (g_losses, e_losses)
    assert g_deltas == e_deltas
