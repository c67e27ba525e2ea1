"""The data layer on the card (every test is marked `cuda` and skips
without a CUDA device; the file imports no JAX, so on the card it runs with
`python -m pytest --noconftest tests/test_torch_data_cuda.py -m cuda`):

- a staged batch lands on the card, its values, its uint8 and bf16 wires;
- the consumer's stream waits on the copy: a copy queued behind a sleep
  on the reader's copy stream is still pending when the batch is taken,
  and the consumer's reads see the data;
- a program reader's feeder thread keeps staging while its program is
  captured (the executor captures in thread_local mode): feed=None steps
  on replayed graphs bit for bit the same batches fed as dicts, with one
  capture;
- decode workers forked after CUDA is initialised: their batches staged on
  the card, and a decode that makes a CUDA tensor fails as that worker's
  error in the consumer instead of hanging.
"""

import threading

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.data import DataRuntime
from paddle_tpu_torch.data.runtime import Stager, take
from paddle_tpu_torch.ops import fused
from paddle_tpu_torch.py_reader import PyReader, bf16_wire

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the copy stream and CUDA graphs")
    return torch.device("cuda", 0)


def _within(fn, seconds=60):
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: B036 — re-raised below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        pytest.fail("no result within %d s" % seconds)
    if "err" in box:
        raise box["err"]
    return box.get("out")


def test_staged_batch_lands_on_the_card(cuda_device):
    rng = np.random.RandomState(0)
    host = [{"x": rng.rand(8, 5).astype("float32"), "img": rng.randint(0, 256, (8, 3)),
             "h": rng.randn(8, 4).astype("float32")} for _ in range(5)]
    r = PyReader(["x", "img", "h"], capacity=2, place=pt.CUDAPlace(0),
                 wire_dtypes={"img": "uint8", "h": "bfloat16"})
    r.decorate_tensor_provider(lambda: iter(host))
    r.start()
    got = _within(lambda: list(r()))
    assert len(got) == 5
    for want, feed in zip(host, got):
        assert all(t.device == cuda_device for t in feed.values())
        assert feed["img"].dtype == torch.uint8 and feed["h"].dtype == torch.bfloat16
        np.testing.assert_array_equal(feed["x"].cpu().numpy(), want["x"])
        np.testing.assert_array_equal(feed["img"].cpu().numpy(), want["img"].astype("uint8"))
        np.testing.assert_array_equal(feed["h"].view(torch.int16).cpu().numpy().view(np.uint16),
                                      bf16_wire(want["h"]))


def test_consumer_stream_waits_on_the_copy(cuda_device):
    stager = Stager(cuda_device)
    x = np.arange(1 << 22, dtype=np.float32)
    stager({"x": x[:4]})  # makes the copy stream
    with torch.cuda.stream(stager._stream):
        torch.cuda._sleep(200_000_000)  # ~0.1 s ahead of the copy
    staged = stager({"x": x})
    assert not staged.event.query()  # the copy is still queued
    feed = take(staged)
    total = feed["x"].double().sum()  # on the current stream, behind the copy
    assert float(total) == float(x.astype(np.float64).sum())
    assert staged.event.query()


def test_capture_with_the_feeder_thread_running(cuda_device):
    """A layers.py_reader program, feed=None: the warmup, the capture and
    replays while the feeder thread stages the next batches on its copy
    stream; the losses equal the dict-fed runs bit for bit, one capture
    each."""
    batches = []
    rng = np.random.RandomState(3)
    for _ in range(6):
        xs = rng.randn(64, 32).astype("float32")
        batches.append((xs, (xs.sum(1) > 0).astype("int64").reshape(64, 1)))

    def build():
        main, startup = pt.Program(), pt.Program()
        with pt.unique_name.guard(), pt.program_guard(main, startup):
            reader = pt.layers.py_reader(capacity=2, shapes=[(-1, 32), (-1, 1)],
                                         dtypes=["float32", "int64"])
            x, label = pt.layers.read_file(reader)
            h = pt.layers.fc(x, size=64, act="relu")
            logits = pt.layers.fc(h, size=2)
            loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(logits, label))
            pt.optimizer.Adam(1e-2).minimize(loss)
        return main, startup, reader, x, label, loss

    out = {}
    for form in ("dict", "reader"):
        main, startup, reader, x, label, loss = build()
        scope = pt.Scope(seed=1, place=pt.CUDAPlace(0))
        exe = pt.Executor(pt.CUDAPlace(0))
        with pt.scope_guard(scope):
            exe.run(startup)
            fused.reset_stats()
            if form == "reader":
                reader.decorate_tensor_provider(
                    lambda: ({x.name: a, label.name: b} for a, b in batches))
                reader.start()
                losses = [float(exe.run(main, fetch_list=[loss.name])[0][0])
                          for _ in batches]
                with pytest.raises(pt.EOFException):
                    exe.run(main, fetch_list=[loss.name])
            else:
                losses = [float(exe.run(main, feed={x.name: a, label.name: b},
                                        fetch_list=[loss.name])[0][0]) for a, b in batches]
        out[form] = (losses, dict(pt.Executor.stats()["graphs"]))
    assert out["reader"][0] == out["dict"][0]
    assert out["reader"][1]["captures"] == out["dict"][1]["captures"] == 1


def _decode(shard):
    for b in range(3):
        yield {"v": np.full((4, 2), shard * 10 + b, np.float32)}


def _cuda_decode(shard):
    yield {"v": torch.ones(2, device="cuda").cpu().numpy()}


def test_forked_workers_after_cuda_init(cuda_device):
    torch.ones(1, device=cuda_device)  # CUDA is initialised in this process
    rt = DataRuntime(_decode, num_shards=4, num_workers=2, place=pt.CUDAPlace(0))
    try:
        rt.start()
        feeds = _within(lambda: list(rt()))
    finally:
        rt.close()
    assert len(feeds) == 12 and all(f["v"].device == cuda_device for f in feeds)
    assert sorted(int(f["v"][0, 0]) for f in feeds) == sorted(
        s * 10 + b for s in range(4) for b in range(3))
    bad = DataRuntime(_cuda_decode, num_shards=2, num_workers=1, place=pt.CUDAPlace(0),
                      batch_spec={"v": ((2,), np.float32)})
    try:
        bad.start()
        with pytest.raises(RuntimeError, match="CUDA"):
            _within(bad.next_batch)
    finally:
        bad.close()
