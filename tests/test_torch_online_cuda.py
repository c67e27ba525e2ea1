"""The online loop on the card (every test is marked `cuda` and skips
without a CUDA device; the file imports no JAX, so on the card it runs with
`python -m pytest --noconftest tests/test_torch_online_cuda.py -m cuda`):

- the publisher's row gather on the device: the same serve sets as CUDA
  tensors and as CPU tensors publish the same files (manifests, npz keys
  and bits), a bf16 table among them;
- the HotReloader replaying a delta on the live table of an engine on the
  card: after each version the card engine's table is the CPU engine's
  and apply_delta's replay bit for bit, its replies within rtol 1e-5
  (atol 1e-6) of the CPU's, and only the delta's rows cross to the card.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import online
from paddle_tpu_torch.resilience import async_ckpt
from paddle_tpu_torch.serving import ServingEngine

from torch_online_cases import tree

pytestmark = pytest.mark.cuda

CPU = fluid.CPUPlace()
ROWS, DIM = 4096, 16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return fluid.CUDAPlace(0)


def test_publisher_gathers_rows_on_the_card_same_files(card, tmp_path):
    rng = np.random.RandomState(0)
    tbl = rng.rand(ROWS, DIM).astype(np.float32)
    w = rng.rand(DIM, 4).astype(np.float32)
    for where, dev in (("cpu", "cpu"), ("card", "cuda")):
        pub = online.ModelPublisher(str(tmp_path / where), max_chain=4)
        t = torch.from_numpy(tbl.copy()).to(dev)
        b = torch.from_numpy(tbl[:64].copy()).to(dev).bfloat16()
        ww = torch.from_numpy(w.copy()).to(dev)
        pub.publish({"tbl": t, "bt": b, "w": ww}, 1)
        for step in (2, 3):
            ids = np.random.RandomState(step).choice(ROWS, 100, replace=False)
            t[torch.from_numpy(ids).to(dev)] += 0.5
            b[torch.from_numpy(ids[ids < 64]).to(dev)] -= 1.0
            touched = {"tbl": ids, "bt": ids[ids < 64]}
            if step == 3:
                ww.mul_(2.0)
            assert pub.publish({"tbl": t, "bt": b, "w": ww}, step, touched=touched)["kind"] == \
                "delta"
    assert tree(str(tmp_path / "card")) == tree(str(tmp_path / "cpu"))


def _save_table_model(tmp_path):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[1], dtype="int64")
        emb = fluid.layers.embedding(ids, size=[ROWS, DIM], is_sparse=True,
                                     param_attr=fluid.ParamAttr(name="tbl"))
        y = fluid.layers.fc(fluid.layers.reshape(emb, [-1, DIM]), size=3, act="softmax")
    model_dir = str(tmp_path / "model")
    with fluid.scope_guard(fluid.Scope(seed=1, place=CPU)):
        exe = fluid.Executor(CPU)
        exe.run(startup)
        fluid.io.save_inference_model(model_dir, ["ids"], [y], exe, main_program=main)
    return model_dir


def test_reloader_seeds_deltas_from_the_card_table(card, tmp_path):
    model_dir = _save_table_model(tmp_path)
    repo = str(tmp_path / "repo")
    engines = {p: ServingEngine(model_dir, name="tbl_" + p, place=place, batch_buckets=(8,))
               for p, place in (("cpu", CPU), ("card", card))}
    for eng in engines.values():
        assert eng._ro["tbl"] is eng.scope.vars["tbl"]
    reloaders = {p: online.HotReloader(repo, [eng], consumer=p) for p, eng in engines.items()}
    pub = online.ModelPublisher(repo, max_chain=8)
    params = {n: engines["cpu"].scope.vars[n].clone() for n in engines["cpu"].param_names()}
    feed = {"ids": np.arange(8, dtype=np.int64).reshape(8, 1) * 97}
    rng = np.random.RandomState(3)
    for step in range(1, 5):
        touched = {}
        if step > 1:
            ids = rng.choice(ROWS, 200, replace=False)
            params["tbl"][torch.from_numpy(ids)] += 0.1 * step
            touched = {"tbl": ids}
        pub.publish(params, step, touched=touched)
        for r in reloaders.values():
            assert r.check_once() == 1
        cpu, dev = engines["cpu"], engines["card"]
        restored = async_ckpt.load_with_deltas(repo, upto_step=step)[1]["tbl"]
        assert dev.scope.vars["tbl"].cpu().numpy().tobytes() == \
            cpu.scope.vars["tbl"].numpy().tobytes() == restored.tobytes()
        (want,), (got,) = cpu.run(feed), dev.run(feed)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        rec = reloaders["card"].history[-1]
        assert rec["kind"] == ("base" if step == 1 else "delta") and rec["version"] == step
        if step > 1:
            # the rows replayed on the card: only the delta crosses
            assert rec["h2d_bytes"] == 200 * (DIM * 4 + 8)
        assert reloaders["cpu"].history[-1]["h2d_bytes"] == 0
