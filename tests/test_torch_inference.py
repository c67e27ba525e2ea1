"""Inference deployment in the port (paddle_tpu_torch/inference.py) on the
CPU, the counterparts of tests/test_serving.py:51-80 and its three-way
parity: export_compiled's returned path both ways, missing and unknown
feeds, the port's Predictor against the JAX package's on one model
directory (written by the JAX package), load_compiled against the port's
Predictor bit for bit, a bare Scope() under both, the artifact's stack
check, and a small use_flash Transformer's inference program whose
exported graph holds the flash forward op."""

import json
import os
import sys

import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu_torch import inference
from paddle_tpu_torch.serving import compile_cache


def _save_mlp(tmp_path, prefix):
    """A small softmax MLP saved by the JAX package (as tests/test_serving.py
    saves it): (model_dir, feed name)."""
    import paddle_tpu.fluid as jfluid
    from paddle_tpu import framework
    from paddle_tpu.executor import Scope, scope_guard

    main, startup = framework.Program(), framework.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        x = jfluid.layers.data(name="%s_x" % prefix, shape=[6], dtype="float32")
        h = jfluid.layers.fc(input=x, size=8, act="relu")
        y = jfluid.layers.fc(input=h, size=3, act="softmax")
    exe = jfluid.Executor(jfluid.CPUPlace())
    model_dir = str(tmp_path / prefix)
    with scope_guard(Scope(seed=3)):
        exe.run(startup)
        jfluid.io.save_inference_model(model_dir, ["%s_x" % prefix], [y], exe,
                                       main_program=main)
    return model_dir, "%s_x" % prefix


def _feed(name, rows=3, seed=1):
    return {name: np.random.RandomState(seed).rand(rows, 6).astype("float32")}


def test_export_compiled_returns_written_path(tmp_path):
    """np.savez appends .npz when out_path lacks it: the returned path is the
    file that exists, both ways, and both load."""
    model_dir, x = _save_mlp(tmp_path, "ep")
    feed = _feed(x, rows=2, seed=0)
    bare = inference.export_compiled(model_dir, feed, str(tmp_path / "art"),
                                     place=pt.CPUPlace())
    assert bare.endswith(".npz") and os.path.exists(bare)
    suffixed = inference.export_compiled(model_dir, feed, str(tmp_path / "art2.npz"),
                                         place=pt.CPUPlace())
    assert suffixed == str(tmp_path / "art2.npz") and os.path.exists(suffixed)
    (o1,) = inference.load_compiled(bare).run(feed)
    (o2,) = inference.load_compiled(suffixed).run(feed)
    np.testing.assert_array_equal(o1, o2)


def test_predictor_rejects_missing_and_unknown_feeds(tmp_path):
    """A typo'd feed name raises as a missing one does, in the Predictor and
    in the loaded artifact."""
    model_dir, x = _save_mlp(tmp_path, "uf")
    pred = inference.Predictor(model_dir, place=pt.CPUPlace())
    assert pred.get_input_names() == [x] and len(pred.get_output_names()) == 1
    ok = {x: np.zeros((1, 6), np.float32)}
    pred.run(ok)
    with pytest.raises(ValueError, match="missing feeds"):
        pred.run({})
    with pytest.raises(ValueError, match="unknown feeds.*oops"):
        pred.run(dict(ok, oops=np.zeros(3)))
    art = inference.load_compiled(inference.export_compiled(
        model_dir, ok, str(tmp_path / "a"), place=pt.CPUPlace()))
    with pytest.raises(ValueError, match="missing feeds"):
        art.run({})


def test_predictor_matches_jax_predictor_and_artifact(tmp_path):
    """One model directory: the port's Predictor against the JAX package's
    (rtol 1e-5, atol 1e-6: float32 sums in another order), a list feed as a
    dict feed, and load_compiled(export_compiled(...)) against the port's
    Predictor bit for bit (the same lowerings, exported)."""
    from paddle_tpu import inference as jinference

    model_dir, x = _save_mlp(tmp_path, "p3")
    feed = _feed(x)
    (want,) = jinference.Predictor(model_dir).run(feed)
    pred = inference.Predictor(model_dir, place=pt.CPUPlace())
    (got,) = pred.run(feed)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    (as_list,) = pred.run([feed[x]])
    np.testing.assert_array_equal(as_list, got)
    art = inference.load_compiled(inference.export_compiled(
        model_dir, feed, str(tmp_path / "art"), place=pt.CPUPlace()))
    for _ in range(2):
        (o,) = art.run(feed)
        np.testing.assert_array_equal(o, got)


def test_artifact_refuses_another_stack(tmp_path, monkeypatch):
    """An artifact read on another stack (here: another kernel build tag)
    raises, naming what differs."""
    model_dir, x = _save_mlp(tmp_path, "st")
    path = inference.export_compiled(model_dir, _feed(x), str(tmp_path / "art"),
                                     place=pt.CPUPlace())
    made = compile_cache._versions()
    monkeypatch.setattr(compile_cache, "_versions",
                        lambda: dict(made, kernels="another-build"))
    with pytest.raises(RuntimeError, match="another stack.*kernels"):
        inference.load_compiled(path)
    with np.load(path) as data:
        assert json.loads(str(data["__versions__"])) == made


def test_use_flash_transformer_export_records_flash_forward(tmp_path):
    """The small use_flash Transformer's inference program (the for_test
    clone pruned to its logits), saved and exported on the CPU: the
    exported graph holds paddle_tpu_torch::flash_forward nodes (the op, not
    its plain form), and the artifact's logits equal the Predictor's bit
    for bit."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_transformer_case import FEED_NAMES, SMALL_FLASH, build, make_batch

    from paddle_tpu_torch.models import transformer as ptransformer

    main, startup, loss = build(pt, ptransformer, SMALL_FLASH)
    logits = _logits(main)
    exe = pt.Executor(pt.CPUPlace())
    feed_names = [n for n in FEED_NAMES if n in ("src_word", "src_pos", "trg_word", "trg_pos")]
    model_dir = str(tmp_path / "flash")
    with pt.scope_guard(pt.Scope(seed=5)):
        exe.run(startup)
        pt.io.save_inference_model(model_dir, feed_names, [logits], exe,
                                   main_program=main.clone(for_test=True))
    batch = make_batch(SMALL_FLASH, 0)
    feed = {n: batch[n] for n in feed_names}
    path = inference.export_compiled(model_dir, feed, str(tmp_path / "art"),
                                     place=pt.CPUPlace())
    graph = compile_cache.read_artifact(path)["program"].graph
    flash = [n for n in graph.nodes if str(n.target) == "paddle_tpu_torch.flash_forward.default"]
    assert len(flash) == 3  # encoder self, decoder self (causal), cross
    (want,) = inference.Predictor(model_dir, place=pt.CPUPlace()).run(feed)
    (got,) = inference.load_compiled(path).run(feed)
    assert want.shape[-1] == SMALL_FLASH["vocab"]
    np.testing.assert_array_equal(got, want)


def _logits(main):
    """The decoder's logits var: the input of the loss's
    softmax_with_cross_entropy."""
    op = next(op for op in main.global_block().ops if op.type == "softmax_with_cross_entropy")
    return main.global_block().var(op.input("Logits")[0])
