"""Artifact-only training in the port (paddle_tpu_torch/train_export.py), the
counterparts of tests/test_train_artifact.py on the CPU: the runner against
Executor.run bit for bit, the state round trip, a fresh process that
imports only the loader and numpy (and no jax) training to a lower loss,
the port's runner against the JAX package's runner from one state, the
small flash Transformer's exported step holding the six kernel ops, and a
dropout program whose restored runner continues the same trajectory."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, flags
from paddle_tpu_torch.serving import compile_cache
from paddle_tpu_torch.train_export import TrainStepRunner, export_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _build(pkg, seed=0, dropout=0.0):
    """The fc regression of tests/test_train_artifact.py under Momentum
    (with a dropout between the fcs when `dropout`)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[8], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        h = pkg.layers.fc(x, size=16, act="relu")
        if dropout:
            h = pkg.layers.dropout(h, dropout_prob=dropout)
        pred = pkg.layers.fc(h, size=1)
        loss = pkg.layers.mean(pkg.layers.square(pred - y))
        pkg.optimizer.Momentum(learning_rate=0.05, momentum=0.9).minimize(loss)
    main.random_seed = seed
    return main, startup, loss


def _feeds(k, bs=16, seed=3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(k):
        x = rng.randn(bs, 8).astype("float32")
        out.append({"x": x, "y": x.sum(1, keepdims=True).astype("float32")})
    return out


def _loss(v):
    return float(np.asarray(v).reshape(-1)[0])


def _exported(tmp_path, seed, scope_seed, feed, dropout=0.0):
    main, startup, loss = _build(pt, seed, dropout)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope(seed=scope_seed)
    with pt.scope_guard(scope):
        exe.run(startup)
        path = export_train_step(str(tmp_path / "step"), feed, [loss], program=main,
                                 scope=scope)
    return path, main, loss, exe, scope


def test_runner_matches_executor_bit_for_bit(tmp_path):
    """The runner's steps are Executor.run's on the same feeds from the same
    state: the same prepared block, exported (no tolerance)."""
    feeds = _feeds(6)
    path, main, loss, exe, scope = _exported(tmp_path, 0, 5, feeds[0])
    assert path.endswith(".npz") and os.path.exists(path)
    with pt.scope_guard(scope):
        exe_losses = [_loss(exe.run(main, feed=f, fetch_list=[loss.name])[0]) for f in feeds]
    runner = TrainStepRunner.load(path)
    run_losses = [_loss(runner.run(f)[0]) for f in feeds]
    assert run_losses == exe_losses
    assert run_losses[-1] < run_losses[0]
    for n, v in runner.state().items():
        np.testing.assert_array_equal(v, scope.vars[n].numpy(), err_msg=n)
    with pytest.raises(ValueError, match="missing feeds"):
        runner.run({"x": feeds[0]["x"]})


def test_runner_state_roundtrip(tmp_path):
    """save_state / load_state: a restored runner continues the SAME
    trajectory as one that never stopped (bit for bit)."""
    feeds = _feeds(8, seed=11)
    path, *_ = _exported(tmp_path, 7, 9, feeds[0])
    a = TrainStepRunner.load(path)
    for f in feeds[:4]:
        a.run(f)
    ckpt = a.save_state(str(tmp_path / "ckpt"))
    tail_a = [_loss(a.run(f)[0]) for f in feeds[4:]]
    b = TrainStepRunner.load(path)  # fresh initial state...
    b.load_state(ckpt)  # ...fast-forwarded to step 4
    tail_b = [_loss(b.run(f)[0]) for f in feeds[4:]]
    assert tail_a == tail_b
    np.savez(str(tmp_path / "bad.npz"), w=np.zeros(1))
    with pytest.raises(ValueError, match="does not match"):
        b.load_state(str(tmp_path / "bad.npz"))


def test_dropout_runner_resumes_the_same_trajectory(tmp_path):
    """A step that draws (dropout 0.3): the runner carries the generator's
    state (__rng__), so a runner restored from save_state draws what the one
    that never stopped draws, bit for bit, and a fresh runner repeats the
    first step."""
    feeds = _feeds(8, seed=2)
    path, *_ = _exported(tmp_path, 3, 4, feeds[0], dropout=0.3)
    a = TrainStepRunner.load(path)
    head = [_loss(a.run(f)[0]) for f in feeds[:3]]
    ckpt = a.save_state(str(tmp_path / "ckpt"))
    tail_a = [_loss(a.run(f)[0]) for f in feeds[3:]]
    b = TrainStepRunner.load(path)
    b.load_state(ckpt)
    tail_b = [_loss(b.run(f)[0]) for f in feeds[3:]]
    assert tail_a == tail_b
    assert _loss(TrainStepRunner.load(path).run(feeds[0])[0]) == head[0]


def test_artifact_trains_in_fresh_process(tmp_path):
    """The demo_trainer.cc scenario: a new process that imports only the
    artifact module and numpy, and no jax, trains the exported step and the
    loss falls."""
    path, *_ = _exported(tmp_path, 1, 2, _feeds(1)[0])
    driver = textwrap.dedent(
        """
        import sys
        import numpy as np
        sys.path.insert(0, %r)
        from paddle_tpu_torch.train_export import load_train_step

        runner = load_train_step(%r)
        rng = np.random.RandomState(3)
        losses = []
        for _ in range(20):
            x = rng.randn(16, 8).astype("float32")
            feed = {"x": x, "y": x.sum(1, keepdims=True).astype("float32")}
            losses.append(float(np.asarray(runner.run(feed)[0]).reshape(())))
        assert all(np.isfinite(losses)), losses
        assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])
        assert "jax" not in sys.modules and "paddle_tpu" not in sys.modules
        print("ARTIFACT_TRAIN_OK %%.5f %%.5f" %% (losses[0], losses[-1]))
        """
    ) % (REPO, path)
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    proc = subprocess.run([sys.executable, "-c", driver], capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert "ARTIFACT_TRAIN_OK" in proc.stdout


def test_runner_matches_jax_runner(tmp_path):
    """The port's runner against the JAX package's from one state (the JAX
    startup's, carried by convert.load_into_scope): losses at rtol 1e-5
    (float32 sums in another order)."""
    import paddle_tpu.fluid as jfluid
    from paddle_tpu.executor import Scope as JScope
    from paddle_tpu.executor import scope_guard as jscope_guard
    from paddle_tpu.train_export import TrainStepRunner as JRunner
    from paddle_tpu.train_export import export_train_step as jexport

    feeds = _feeds(6, seed=5)
    jmain, jstartup, jloss = _build(jfluid, seed=4)
    jscope = JScope(seed=6)
    with jscope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(jstartup)
        jpath = jexport(str(tmp_path / "jstep"), feeds[0], [jloss], program=jmain,
                        scope=jscope)
    main, startup, loss = _build(pt, seed=4)
    names = convert.persistable_names(main)
    scope = pt.Scope(seed=6)
    with pt.scope_guard(scope):
        pt.Executor(pt.CPUPlace()).run(startup)
        convert.load_into_scope(scope, {n: np.asarray(jscope.vars[n]) for n in names}, names)
        path = export_train_step(str(tmp_path / "step"), feeds[0], [loss], program=main,
                                 scope=scope)
    jr, pr = JRunner.load(jpath), TrainStepRunner.load(path)
    want = [_loss(jr.run(f)[0]) for f in feeds]
    got = [_loss(pr.run(f)[0]) for f in feeds]
    np.testing.assert_allclose(got, want, rtol=1e-5)


SIX = ("flash_forward", "flash_backward", "gemm_bias_act", "fused_layer_norm",
       "fused_layer_norm_grad", "multi_tensor_adam")


def test_flash_transformer_step_holds_the_kernel_ops(tmp_path):
    """The small use_flash Transformer under training_fused: its exported
    step holds the six registered ops (flash forward / backward, the GEMM
    epilogue, layer_norm forward / backward, multi-tensor Adam), and the
    loaded runner's first 2 losses equal Executor.run's bit for bit."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_transformer_case import SMALL_FLASH, build, make_batch

    from paddle_tpu_torch.models import transformer as ptransformer

    saved = flags.get_flags("pass_pipeline")
    flags.set_flags({"pass_pipeline": "training_fused"})
    try:
        main, startup, loss = build(pt, ptransformer, SMALL_FLASH)
        exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope(seed=7)
        with pt.scope_guard(scope):
            exe.run(startup)
            path = export_train_step(str(tmp_path / "flash"), make_batch(SMALL_FLASH, 0),
                                     [loss], program=main, scope=scope)
            runner = TrainStepRunner.load(path)
            want = [_loss(exe.run(main, feed=make_batch(SMALL_FLASH, s),
                                  fetch_list=[loss.name])[0]) for s in range(2)]
    finally:
        flags.set_flags(saved)
    graph = compile_cache.read_artifact(path)["program"].graph
    targets = {str(n.target) for n in graph.nodes if n.op == "call_function"}
    for name in SIX:
        assert "paddle_tpu_torch.%s.default" % name in targets, (name, sorted(targets))
    got = [_loss(runner.run(make_batch(SMALL_FLASH, s))[0]) for s in range(2)]
    assert got == want


def test_export_refuses_a_block_that_creates_persistables(tmp_path):
    """A block that creates persistables (a startup program) raises, as the
    JAX package's does: the state must exist before the export."""
    main, startup, loss = _build(pt)
    param = main.global_block().all_parameters()[0].name
    scope = pt.Scope(place=pt.CPUPlace())
    with pytest.raises(RuntimeError, match="creates persistables"):
        export_train_step(str(tmp_path / "s"), {}, [param], program=startup, scope=scope)
