"""The recurrent models of the torch port against the JAX package, on the
CPU, from the same weights (the JAX package's startup state carried over
by name with convert.load_into_scope):

- models/stacked_lstm.py at dict 50, emb 16, hid 16, stacked_num 3, 7
  words, ragged lengths (1 and 7 among them): 3 Adam steps, the losses and
  every persistable;
- models/machine_translation.py: the copy task of
  tests/test_machine_translation.py in the port alone, with its gates; the
  first 3 losses against the JAX package's; beam-decode ids equal to the
  JAX package's on the same trained weights, scores close;
- the training_fused pass's tags on both models' programs, tag for tag;
- the weights' layouts: each package's parameters load into the other's
  program by name, shape and dtype, with no change of layout.

Tolerances: losses rtol 1e-4, atol 1e-5 (a few steps of f32 recurrences
summed in another order); persistables rtol 1e-4, atol 1e-5; beam scores
rtol 1e-5 with an absolute floor of 1e-6 (a near-zero log probability
carries the absolute rounding of log_softmax over logits of magnitude
about 8, where one f32 ulp is 1e-6); ids exact.
"""

import importlib

import numpy as np
import pytest

from paddle_tpu_torch.tools import profile_rnn as rnn

from torch_rnn_cases import build, exe_scope, run_both

RTOL, ATOL = 1e-4, 1e-5
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6
TAGS = ("__pallas_group__", "__pallas_kernel__", "__fusion_group__")
LSTM_SMALL = dict(dict_dim=50, emb_dim=16, hid_dim=16, stacked_num=3, class_num=2, batch=4,
                  seq_len=7, lr=2e-3)
COPY = rnn.COPY


def _models(fluid, name):
    pkg = fluid.__name__.split(".")[0]
    return importlib.import_module("%s.models.%s" % (pkg, name))


def _lstm_program(cfg):
    def program_fn(fluid):
        words = fluid.layers.data(name="words", shape=[1], dtype="int64", lod_level=1)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        loss, acc, _ = _models(fluid, "stacked_lstm").stacked_lstm_net(
            words, label, cfg["dict_dim"], emb_dim=cfg["emb_dim"], hid_dim=cfg["hid_dim"],
            stacked_num=cfg["stacked_num"], class_num=cfg["class_num"])
        fluid.optimizer.Adam(learning_rate=cfg["lr"]).minimize(loss)
        return [loss, acc]

    return program_fn


def _src(fluid, cfg):
    main = fluid.default_main_program()
    src = fluid.layers.data(name="src", shape=[cfg["batch"], cfg["seq_len"], 1], dtype="int64",
                            append_batch_size=False)
    main.global_block().create_var(name="src_len", shape=(cfg["batch"],), dtype="int64")
    src._len_name = "src_len"
    return src


def _nmt_train_program(cfg):
    def program_fn(fluid):
        b, t = cfg["batch"], cfg["seq_len"]
        src = _src(fluid, cfg)
        trg = fluid.layers.data(name="trg", shape=[b, t + 1, 1], dtype="int64",
                                append_batch_size=False)
        lab = fluid.layers.data(name="lab", shape=[b, t + 1, 1], dtype="int64",
                                append_batch_size=False)
        trg_len = fluid.layers.data(name="trg_len", shape=[b], dtype="int64",
                                    append_batch_size=False)
        loss = _models(fluid, "machine_translation").train_model(
            src, trg, lab, trg_len, cfg["dict_size"], emb_dim=cfg["emb_dim"],
            hid_dim=cfg["hid_dim"])
        fluid.optimizer.Adam(cfg["lr"]).minimize(loss)
        return [loss]

    return program_fn


def _nmt_infer_program(cfg):
    def program_fn(fluid):
        ids, scores = _models(fluid, "machine_translation").infer_model(
            _src(fluid, cfg), cfg["dict_size"], emb_dim=cfg["emb_dim"], hid_dim=cfg["hid_dim"],
            beam_size=cfg["beam_size"], max_out_len=cfg["max_out_len"], start_id=rnn.START,
            end_id=rnn.END)
        return [ids, scores, ids._hyp_len]

    return program_fn


# ---------------------------------------------------------------------------
# the stacked LSTM
# ---------------------------------------------------------------------------


def test_stacked_lstm_three_adam_steps_match():
    feeds = [rnn.lstm_feed(LSTM_SMALL, 3 + i, ragged=True) for i in range(3)]
    want, got, names, (jstate, pstate) = run_both(_lstm_program(LSTM_SMALL), feeds, steps=3)
    jl = [float(s[0].reshape(-1)[0]) for s in want]
    pl = [float(s[0].reshape(-1)[0]) for s in got]
    np.testing.assert_allclose(pl, jl, rtol=RTOL, atol=ATOL)
    for n in names:
        np.testing.assert_allclose(pstate[n], jstate[n], rtol=RTOL, atol=ATOL, err_msg=n)


def test_stacked_lstm_three_adam_steps_match_under_training_fused():
    feeds = [rnn.lstm_feed(LSTM_SMALL, 7 + i, ragged=True) for i in range(3)]
    want, got, names, (jstate, pstate) = run_both(
        _lstm_program(LSTM_SMALL), feeds, steps=3, flags={"pass_pipeline": "training_fused"})
    np.testing.assert_allclose([float(s[0].reshape(-1)[0]) for s in got],
                               [float(s[0].reshape(-1)[0]) for s in want], rtol=RTOL, atol=ATOL)
    for n in names:
        np.testing.assert_allclose(pstate[n], jstate[n], rtol=RTOL, atol=ATOL, err_msg=n)


def test_stacked_lstm_feeds_through_the_data_feeder():
    """The ragged words go through each package's DataFeeder (which pads
    them and fills words@LEN) to the same loss."""
    rng = np.random.RandomState(11)
    samples = [(rng.randint(0, LSTM_SMALL["dict_dim"], n).tolist(), [int(rng.randint(0, 2))])
               for n in (7, 1, 4, 6)]
    losses = []
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        main, startup, fetch = build(pkg, _lstm_program(LSTM_SMALL))
        fluid = importlib.import_module(pkg + ".fluid")
        feeder = fluid.DataFeeder([main.global_block().var("words"),
                                   main.global_block().var("label")], place=None, program=main)
        feed = feeder.feed(samples)
        assert feed["words@LEN"].tolist() == [7, 1, 4, 6]
        exe, scope, guard = exe_scope(pkg, seed=5)
        with guard(scope):
            exe.run(startup)
            if pkg == "paddle_tpu":
                from paddle_tpu_torch import convert

                names = convert.persistable_names(main)
                state = {n: np.asarray(scope.vars[n]) for n in names}
            else:
                from paddle_tpu_torch import convert

                convert.load_into_scope(scope, state, names)
            losses.append(float(exe.run(main, feed=feed, fetch_list=[fetch[0].name])[0]
                                .reshape(-1)[0]))
    np.testing.assert_allclose(losses[1], losses[0], rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the NMT model
# ---------------------------------------------------------------------------


def _copy_batch():
    return rnn.nmt_batch(COPY, np.random.RandomState(7))


def test_nmt_first_three_losses_match():
    batch = _copy_batch()
    want, got, names, (jstate, pstate) = run_both(_nmt_train_program(COPY), batch, steps=3)
    np.testing.assert_allclose([float(s[0].reshape(-1)[0]) for s in got],
                               [float(s[0].reshape(-1)[0]) for s in want], rtol=RTOL, atol=ATOL)
    for n in names:
        np.testing.assert_allclose(pstate[n], jstate[n], rtol=RTOL, atol=ATOL, err_msg=n)


@pytest.fixture(scope="module")
def trained_copy_task():
    """The copy task trained 150 steps in the port alone: (losses, the
    trained persistables, the batch)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import convert

    batch = _copy_batch()
    main, startup, (loss,) = build("paddle_tpu_torch", _nmt_train_program(COPY))
    exe, scope, guard = exe_scope("paddle_tpu_torch")
    with guard(scope):
        exe.run(startup)
        losses = [float(exe.run(main, feed=batch, fetch_list=[loss.name])[0].reshape(-1)[0])
                  for _ in range(COPY["steps"])]
    names = convert.persistable_names(main)
    assert isinstance(scope, pt.Scope)
    return losses, convert.scope_to_numpy(scope, names), batch


def test_nmt_copy_task_gates(trained_copy_task):
    """tests/test_machine_translation.py's gates, in the port alone: the
    last loss under 0.3x the first, and at least half the sources copied
    exactly by the beam decode of the trained batch."""
    losses, state, batch = trained_copy_task
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.3, (losses[0], losses[-1])
    ids, scores, lens = _decode("paddle_tpu_torch", state, batch)
    assert ids.shape[:2] == (COPY["batch"], COPY["beam_size"])
    assert np.isfinite(scores).all()
    assert rnn.copied(batch["src"], batch["src_len"], ids, lens) >= COPY["batch"] // 2


def _decode(pkg, state, batch):
    """The beam decode of `batch` in `pkg` over the trained weights."""
    import jax.numpy as jnp

    from paddle_tpu_torch import convert

    main, startup, fetch = build(pkg, _nmt_infer_program(COPY))
    exe, scope, guard = exe_scope(pkg)
    with guard(scope):
        if pkg == "paddle_tpu":
            for n, v in state.items():
                scope.vars[n] = jnp.asarray(v)
        else:
            exe.run(startup)
            names = [n for n in state if scope.find_var(n) is not None]
            convert.load_into_scope(scope, {n: state[n] for n in names}, names)
        return [np.asarray(v) for v in exe.run(
            main, feed={"src": batch["src"], "src_len": batch["src_len"]},
            fetch_list=[v.name for v in fetch])]


def test_beam_decode_matches_the_jax_package(trained_copy_task):
    """The same trained weights decoded by both packages: the same ids and
    lengths, scores within rtol 1e-5 (absolute floor 1e-6)."""
    _, state, batch = trained_copy_task
    jids, jscores, jlens = _decode("paddle_tpu", state, batch)
    pids, pscores, plens = _decode("paddle_tpu_torch", state, batch)
    np.testing.assert_array_equal(pids, jids)
    np.testing.assert_array_equal(plens, jlens)
    np.testing.assert_allclose(pscores, jscores, rtol=SCORE_RTOL, atol=SCORE_ATOL)


# ---------------------------------------------------------------------------
# the training_fused tags and the weights' layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["lstm", "nmt"])
def test_training_fused_tags_match(model):
    program_fn = _lstm_program(LSTM_SMALL) if model == "lstm" else _nmt_train_program(COPY)
    feeds = (["words", "words@LEN", "label"] if model == "lstm"
             else ["src", "src_len", "trg", "lab", "trg_len"])
    views = []
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        main, _, fetch = build(pkg, program_fn)
        manager = importlib.import_module(pkg + ".passes.manager")
        out = manager.PassManager("training_fused").apply(
            main, scope=None, feed_names=feeds, fetch_names=[fetch[0].name])
        views.append([[(op.type, sorted(op.input_arg_names), sorted(op.output_arg_names),
                        tuple(op.attrs.get(t) for t in TAGS)) for op in blk.ops]
                      for blk in out.blocks])
    assert views[1] == views[0]
    kernels = {v[3][1] for blk in views[1] for v in blk if v[3][1]}
    # the projection fc (a mul and its bias add) takes the GEMM epilogue,
    # Adam one multi_adam run
    assert kernels == {"gemm_epilogue", "multi_adam"}


@pytest.mark.parametrize("model", ["lstm", "nmt"])
def test_weights_carry_with_no_layout_change(model):
    """Every parameter of one package's program has the other's name, shape
    and dtype (the LSTM weight (h, 4h), the GRU weight (h, 3h)), so
    convert.load_into_scope carries them as they are."""
    program_fn = _lstm_program(LSTM_SMALL) if model == "lstm" else _nmt_train_program(COPY)
    params = []
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        main = build(pkg, program_fn)[0]
        params.append(sorted((p.name, tuple(p.shape), p.dtype)
                             for p in main.global_block().all_parameters()))
    assert params[0] == params[1]
    h = LSTM_SMALL["hid_dim"] if model == "lstm" else COPY["hid_dim"]
    want = (h, 4 * h) if model == "lstm" else (h, 3 * h)
    assert any(shape == want for _, shape, _ in params[1])
