"""The loss, decode and evaluation ops of the torch port
(paddle_tpu_torch/ops/loss_ops.py, ops/decode_ops.py, chunk_eval) against
the JAX package's lowerings, on the CPU: every op on the same seed-made
numpy inputs, forward and the generic vjp grad, mirroring
tests/test_loss_ops.py and tests/test_sequence_pad_decode.py's beam-search
cases and a beam loop in a While; the proximal optimizers trained in both
packages and the model-average ops;
the seven learning-rate schedules against the JAX package's over 10 steps;
ChunkEvaluator and EditDistance against the JAX evaluators.

The sampled ops draw from each package's own generator, so nce is held
with its negative samples pinned to the same ids in both (each package's
`_draw_samples` replaced for the test), and sampling_id on one-hot rows.

The JAX package's learning-rate schedules raise as it stands: its
LayerHelper.create_or_get_global_variable passes `persistable` twice when
autoincreased_step_counter gives it. The schedule test replaces that one
method for its duration with a copy that passes it once, and the port's
LayerHelper does so itself.

Tolerance: rtol = atol = 1e-5 (f32 in both); integer results exact.
"""

import numpy as np
import pytest

from torch_rnn_cases import assert_runs_close, check_op, lower_both, assert_outs_close, run_both

TOL = 1e-5
B, T, D = 4, 6, 5
LENS = np.array([6, 1, 3, 5], np.int32)


def _rng(seed):
    return np.random.RandomState(seed)


def _f(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _tags(rng, n=D):
    return rng.randint(0, n, (B, T, 1)).astype(np.int32)


def test_linear_chain_crf():
    rng = _rng(1)
    check_op("linear_chain_crf", {"Emission": [_f(rng, B, T, D)],
                                  "Transition": [_f(rng, D + 2, D)],
                                  "Label": [_tags(rng)], "SeqLen": [LENS]}, {}, TOL)


@pytest.mark.parametrize("with_label", [False, True])
def test_crf_decoding(with_label):
    rng = _rng(2)
    ins = {"Emission": [_f(rng, B, T, D)], "Transition": [_f(rng, D + 2, D)], "SeqLen": [LENS]}
    if with_label:
        ins["Label"] = [_tags(rng)]
    check_op("crf_decoding", ins, {}, TOL, grad=False)


@pytest.mark.parametrize("norm_by_times", [False, True])
def test_warpctc(norm_by_times):
    rng = _rng(3)
    C, L = 6, 3
    check_op("warpctc", {"Logits": [_f(rng, B, T, C)],
                         "Label": [rng.randint(1, C, (B, L, 1)).astype(np.int32)],
                         "LogitsLength": [LENS],
                         "LabelLength": [np.array([3, 0, 2, 1], np.int32)]},
             {"blank": 0, "norm_by_times": norm_by_times}, TOL)


def test_ctc_align():
    rng = _rng(4)
    x = rng.randint(0, 4, (B, T, 1)).astype(np.int32)
    check_op("ctc_align", {"Input": [x], "SeqLen": [LENS]},
             {"blank": 0, "padding_value": -1}, TOL, grad=False)


def _pin_samples(monkeypatch, neg):
    """Both packages' nce draw `neg` as their negative samples."""
    import jax.numpy as jnp
    import torch

    from paddle_tpu.ops import loss_ops as jloss
    from paddle_tpu_torch.ops import loss_ops as ploss

    monkeypatch.setattr(jloss, "_draw_samples", lambda *a, **k: jnp.asarray(neg))
    monkeypatch.setattr(ploss, "_draw_samples", lambda *a, **k: torch.as_tensor(neg).long())


@pytest.mark.parametrize("sampler", ["uniform", "log_uniform", "custom_dist"])
@pytest.mark.parametrize("weighted", [False, True])
def test_nce(monkeypatch, sampler, weighted):
    rng = _rng(5)
    C, S = 9, 4
    _pin_samples(monkeypatch, np.array([0, 3, 3, 8], np.int32))
    ins = {"Input": [_f(rng, B, 3)], "Label": [rng.randint(0, C, (B, 2)).astype(np.int32)],
           "Weight": [_f(rng, C, 3)], "Bias": [_f(rng, C, 1)]}
    if sampler == "custom_dist":
        ins["CustomDistProbs"] = [rng.rand(C).astype(np.float32) + 0.1]
    if weighted:
        ins["SampleWeight"] = [rng.rand(B, 1).astype(np.float32)]
    check_op("nce", ins, {"num_total_classes": C, "num_neg_samples": S, "sampler": sampler},
             TOL)


@pytest.mark.parametrize("bias", [True, False])
def test_hierarchical_sigmoid(bias):
    rng = _rng(6)
    C = 7
    ins = {"X": [_f(rng, B, 3)], "W": [_f(rng, C - 1, 3)],
           "Label": [rng.randint(0, C, (B, 1)).astype(np.int32)]}
    if bias:
        ins["Bias"] = [_f(rng, C - 1, 1)]
    check_op("hierarchical_sigmoid", ins, {"num_classes": C}, TOL)


def test_sampling_id_on_one_hot_rows():
    probs = np.eye(5, dtype=np.float32)[[3, 0, 4, 1]]
    want, got = lower_both("sampling_id", {"X": [probs]}, {})
    assert got["Out"][0].tolist() == want["Out"][0].tolist() == [3, 0, 4, 1]


def test_bpr_loss():
    rng = _rng(7)
    check_op("bpr_loss", {"X": [_f(rng, B, 5)],
                          "Label": [rng.randint(0, 5, (B, 1)).astype(np.int32)]}, {}, TOL)


def test_margin_rank_loss():
    rng = _rng(8)
    label = np.where(rng.rand(6, 1) > 0.5, 1.0, -1.0).astype(np.float32)
    check_op("margin_rank_loss", {"X1": [_f(rng, 6, 1)], "X2": [_f(rng, 6, 1)],
                                  "Label": [label]}, {"margin": 0.1}, TOL)


def test_rank_loss():
    rng = _rng(9)
    check_op("rank_loss", {"Label": [rng.randint(0, 2, (5, 1)).astype(np.float32)],
                           "Left": [_f(rng, 5, 1)], "Right": [_f(rng, 5, 1)]}, {}, TOL)


def test_modified_huber_loss():
    rng = _rng(10)
    check_op("modified_huber_loss", {"X": [_f(rng, 8, 1) * 2],
                                     "Y": [rng.randint(0, 2, (8, 1)).astype(np.float32)]},
             {}, TOL)


def test_huber_loss():
    rng = _rng(11)
    check_op("huber_loss", {"X": [_f(rng, 8, 1) * 2], "Y": [_f(rng, 8, 1)]}, {"delta": 1.0},
             TOL)


@pytest.mark.parametrize("rows", [B, 1])
def test_cos_sim(rows):
    rng = _rng(12)
    check_op("cos_sim", {"X": [_f(rng, B, 6)], "Y": [_f(rng, rows, 6)]}, {}, TOL)


@pytest.mark.parametrize("normalized", [True, False])
def test_edit_distance(normalized):
    rng = _rng(13)
    check_op("edit_distance", {"Hyps": [rng.randint(0, 4, (B, 5, 1)).astype(np.int32)],
                               "Refs": [rng.randint(0, 4, (B, 4, 1)).astype(np.int32)],
                               "HypsLen": [np.array([5, 1, 0, 3], np.int32)],
                               "RefsLen": [np.array([4, 2, 3, 1], np.int32)]},
             {"normalized": normalized}, TOL, grad=False)


@pytest.mark.parametrize("with_states", [False, True])
def test_precision_recall(with_states):
    rng = _rng(14)
    C = 4
    ins = {"Indices": [rng.randint(0, C, (8, 1)).astype(np.int32)],
           "Labels": [rng.randint(0, C, (8, 1)).astype(np.int32)]}
    if with_states:
        ins["StatesInfo"] = [rng.randint(0, 5, (C, 4)).astype(np.float32)]
    check_op("precision_recall", ins, {"class_number": C}, TOL, grad=False)


@pytest.mark.parametrize("op_type", ["proximal_gd", "proximal_adagrad"])
def test_proximal_ops(op_type):
    rng = _rng(15)
    ins = {"Param": [_f(rng, 3, 4)], "Grad": [_f(rng, 3, 4)],
           "LearningRate": [np.array([0.05], np.float32)]}
    if op_type == "proximal_adagrad":
        ins["Moment"] = [np.abs(_f(rng, 3, 4))]
    check_op(op_type, ins, {"l1": 0.01, "l2": 0.02}, TOL, grad=False)


@pytest.mark.parametrize("num_upd", [3, 16383])
def test_average_accumulates_and_apply(num_upd):
    rng = _rng(16)
    sums = [_f(rng, 3, 2) for _ in range(3)]
    counters = [np.array([v], np.int32) for v in (9, 4, num_upd)]
    check_op("average_accumulates", {"Param": [_f(rng, 3, 2)], "Sums": sums,
                                     "Counters": counters},
             {"average_window": 0.5, "min_average_window": 2, "max_average_window": 8}, TOL,
             grad=False)
    check_op("average_apply", {"Param": [_f(rng, 3, 2)], "Sums": sums,
                               "Counters": counters[:2]}, {}, TOL, grad=False)


@pytest.mark.parametrize("scheme", ["IOB", "IOE", "IOBES", "plain"])
def test_chunk_eval(scheme):
    rng = _rng(17)
    n_types = 3
    ntag = {"plain": 1, "IOB": 2, "IOE": 2, "IOBES": 4}[scheme]
    hi = n_types * ntag + 1  # the last label is O
    check_op("chunk_eval", {"Inference": [rng.randint(0, hi, (B, T)).astype(np.int32)],
                            "Label": [rng.randint(0, hi, (B, T)).astype(np.int32)],
                            "SeqLength": [LENS]},
             {"chunk_scheme": scheme, "num_chunk_types": n_types,
              "excluded_chunk_types": [1]}, TOL, grad=False)


# ---------------------------------------------------------------------------
# beam search (ops/decode_ops.py)
# ---------------------------------------------------------------------------


def test_beam_search_step_breaks_ties_as_lax_top_k():
    rng = _rng(18)
    beam, k = 3, 4
    n = 2 * beam
    scores = np.round(rng.randn(n, k), 1).astype(np.float32)  # ties among them
    scores[1, :2] = scores[0, 0]
    pre_ids = np.array([[2], [1], [3], [4], [1], [5]], np.int32)  # end_id 1: finished beams
    want, got = lower_both("beam_search", {
        "pre_ids": [pre_ids], "pre_scores": [_f(rng, n, 1)],
        "ids": [rng.randint(0, 9, (n, k)).astype(np.int32)], "scores": [scores]},
        {"beam_size": beam, "end_id": 1})
    assert_outs_close(got, want, TOL, "beam_search")


@pytest.mark.parametrize("with_parents", [True, False])
def test_beam_search_decode(with_parents):
    rng = _rng(19)
    beam, tcap, b = 3, 5, 2
    n = b * beam
    ids = rng.randint(0, 6, (tcap, n, 1)).astype(np.int32)
    scores = np.sort(_f(rng, tcap, n, 1), axis=0)
    ins = {"Ids": [(ids, np.array(4, np.int32))], "Scores": [(scores, np.array(4, np.int32))]}
    if with_parents:
        parents = (rng.randint(0, beam, (tcap, n)) + np.repeat(np.arange(b) * beam, beam)[None])
        ins["Parents"] = [(parents.astype(np.int32), np.array(4, np.int32))]
    want, got = lower_both("beam_search_decode", ins, {"beam_size": beam, "end_id": 1})
    assert_outs_close(got, want, TOL, "beam_search_decode")


def test_beam_search_full_decode_loop():
    """A greedy-free beam loop in a While over tensor arrays (the shape of
    models/machine_translation.py's decoder), fixed logits a step."""
    V, beam, b, steps = 6, 2, 2, 4
    n = b * beam
    rng = _rng(20)
    table = _f(rng, V, V)

    def program_fn(fluid):
        L = fluid.layers
        logits_tab = L.assign(table)
        pre_ids = L.fill_constant([n, 1], "int64", 0)
        init = np.zeros((n, 1), np.float32)
        init[np.arange(n) % beam != 0] = -1e9
        pre_scores = L.assign(init)
        ids_arr = L.create_array("int64", shape=[steps, n, 1])
        scores_arr = L.create_array("float32", shape=[steps, n, 1])
        parents_arr = L.create_array("int32", shape=[steps, n])
        i = L.fill_constant([1], "int64", 0)
        tmax = L.fill_constant([1], "int64", steps)
        cond = L.less_than(i, tmax)
        w = L.While(cond)
        with w.block():
            logp = L.log_softmax(L.gather(logits_tab, pre_ids))
            top_s, top_i = L.topk(logp, k=beam)
            acc = L.elementwise_add(top_s, pre_scores, axis=0)
            sel_ids, sel_scores, parent = L.beam_search(
                pre_ids, pre_scores, top_i, acc, beam_size=beam, end_id=1,
                return_parent_idx=True)
            L.array_write(sel_ids, i, array=ids_arr)
            L.array_write(sel_scores, i, array=scores_arr)
            L.array_write(parent, i, array=parents_arr)
            L.assign(sel_ids, pre_ids)
            L.assign(sel_scores, pre_scores)
            L.increment(i, value=1, in_place=True)
            L.less_than(i, tmax, cond=cond)
        out_ids, out_scores = L.beam_search_decode(ids_arr, scores_arr, beam_size=beam,
                                                   end_id=1, parents=parents_arr)
        return [out_ids, out_scores, out_ids._hyp_len]

    want, got, _, _ = run_both(program_fn, {})
    assert_runs_close(got, want, TOL, TOL, "beam loop")
    assert got[0][0].shape == (b, beam, steps)


# ---------------------------------------------------------------------------
# the layers: the losses trained in both packages
# ---------------------------------------------------------------------------


def _seq_feed(seed, d=4, tags=D):
    rng = _rng(seed)
    return {"x": _f(rng, B, T, d), "xlen": LENS.astype(np.int64),
            "tags": rng.randint(0, tags, (B, T, 1)).astype(np.int64)}


def _fixed_seq(fluid, d=4):
    """A [B, T, d] input with its length companion, at fixed shapes (as
    tests/test_book.py declares its sequences)."""
    L = fluid.layers
    x = L.data(name="x", shape=[B, T, d], dtype="float32", append_batch_size=False)
    L.data(name="xlen", shape=[B], dtype="int64", append_batch_size=False)
    x._len_name = "xlen"
    return x


def test_crf_layers_train():
    def program_fn(fluid):
        L = fluid.layers
        x = _fixed_seq(fluid)
        tags = L.data(name="tags", shape=[B, T, 1], dtype="int64", append_batch_size=False)
        emission = L.fc(x, size=D)
        emission._len_name = "xlen"
        cost = L.linear_chain_crf(emission, tags, param_attr=fluid.ParamAttr(name="crfw"))
        loss = L.mean(cost)
        decode = L.crf_decoding(emission, param_attr="crfw")
        fluid.optimizer.Adam(0.05).minimize(loss)
        return [loss, decode]

    want, got, names, (jstate, pstate) = run_both(program_fn, _seq_feed(21), steps=3)
    assert_runs_close(got, want, TOL, TOL, "crf")
    for n in names:
        np.testing.assert_allclose(pstate[n], jstate[n], rtol=1e-4, atol=TOL, err_msg=n)


def test_ctc_layers():
    rng = _rng(22)
    feed = {"x": _f(rng, B, T, 4), "x@LEN": LENS,
            "lab": rng.randint(1, 5, (B, 3, 1)).astype(np.int64),
            "lab@LEN": np.array([3, 1, 2, 2], np.int32)}

    def program_fn(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[4], dtype="float32", lod_level=1)
        lab = L.data(name="lab", shape=[1], dtype="int64", lod_level=1)
        logits = L.fc(x, size=5)
        loss = L.mean(L.warpctc(logits, lab, blank=0))
        decoded = L.ctc_greedy_decoder(logits, blank=0)
        dist, seq_num = L.edit_distance(decoded, lab)
        fluid.optimizer.SGD(0.1).minimize(loss)
        return [loss, decoded, dist, seq_num]

    want, got, _, _ = run_both(program_fn, feed, steps=2)
    assert_runs_close(got, want, TOL, TOL, "ctc")


@pytest.mark.parametrize("opt_cls", ["ProximalGD", "ProximalAdagrad"])
def test_proximal_optimizers_train(opt_cls):
    rng = _rng(23)
    w = rng.randn(4, 1).astype("float32")
    feeds = []
    for _ in range(4):
        xs = rng.randn(16, 4).astype("float32")
        feeds.append({"x": xs, "y": xs @ w})

    def program_fn(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[4], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        loss = L.mean(L.square_error_cost(L.fc(x, size=1), y))
        getattr(fluid.optimizer, opt_cls)(0.05, l1=1e-4, l2=1e-4).minimize(loss)
        return [loss]

    want, got, names, (jstate, pstate) = run_both(program_fn, feeds, steps=4)
    assert_runs_close(got, want, TOL, TOL, opt_cls)
    for n in names:
        np.testing.assert_allclose(pstate[n], jstate[n], rtol=TOL, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("head", ["nce", "hsigmoid"])
def test_word2vec_heads_build_the_same_program(head):
    """The book's word2vec heads: the same op types and parameter shapes
    in both packages (nce's samples are each package's own draws)."""
    from torch_rnn_cases import build

    def program_fn(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[8], dtype="float32")
        t = L.data(name="t", shape=[1], dtype="int64")
        if head == "nce":
            cost = L.nce(x, t, num_total_classes=20, num_neg_samples=5)
        else:
            cost = L.hsigmoid(x, t, num_classes=20)
        return [L.mean(cost)]

    progs = [build(p, program_fn)[0] for p in ("paddle_tpu", "paddle_tpu_torch")]
    types = [[op.type for op in p.global_block().ops] for p in progs]
    shapes = [sorted((v.name, tuple(v.shape)) for v in p.global_block().all_parameters())
              for p in progs]
    assert types[0] == types[1] and shapes[0] == shapes[1]


# ---------------------------------------------------------------------------
# learning-rate schedules over the step counter
# ---------------------------------------------------------------------------

SCHEDULES = [
    ("noam_decay", dict(d_model=64, warmup_steps=3)),
    ("exponential_decay", dict(learning_rate=0.1, decay_steps=3, decay_rate=0.5)),
    ("exponential_decay", dict(learning_rate=0.1, decay_steps=3, decay_rate=0.5,
                               staircase=True)),
    ("natural_exp_decay", dict(learning_rate=0.1, decay_steps=2, decay_rate=0.3)),
    ("inverse_time_decay", dict(learning_rate=0.1, decay_steps=2, decay_rate=0.5,
                                staircase=True)),
    ("polynomial_decay", dict(learning_rate=0.1, decay_steps=5, end_learning_rate=0.01,
                              power=2.0)),
    ("polynomial_decay", dict(learning_rate=0.1, decay_steps=3, cycle=True)),
    ("piecewise_decay", dict(boundaries=[2, 6], values=[0.1, 0.05, 0.01])),
    ("cosine_decay", dict(learning_rate=0.1, step_each_epoch=3, epochs=4)),
]


@pytest.fixture
def jax_counter_fixed(monkeypatch):
    from paddle_tpu import layer_helper as jlh

    def create_or_get_global_variable(self, name, *args, **kwargs):
        block = self.main_program.global_block()
        if block.has_var(name):
            return block.var(name)
        kwargs["persistable"] = True
        return block.create_var(name=name, *args, **kwargs)

    monkeypatch.setattr(jlh.LayerHelper, "create_or_get_global_variable",
                        create_or_get_global_variable)


@pytest.mark.parametrize("name,kwargs", SCHEDULES,
                         ids=["%s-%d" % (n, i) for i, (n, _) in enumerate(SCHEDULES)])
def test_learning_rate_schedule(jax_counter_fixed, name, kwargs):
    """10 SGD steps under the schedule: the learning rate fetched every step,
    the loss and the parameters, in both packages."""
    rng = _rng(24)
    xs = rng.randn(6, 3).astype("float32")

    def program_fn(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[3], dtype="float32")
        loss = L.mean(L.fc(x, size=1))
        lr = getattr(L, name)(**kwargs)
        fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
        return [lr, loss]

    want, got, names, (jstate, pstate) = run_both(program_fn, {"x": xs}, steps=10)
    assert_runs_close(got, want, TOL, 1e-7, name)
    lrs = [float(s[0].reshape(-1)[0]) for s in got]
    assert len(set(lrs)) > 1, lrs  # the counter advanced
    for n in names:
        np.testing.assert_allclose(pstate[n], jstate[n], rtol=TOL, atol=1e-6, err_msg=n)


# ---------------------------------------------------------------------------
# evaluators
# ---------------------------------------------------------------------------


def test_chunk_evaluator_matches():
    import warnings

    import paddle_tpu.evaluator as jev

    import paddle_tpu_torch.evaluator as pev

    rng = _rng(25)
    feeds = [{"inf": rng.randint(0, 7, (B, T)).astype(np.int64),
              "lab": rng.randint(0, 7, (B, T)).astype(np.int64), "len": LENS.astype(np.int64)}
             for _ in range(3)]
    evals = {}

    def program_fn(fluid):
        L = fluid.layers
        mod = pev if fluid.__name__.startswith("paddle_tpu_torch") else jev
        inf = L.data(name="inf", shape=[B, T], dtype="int64", append_batch_size=False)
        lab = L.data(name="lab", shape=[B, T], dtype="int64", append_batch_size=False)
        ln = L.data(name="len", shape=[B], dtype="int64", append_batch_size=False)
        ev = evals[mod] = mod.ChunkEvaluator(inf, lab, chunk_scheme="IOB", num_chunk_types=3,
                                             seq_length=ln)
        return list(ev.metrics)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want, got, _, _ = run_both(program_fn, feeds, steps=3)
    assert_runs_close(got, want, TOL, TOL, "chunk counts")
    for mod, runs in ((jev, want), (pev, got)):
        for counts in runs:
            evals[mod].update(*counts)
    np.testing.assert_allclose(evals[pev].eval(None), evals[jev].eval(None), rtol=TOL)
    import paddle_tpu_torch.fluid as pfluid

    assert pfluid.evaluator is pev  # the fluid surface exports it, as the JAX package's does


def test_edit_distance_evaluator_matches():
    import paddle_tpu.evaluator as jev

    import paddle_tpu_torch.evaluator as pev

    rng = _rng(26)
    batches = [(rng.randint(0, 3, (B, 1)).astype(np.float32), B) for _ in range(3)]
    results = []
    for mod in (jev, pev):
        with pytest.warns(DeprecationWarning):
            ev = mod.EditDistance()
        for d, n in batches:
            ev.update(d, n)
        results.append(ev.eval(None))
        ev.reset(None)
    np.testing.assert_allclose(results[1], results[0], rtol=TOL)


@pytest.mark.parametrize("sampler", ["custom_dist", "log_uniform", "uniform"])
def test_sampled_classes_follow_their_distribution(sampler):
    """The port's draws (an inverse CDF over torch.rand, capturable) against
    the sampler's distribution: 40000 draws from a seeded generator, each
    class's frequency within 0.01 of its probability."""
    import torch

    from paddle_tpu_torch.ops import loss_ops as ploss
    from paddle_tpu_torch.ops import registry as preg

    C, S = 6, 40000
    probs = torch.tensor([0.05, 0.1, 0.15, 0.2, 0.2, 0.3])
    ctx = preg.LowerCtx("cpu", device_generator=torch.Generator().manual_seed(3),
                        host_random=False)
    draws = ploss._draw_samples(ctx, {}, sampler, C, S, probs)
    freq = np.bincount(draws.numpy(), minlength=C) / S
    want = {"custom_dist": probs.numpy(),
            "log_uniform": ploss._log_uniform_probs(C, "cpu").numpy(),
            "uniform": np.full(C, 1.0 / C)}[sampler]
    np.testing.assert_allclose(freq, want, atol=0.01)


def test_sampling_id_follows_the_rows():
    import torch

    from paddle_tpu_torch.ops import registry as preg

    probs = np.tile(np.array([[0.2, 0.0, 0.5, 0.3]], np.float32), (40000, 1))
    ctx = preg.LowerCtx("cpu", device_generator=torch.Generator().manual_seed(4),
                        host_random=False)
    (ids,) = preg.get("sampling_id").lower(ctx, {"X": [torch.from_numpy(probs)]}, {})["Out"]
    freq = np.bincount(ids.numpy(), minlength=4) / len(probs)
    np.testing.assert_allclose(freq, probs[0], atol=0.01)
