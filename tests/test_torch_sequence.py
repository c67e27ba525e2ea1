"""Every sequence op of the torch port (paddle_tpu_torch/ops/sequence_ops.py)
against the JAX package's lowering (paddle_tpu/ops/sequence_ops.py), on the
CPU: the same seed-made numpy inputs through both lowerings, forward and
the generic vjp grad, over ragged lengths that include 1 and the maximum.
dynamic_lstm (peepholes on and off, is_reverse both ways, with H0 / C0)
and dynamic_gru come first. The cases mirror tests/test_sequence.py,
tests/test_sequence_pad_decode.py and tests/test_ops_seq_rnn.py; the
layers are held against the JAX package through whole programs too
(ragged data feeds, the length companions, sequence_conv_pool).

Tolerance: atol = rtol = 1e-5 (f32 in both, sums in another order).
"""

import numpy as np
import pytest

from torch_rnn_cases import assert_runs_close, check_op, run_both

TOL = 1e-5
B, T = 4, 7
LENS = np.array([7, 1, 4, 6], np.int32)  # 1 and the maximum among them


def _rng(seed):
    return np.random.RandomState(seed)


def _f(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("peepholes", [True, False])
@pytest.mark.parametrize("init", [False, True])
def test_dynamic_lstm(reverse, peepholes, init):
    rng = _rng(1)
    h = 5
    ins = {"Input": [_f(rng, B, T, 4 * h)], "Weight": [_f(rng, h, 4 * h) * 0.5],
           "SeqLen": [LENS], "Bias": [_f(rng, 1, (7 if peepholes else 4) * h)]}
    if init:
        ins["H0"] = [_f(rng, B, h)]
        ins["C0"] = [_f(rng, B, h)]
    out = check_op("dynamic_lstm", ins, {"use_peepholes": peepholes, "is_reverse": reverse}, TOL)
    # padding is zero, and a length-1 row's state after its one step holds
    assert np.all(out["Hidden"][0][1, 1:] == 0)


def test_dynamic_lstm_without_bias():
    rng = _rng(2)
    h = 3
    check_op("dynamic_lstm", {"Input": [_f(rng, B, T, 4 * h)], "Weight": [_f(rng, h, 4 * h)],
                              "SeqLen": [LENS]}, {"use_peepholes": False}, TOL)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("init", [False, True])
def test_dynamic_gru(reverse, init):
    rng = _rng(3)
    h = 5
    ins = {"Input": [_f(rng, B, T, 3 * h)], "Weight": [_f(rng, h, 3 * h) * 0.5],
           "SeqLen": [LENS], "Bias": [_f(rng, 1, 3 * h)]}
    if init:
        ins["H0"] = [_f(rng, B, h)]
    check_op("dynamic_gru", ins, {"is_reverse": reverse}, TOL)


def test_lstm_unit():
    rng = _rng(4)
    check_op("lstm_unit", {"X": [_f(rng, B, 12)], "C_prev": [_f(rng, B, 3)]},
             {"forget_bias": 0.5}, TOL)


@pytest.mark.parametrize("bias", [True, False])
def test_gru_unit(bias):
    rng = _rng(5)
    ins = {"Input": [_f(rng, B, 9)], "HiddenPrev": [_f(rng, B, 3)], "Weight": [_f(rng, 3, 9)]}
    if bias:
        ins["Bias"] = [_f(rng, 1, 9)]
    check_op("gru_unit", ins, {}, TOL)


@pytest.mark.parametrize("ptype", ["SUM", "AVERAGE", "SQRT", "MAX", "LAST", "FIRST"])
def test_sequence_pool(ptype):
    rng = _rng(6)
    check_op("sequence_pool", {"X": [_f(rng, B, T, 3)], "SeqLen": [LENS]},
             {"pooltype": ptype}, TOL)


@pytest.mark.parametrize("shape", [(B, T), (B, T, 1)])
def test_sequence_softmax(shape):
    rng = _rng(7)
    check_op("sequence_softmax", {"X": [_f(rng, *shape)], "SeqLen": [LENS]}, {}, TOL)


@pytest.mark.parametrize("ctx_len,ctx_start", [(3, -1), (4, -1), (2, 0)])
def test_sequence_conv(ctx_len, ctx_start):
    rng = _rng(8)
    check_op("sequence_conv", {"X": [_f(rng, B, T, 3)], "Filter": [_f(rng, ctx_len * 3, 4)],
                               "SeqLen": [LENS]},
             {"contextLength": ctx_len, "contextStart": ctx_start}, TOL)


def test_sequence_reverse():
    rng = _rng(9)
    out = check_op("sequence_reverse", {"X": [_f(rng, B, T, 2)], "SeqLen": [LENS]}, {}, TOL)
    assert out["Y"][0].shape == (B, T, 2)


@pytest.mark.parametrize("xshape", [(B, 3), (B, 1, 3)])
def test_sequence_expand(xshape):
    rng = _rng(10)
    check_op("sequence_expand", {"X": [_f(rng, *xshape)], "Y": [_f(rng, B, T, 3)]}, {}, TOL)


@pytest.mark.parametrize("maxlen", [-1, 5, 9])
@pytest.mark.parametrize("vector_pad", [False, True])
def test_sequence_pad(maxlen, vector_pad):
    rng = _rng(11)
    pad = _f(rng, 3) if vector_pad else np.array([-1.5], np.float32)
    check_op("sequence_pad", {"X": [_f(rng, B, T, 3)], "PadValue": [pad], "SeqLen": [LENS]},
             {"padded_length": maxlen}, TOL)


def test_sequence_unpad():
    rng = _rng(12)
    check_op("sequence_unpad", {"X": [_f(rng, B, T, 2)], "Length": [LENS]}, {}, TOL)


@pytest.mark.parametrize("dtype", ["int64", "float32", "bool"])
def test_sequence_mask(dtype):
    check_op("sequence_mask", {"X": [LENS]}, {"maxlen": T + 2, "out_dtype": dtype}, TOL,
             grad=False)


def test_sequence_concat():
    rng = _rng(13)
    check_op("sequence_concat", {"X": [_f(rng, B, T, 2), _f(rng, B, 3, 2)],
                                 "SeqLen": [LENS, np.array([3, 1, 2, 3], np.int32)]}, {}, TOL)


def test_sequence_expand_as():
    rng = _rng(14)
    check_op("sequence_expand_as", {"X": [_f(rng, B, 3)], "SeqLen": [LENS],
                                    "Y": [_f(rng, B, T, 3)]}, {}, TOL)


def test_sequence_slice():
    rng = _rng(15)
    check_op("sequence_slice", {"X": [_f(rng, B, T, 2)],
                                "Offset": [np.array([0, 0, 1, 2], np.int32)],
                                "Length": [np.array([7, 1, 3, 2], np.int32)]}, {}, TOL)


@pytest.mark.parametrize("trailing", [False, True])
def test_sequence_erase(trailing):
    rng = _rng(16)
    x = rng.randint(0, 5, (B, T) + ((1,) if trailing else ())).astype(np.int32)
    check_op("sequence_erase", {"X": [x], "SeqLen": [LENS]}, {"tokens": [2, 3]}, TOL,
             grad=False)


def test_sequence_reshape():
    rng = _rng(17)
    lens = np.array([4, 2, 6, 2], np.int32)
    check_op("sequence_reshape", {"X": [_f(rng, B, 6, 4)], "SeqLen": [lens]}, {"new_dim": 8},
             TOL)


def test_sequence_scatter():
    rng = _rng(18)
    ids = rng.randint(0, 6, (B, 3, 1)).astype(np.int32)
    ids[0, 0, 0] = ids[0, 1, 0]  # a repeated id accumulates
    check_op("sequence_scatter", {"X": [_f(rng, B, 6)], "Ids": [ids],
                                  "Updates": [_f(rng, B, 3, 1)],
                                  "SeqLen": [np.array([3, 1, 2, 3], np.int32)]}, {}, TOL)


@pytest.mark.parametrize("trailing", [False, True])
def test_sequence_enumerate(trailing):
    rng = _rng(19)
    x = rng.randint(1, 9, (B, T) + ((1,) if trailing else ())).astype(np.int32)
    check_op("sequence_enumerate", {"X": [x], "SeqLen": [LENS]},
             {"win_size": 3, "pad_value": -1}, TOL, grad=False)


@pytest.mark.parametrize("real_size", [False, True])
def test_im2sequence(real_size):
    rng = _rng(20)
    ins = {"X": [_f(rng, 3, 2, 6, 5)]}
    attrs = {"kernels": [2, 3], "strides": [2, 1], "paddings": [1, 0, 0, 1]}
    if real_size:
        ins["Y"] = [np.array([[6, 5], [3, 4], [4, 2]], np.int32)]
        attrs["out_stride"] = [1, 1]
    check_op("im2sequence", ins, attrs, TOL)


def test_row_conv():
    rng = _rng(21)
    check_op("row_conv", {"X": [_f(rng, B, T, 3)], "Filter": [_f(rng, 3, 3)],
                          "SeqLen": [LENS]}, {}, TOL)


# ---------------------------------------------------------------------------
# the layers through whole programs, ragged feeds with their @LEN companion
# ---------------------------------------------------------------------------


def _ragged_feed(seed, d=3):
    rng = _rng(seed)
    return {"x": _f(rng, B, T, d), "x@LEN": LENS}


@pytest.mark.parametrize("layer", ["lstm", "lstm_reverse", "gru", "gru_reverse"])
def test_recurrent_layers_train_one_step(layer):
    """fc -> dynamic_lstm / dynamic_gru -> sequence_pool -> mean, one SGD
    step: the loss and every parameter after it."""

    def program_fn(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[3], dtype="float32", lod_level=1)
        rev = layer.endswith("reverse")
        if layer.startswith("lstm"):
            proj = L.fc(x, size=4 * 4)
            h, _ = L.dynamic_lstm(proj, size=4 * 4, is_reverse=rev)
        else:
            proj = L.fc(x, size=3 * 4)
            h = L.dynamic_gru(proj, size=4, is_reverse=rev)
        loss = L.mean(L.sequence_pool(h, "sum"))
        fluid.optimizer.SGD(0.5).minimize(loss)
        return [loss, h]

    want, got, names, (jstate, pstate) = run_both(program_fn, _ragged_feed(30), steps=2)
    assert_runs_close(got, want, TOL, TOL, layer)
    for n in names:
        np.testing.assert_allclose(pstate[n], jstate[n], rtol=TOL, atol=TOL, err_msg=n)


def test_data_lod_level_declares_the_length_companion():
    """layers.data(lod_level=1): (batch, time, *shape) plus an int32
    <name>@LEN var the DataFeeder fills, in both packages alike."""
    import paddle_tpu.fluid as jfluid

    import paddle_tpu_torch.fluid as pfluid

    shapes = []
    for fluid in (jfluid, pfluid):
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            w = fluid.layers.data(name="w", shape=[1], dtype="int64", lod_level=1)
            v = fluid.layers.data(name="v", shape=[4, 2], dtype="float32", lod_level=1,
                                  append_batch_size=False)
        ln = main.global_block().var("w@LEN")
        shapes.append((tuple(w.shape), w._len_name, tuple(ln.shape), ln.dtype,
                       tuple(v.shape), v._len_name))
        feeder = fluid.DataFeeder([w], place=None, program=main)
        fed = feeder.feed([([3, 4, 5],), ([7],)])
        assert fed["w"].shape == (2, 3, 1) and fed["w@LEN"].tolist() == [3, 1]
        assert fed["w@LEN"].dtype == np.int32
    assert shapes[0] == shapes[1], shapes
    assert shapes[1][:4] == ((-1, -1, 1), "w@LEN", (-1,), "int32")


def test_sequence_layers_program():
    """The sequence layers chained over one ragged input (softmax, conv,
    reverse, first / last step, pad / unpad, expand_as, concat): every
    fetch in both packages, and one SGD step's parameters."""

    def program_fn(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[3], dtype="float32", lod_level=1)
        conv = L.sequence_conv(x, num_filters=4, filter_size=3, act="tanh")
        sm = L.sequence_softmax(L.fc(conv, size=1, num_flatten_dims=2))
        rev = L.sequence_reverse(conv)
        first = L.sequence_first_step(rev)
        last = L.sequence_last_step(conv)
        pad_v = L.fill_constant([1], "float32", 0.5)
        padded, plen = L.sequence_pad(conv, pad_v, maxlen=T + 1)
        unpadded = L.sequence_unpad(padded, plen)
        cat = L.sequence_concat([conv, rev])
        exp = L.sequence_expand_as(first, conv)
        loss = L.mean(L.elementwise_add(first, last)) + L.mean(sm) + L.mean(unpadded) \
            + L.mean(L.sequence_pool(cat, "sum")) + L.mean(exp)
        fluid.optimizer.SGD(0.3).minimize(loss)
        return [loss, sm, padded, plen, unpadded, cat, exp]

    want, got, names, (jstate, pstate) = run_both(program_fn, _ragged_feed(31), steps=2)
    assert_runs_close(got, want, TOL, TOL, "sequence layers")
    for n in names:
        np.testing.assert_allclose(pstate[n], jstate[n], rtol=TOL, atol=TOL, err_msg=n)


def test_sequence_conv_pool_and_row_conv_program():
    def program_fn(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[3], dtype="float32", lod_level=1)
        pooled = fluid.nets.sequence_conv_pool(x, num_filters=5, filter_size=3, act="tanh")
        rc = L.row_conv(x, future_context_size=2, act="relu")
        loss = L.mean(pooled) + L.mean(rc)
        fluid.optimizer.SGD(0.3).minimize(loss)
        return [loss, pooled, rc]

    want, got, names, (jstate, pstate) = run_both(program_fn, _ragged_feed(32), steps=2)
    assert_runs_close(got, want, TOL, TOL, "sequence_conv_pool")
    for n in names:
        np.testing.assert_allclose(pstate[n], jstate[n], rtol=TOL, atol=TOL, err_msg=n)
