"""The secondary NN ops (paddle_tpu_torch/ops/nn_extra_ops.py), the fused
and composite ops (ops/compose_ops.py) and int8_conv2d (ops/quant_ops.py)
of the torch port against the JAX package's lowerings, on the CPU: each
case runs one op's lowering in both packages on the same seed-made numpy
inputs, and the generic grad (`<type>_grad`, torch.func.vjp against
jax.vjp) with the same seed-made cotangents on every floating output
(tests/torch_rnn_cases.py check_op). None of these ops reaches a Pallas
kernel in the JAX package, so its lowerings run as they are.

Tolerances (rtol = atol, forward and grad):
- 1e-5 for the elementwise, pooling and small-tensor ops (f32 both sides,
  sums in another order);
- 1e-4 for the convolutions, the recurrent ops and the samplers (longer f32
  sums, or many steps of them);
- integer outputs (Mask, mean_iou's counts, is_empty) exactly, and
  int8_conv2d bit for bit (exact integer sums rounded once to f32).

The max-pool masks' grads are explicit grad ops (a scatter through the
mask) in both packages and are compared as such; random_crop draws its
offsets from other generators than the JAX package's PRNG key, so its
output is checked to be a window of the input at one offset for the whole
batch. The shape inference of the ops with several outputs or a
data-dependent shape runs on meta tensors when a program is built, and is
checked against what a run fetches.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.ops import quant_ops, registry

from torch_rnn_cases import assert_outs_close, check_op, lower_both, lower_one

F5, F4 = 1e-5, 1e-4


def _r(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype("float32")


def _u(shape, seed, lo, hi):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype("float32")


def _lens(*v):
    return np.asarray(v, dtype="int32")


def _lstm_blob(d, h, layers, bidirec, seed):
    from paddle_tpu_torch.ops.compose_ops import cudnn_lstm_weight_size

    return _r((cudnn_lstm_weight_size(d, h, layers, bidirec),), seed, 0.3)


# op type -> [(case, inputs {slot: [array]}, attrs, tol, grad)]; every op
# type of the slice but max_pool*_with_index (below), random_crop (a window
# check) and int8_conv2d (bit for bit, below)
CASES = {
    "conv3d": [
        ("s2_p1", {"Input": [_r((2, 3, 6, 6, 6), 1)], "Filter": [_r((4, 3, 3, 3, 3), 2)]},
         {"strides": [2, 2, 2], "paddings": [1, 1, 1]}, F4, True),
        ("groups_dilation", {"Input": [_r((1, 4, 7, 7, 7), 3)],
                             "Filter": [_r((6, 2, 2, 3, 3), 4)]},
         {"groups": 2, "dilations": [2, 1, 2], "paddings": [1, 0, 1]}, F4, True),
    ],
    "conv3d_transpose": [
        ("s2_p1", {"Input": [_r((2, 3, 3, 3, 3), 5)], "Filter": [_r((3, 4, 3, 3, 3), 6)]},
         {"strides": [2, 2, 2], "paddings": [1, 1, 1]}, F4, True),
        ("groups2", {"Input": [_r((1, 4, 3, 4, 3), 7)], "Filter": [_r((4, 3, 2, 3, 2), 8)]},
         {"strides": [1, 2, 2], "groups": 2}, F4, True),
    ],
    "conv2d_transpose": [
        ("s2_p1", {"Input": [_r((2, 3, 5, 5), 9)], "Filter": [_r((3, 4, 4, 4), 10)]},
         {"strides": [2, 2], "paddings": [1, 1]}, F4, True),
        ("groups2_dilation2", {"Input": [_r((2, 4, 5, 6), 11)], "Filter": [_r((4, 3, 3, 3), 12)]},
         {"strides": [2, 1], "paddings": [1, 2], "dilations": [2, 2], "groups": 2}, F4, True),
        ("k1", {"Input": [_r((1, 3, 4, 4), 13)], "Filter": [_r((3, 2, 1, 1), 14)]},
         {}, F4, True),
    ],
    "depthwise_conv2d_transpose": [
        ("s2", {"Input": [_r((2, 4, 5, 5), 15)], "Filter": [_r((4, 1, 3, 3), 16)]},
         {"strides": [2, 2], "paddings": [1, 1], "groups": 4}, F4, True),
    ],
    "pool3d": [
        ("avg_2", {"X": [_r((2, 3, 4, 4, 4), 17)]},
         {"pooling_type": "avg", "ksize": [2, 2, 2], "strides": [2, 2, 2]}, F5, True),
        ("max_3_s2_p1", {"X": [_r((2, 3, 5, 6, 5), 18)]},
         {"pooling_type": "max", "ksize": [3, 3, 3], "strides": [2, 2, 2],
          "paddings": [1, 1, 1]}, F5, True),
        ("avg_exclusive_p1", {"X": [_r((1, 2, 5, 5, 5), 19)]},
         {"pooling_type": "avg", "ksize": [3, 3, 3], "strides": [2, 2, 2],
          "paddings": [1, 1, 1], "exclusive": True}, F5, True),
        ("global_max", {"X": [_r((2, 3, 3, 4, 5), 20)]},
         {"pooling_type": "max", "global_pooling": True}, F5, True),
    ],
    "unpool": [
        ("k2", {"X": [_r((2, 3, 2, 2), 21)],
                "Indices": [np.stack([np.random.RandomState(22 + i).choice(16, 4, replace=False)
                                      for i in range(6)]).reshape(2, 3, 2, 2).astype("int32")]},
         {"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0]}, F5, True),
    ],
    "spp": [
        ("max_h2", {"X": [_r((2, 3, 4, 4), 23)]},
         {"pyramid_height": 2, "pooling_type": "max"}, F5, True),
        ("max_h3_odd", {"X": [_r((2, 3, 13, 13), 24)]},
         {"pyramid_height": 3, "pooling_type": "max"}, F5, True),
        ("avg_h3", {"X": [_r((2, 3, 7, 9), 25)]},
         {"pyramid_height": 3, "pooling_type": "avg"}, F5, True),
    ],
    "maxout": [("g2", {"X": [_r((2, 6, 4, 4), 26)]}, {"groups": 2}, F5, True)],
    "group_norm": [
        ("g2", {"X": [_r((2, 4, 3, 3), 27)], "Scale": [_r((4,), 28)], "Bias": [_r((4,), 29)]},
         {"epsilon": 1e-5, "groups": 2}, F4, True),
        ("g4_no_affine", {"X": [_r((3, 8, 5), 30, 3.0)]}, {"groups": 4}, F4, True),
    ],
    "affine_channel": [
        ("nchw", {"X": [_r((2, 3, 4, 4), 31)], "Scale": [_r((3,), 32)], "Bias": [_r((3,), 33)]},
         {}, F5, True),
        ("nhwc", {"X": [_r((2, 4, 4, 3), 34)], "Scale": [_r((3,), 35)], "Bias": [_r((3,), 36)]},
         {"data_layout": "NHWC"}, F5, True),
    ],
    "bilinear_tensor_product": [
        ("bias", {"X": [_r((4, 5), 37)], "Y": [_r((4, 6), 38)], "Weight": [_r((3, 5, 6), 39)],
                  "Bias": [_r((1, 3), 40)]}, {}, F4, True),
    ],
    "grid_sampler": [
        ("inside_and_out", {"X": [_r((2, 3, 5, 6), 41)],
                            "Grid": [_u((2, 4, 5, 2), 42, -1.2, 1.2)]}, {}, F4, True),
    ],
    "affine_grid": [
        ("attr_shape", {"Theta": [_r((2, 2, 3), 43)]}, {"output_shape": [2, 3, 4, 5]}, F5, True),
    ],
    "minus": [("plain", {"X": [_r((3, 4), 44)], "Y": [_r((3, 4), 45)]}, {}, F5, True)],
    "l1_norm": [("plain", {"X": [_r((3, 4), 46)]}, {}, F5, True)],
    "squared_l2_distance": [
        ("rows", {"X": [_r((3, 4), 47)], "Y": [_r((3, 4), 48)]}, {}, F5, True),
        ("broadcast_y", {"X": [_r((3, 4), 49)], "Y": [_r((1, 4), 50)]}, {}, F5, True),
    ],
    "selu": [("attrs", {"X": [_r((3, 5), 51)]}, {"scale": 1.2, "alpha": 1.5}, F5, True),
             ("defaults", {"X": [_r((4, 3), 52)]}, {}, F5, True)],
    "fill": [("f32", {}, {"shape": [3, 4], "dtype": "float32",
                          "value": _r((12,), 53).tolist()}, F5, False),
             ("int32", {}, {"shape": [2, 3], "dtype": "int32",
                            "value": [1, 2, 3, 4, 5, 6]}, F5, False)],
    "is_empty": [("full", {"X": [_r((3, 4), 54)]}, {}, F5, False),
                 ("empty", {"X": [np.zeros((0, 4), "float32")]}, {}, F5, False)],
    "multiplex": [
        ("three", {"X": [_r((4, 5), 55), _r((4, 5), 56), _r((4, 5), 57)],
                   "Ids": [np.asarray([[2], [0], [1], [2]], "int32")]}, {}, F5, True),
    ],
    "crop": [
        ("attrs", {"X": [_r((4, 6), 58)]}, {"shape": [2, 3], "offsets": [1, 2]}, F5, True),
        ("y_and_offsets", {"X": [_r((3, 5, 6), 59)], "Y": [_r((2, 3, 4), 60)],
                           "Offsets": [np.asarray([1, 0, 2], "int32")]}, {}, F5, True),
    ],
    "pad_constant_like": [
        ("pad", {"X": [_r((4, 5), 61)], "Y": [_r((2, 3), 62)]}, {"pad_value": 1.5}, F5, True),
    ],
    "space_to_depth": [("b2", {"X": [_r((2, 3, 4, 6), 63)]}, {"blocksize": 2}, F5, True)],
    "conv_shift": [("n3", {"X": [_r((3, 7), 64)], "Y": [_r((3, 3), 65)]}, {}, F5, True)],
    "add_position_encoding": [
        ("ab", {"X": [_r((2, 5, 8), 66)]}, {"alpha": 0.5, "beta": 2.0}, F5, True),
    ],
    "mean_iou": [
        ("c4", {"Predictions": [np.random.RandomState(67).randint(0, 4, (3, 5)).astype("int32")],
                "Labels": [np.random.RandomState(68).randint(0, 4, (3, 5)).astype("int32")]},
         {"num_classes": 4}, F5, False),
        ("accumulated", {
            "Predictions": [np.random.RandomState(69).randint(0, 5, (20,)).astype("int32")],
            "Labels": [np.random.RandomState(70).randint(0, 5, (20,)).astype("int32")],
            "InWrongs": [np.arange(5, dtype="int32")],
            "InCorrects": [np.arange(5, dtype="int32")[::-1].copy()],
            "InMeanIou": [np.asarray([0.25], "float32")]}, {"num_classes": 5}, F5, False),
    ],
    "similarity_focus": [
        ("axis1", {"X": [_r((2, 3, 4, 5), 71)]}, {"axis": 1, "indexes": [0, 2]}, F5, False),
        ("axis3_ties", {"X": [np.random.RandomState(72).randint(0, 3, (2, 4, 3, 2))
                              .astype("float32")]}, {"axis": 3, "indexes": [1]}, F5, False),
    ],
    # compose_ops
    "fc": [
        ("bias", {"Input": [_r((4, 6), 73)], "W": [_r((6, 5), 74)], "Bias": [_r((5,), 75)]},
         {"in_num_col_dims": 1}, F5, True),
        ("two_inputs_relu", {"Input": [_r((2, 3, 4), 76), _r((2, 3, 2), 77)],
                             "W": [_r((4, 5), 78), _r((2, 5), 79)]},
         {"in_num_col_dims": 2, "activation_type": "relu"}, F5, True),
    ],
    "fused_elemwise_activation": [
        ("add_relu", {"X": [_r((3, 4), 80)], "Y": [_r((3, 4), 81)]},
         {"functor_list": ["elementwise_add", "relu"], "axis": -1}, F5, True),
        ("scale_mul", {"X": [_r((3, 4), 82)], "Y": [_r((4,), 83)]},
         {"functor_list": ["scale", "elementwise_mul"], "scale": 0.5, "axis": 1}, F5, True),
    ],
    "fusion_transpose_flatten_concat": [
        ("two", {"X": [_r((2, 3, 4), 84), _r((2, 3, 5), 85)]},
         {"trans_axis": [0, 2, 1], "flatten_axis": 1, "concat_axis": 1}, F5, True),
    ],
    "lstm": [
        ("peepholes", {"Input": [_r((3, 5, 16), 86)], "Weight": [_r((4, 16), 87, 0.5)],
                       "Bias": [_r((1, 28), 88)], "SeqLen": [_lens(5, 3, 1)]},
         {"use_peepholes": True}, F4, True),
    ],
    "gru": [
        ("reverse", {"Input": [_r((3, 5, 12), 89)], "Weight": [_r((4, 12), 90, 0.5)],
                     "Bias": [_r((1, 12), 91)], "SeqLen": [_lens(5, 2, 4)]},
         {"is_reverse": True}, F4, True),
    ],
    "lstmp": [
        ("tanh_proj", {"Input": [_r((3, 5, 16), 92)], "Weight": [_r((3, 16), 93, 0.5)],
                       "ProjWeight": [_r((4, 3), 94, 0.5)], "Bias": [_r((1, 16), 95)],
                       "SeqLen": [_lens(5, 4, 2)]}, {"proj_activation": "tanh"}, F4, True),
    ],
    "cudnn_lstm": [
        ("one_layer", {"Input": [_r((5, 3, 4), 96)], "W": [_lstm_blob(4, 6, 1, False, 97)]},
         {"hidden_size": 6, "num_layers": 1}, F4, True),
        ("bidirec_2_layers_init", {
            "Input": [_r((4, 2, 3), 98)], "W": [_lstm_blob(3, 5, 2, True, 99)],
            "InitH": [_r((4, 2, 5), 100, 0.5)], "InitC": [_r((4, 2, 5), 101, 0.5)]},
         {"hidden_size": 5, "num_layers": 2, "is_bidirec": True}, F4, True),
    ],
    "fusion_lstm": [
        ("plain", {"X": [_r((3, 4, 5), 102)], "WeightX": [_r((5, 16), 103, 0.5)],
                   "WeightH": [_r((4, 16), 104, 0.5)], "Bias": [_r((1, 16), 105)],
                   "SeqLen": [_lens(4, 2, 3)]}, {"use_peepholes": False}, F4, True),
    ],
    "fusion_gru": [
        ("plain", {"X": [_r((3, 4, 5), 106)], "WeightX": [_r((5, 12), 107, 0.5)],
                   "WeightH": [_r((4, 12), 108, 0.5)], "SeqLen": [_lens(4, 4, 1)]},
         {}, F4, True),
    ],
    "fused_embedding_fc_lstm": [
        ("ids", {"Ids": [np.random.RandomState(109).randint(0, 10, (3, 4, 1)).astype("int32")],
                 "Embeddings": [_r((10, 16), 110)], "WeightH": [_r((4, 16), 111, 0.5)],
                 "Bias": [_r((1, 16), 112)], "SeqLen": [_lens(4, 3, 2)]},
         {"use_peepholes": False}, F4, True),
    ],
    "fusion_seqconv_eltadd_relu": [
        ("ctx3", {"X": [_r((2, 5, 4), 113)], "Filter": [_r((12, 6), 114)],
                  "Bias": [_r((6,), 115)], "SeqLen": [_lens(5, 3)]},
         {"contextLength": 3, "contextStart": -1}, F5, True),
    ],
    "fusion_seqexpand_concat_fc": [
        ("relu", {"X": [_r((2, 4, 3), 116), _r((2, 5), 117)], "FCWeight": [_r((8, 6), 118)],
                  "FCBias": [_r((6,), 119)]}, {"fc_activation": "relu"}, F5, True),
    ],
    "attention_lstm": [
        ("scalar_bias", {"X": [_r((3, 4, 5), 120)], "SeqLen": [_lens(4, 2, 3)],
                         "AttentionWeight": [_r((9, 1), 121, 0.5)],
                         "LSTMWeight": [_r((9, 16), 122, 0.5)], "LSTMBias": [_r((1, 16), 123)],
                         "AttentionBias": [_r((1, 1), 124)],
                         "AttentionScalar": [np.asarray([[0.7]], "float32")],
                         "AttentionScalarBias": [np.asarray([[0.1]], "float32")],
                         "H0": [_r((3, 4), 125)], "C0": [_r((3, 4), 126)]}, {}, F4, True),
    ],
    "conv2d_fusion": [
        ("bias_residual_relu", {"Input": [_r((2, 3, 6, 6), 127)], "Filter": [_r((4, 3, 3, 3), 128)],
                                "Bias": [_r((4,), 129)], "ResidualData": [_r((2, 4, 6, 6), 130)]},
         {"strides": [1, 1], "paddings": [1, 1], "activation": "relu"}, F4, True),
    ],
}

_IDS = [(op, c[0]) for op, cases in sorted(CASES.items()) for c in cases]


@pytest.mark.parametrize("op_type,case", _IDS, ids=["%s-%s" % i for i in _IDS])
def test_op_matches_jax(op_type, case):
    _, ins, attrs, tol, grad = next(c for c in CASES[op_type] if c[0] == case)
    check_op(op_type, ins, attrs, tol, grad=grad)


# --------------------------------------------------------------------------
# max pooling with an index mask: ties, padding, global pooling, 3-D; the
# explicit grad ops scatter through the mask
# --------------------------------------------------------------------------


def _tied(shape, seed):
    x = np.random.RandomState(seed).randint(0, 2, shape).astype("float32")
    x.reshape(-1)[: x.size // 4] = 0.0  # whole windows tied
    return x


POOL_INDEX_CASES = {
    "2d_k2": ("max_pool2d_with_index", _r((2, 3, 4, 4), 131),
              {"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0]}),
    "2d_ties_k3_s2_p1": ("max_pool2d_with_index", _tied((2, 3, 7, 7), 132),
                         {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]}),
    "2d_ties_overlap": ("max_pool2d_with_index", _tied((1, 2, 6, 6), 133),
                        {"ksize": [3, 3], "strides": [1, 1], "paddings": [0, 0]}),
    "2d_global": ("max_pool2d_with_index", _tied((2, 3, 5, 4), 134),
                  {"ksize": [1, 1], "global_pooling": True}),
    "3d_k2_p1": ("max_pool3d_with_index", _r((1, 2, 5, 4, 5), 135),
                 {"ksize": [2, 2, 2], "strides": [2, 2, 2], "paddings": [1, 1, 1]}),
    "3d_ties": ("max_pool3d_with_index", _tied((2, 2, 4, 4, 4), 136),
                {"ksize": [2, 2, 2], "strides": [2, 2, 2]}),
}


@pytest.mark.parametrize("case", sorted(POOL_INDEX_CASES))
def test_max_pool_with_index_and_grad(case):
    """Out within 1e-5, Mask exactly (ties to the first element in window
    order, padding at -inf, flat indices within the input plane), and the
    explicit grad op's scatter through the mask within 1e-5."""
    op_type, x, attrs = POOL_INDEX_CASES[case]
    want = check_op(op_type, {"X": [x]}, attrs, F5, grad=False)
    dy = _r(want["Out"][0].shape, 137)
    gins = {"X": [x], "Mask": [want["Mask"][0]], "Out@GRAD": [dy]}
    gw, gg = lower_both(op_type + "_grad", gins, attrs)
    assert_outs_close(gg, gw, F5, op_type + "_grad")
    # each output's cotangent lands on exactly one input element
    np.testing.assert_allclose(gg["X@GRAD"][0].sum(), dy.sum(), rtol=1e-4)


def test_unpool_reads_the_max_pool_mask():
    """max_pool2d_with_index then unpool puts each maximum back where it was
    (the reference's pool / unpool pair), in both packages."""
    x = _r((2, 3, 6, 6), 138)
    attrs = {"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0]}
    pooled = lower_one("paddle_tpu_torch", "max_pool2d_with_index", {"X": [x]}, attrs)
    ins = {"X": pooled["Out"], "Indices": pooled["Mask"]}
    want = check_op("unpool", ins, attrs, F5, grad=False)
    out = want["Out"][0]
    np.testing.assert_array_equal(out[out != 0], x[out != 0])
    assert np.count_nonzero(out) == pooled["Out"][0].size


def test_random_crop_is_one_window_of_the_batch():
    """Each row of the output is the input's window at one offset per cropped
    dim, the same for the whole batch, within range; SeedOut is Seed."""
    x = _r((4, 3, 9, 8), 139)
    seed = np.asarray([5], "int32")
    for s in range(6):
        ctx = registry.LowerCtx("cpu", generator=torch.Generator().manual_seed(s),
                                device_generator=torch.Generator().manual_seed(s),
                                host_random=False)
        outs = registry.get("random_crop").lower(
            ctx, {"X": [torch.from_numpy(x)], "Seed": [torch.from_numpy(seed)]},
            {"shape": [5, 4]})
        out = outs["Out"][0].numpy()
        assert out.shape == (4, 3, 5, 4)
        np.testing.assert_array_equal(outs["SeedOut"][0].numpy(), seed)
        hits = [(i, j) for i in range(9 - 5 + 1) for j in range(8 - 4 + 1)
                if np.array_equal(out, x[:, :, i:i + 5, j:j + 4])]
        assert len(hits) == 1, (s, hits)


# --------------------------------------------------------------------------
# int8_conv2d: bit for bit against the JAX lowering (i32 sums cast to f32),
# and the card's im2col + quant GEMM form (here the GEMM's plain version)
# bit for bit against the plain form
# --------------------------------------------------------------------------


def _levels(shape, seed):
    return np.random.RandomState(seed).randint(-127, 128, shape).astype("int8")


INT8_CONV_CASES = {
    # k = 3 * 7 * 7 = 147, not a multiple of 16 (ResNet-50's stem)
    "stem_k147_s2": ((2, 3, 20, 20), (16, 3, 7, 7),
                     {"strides": [2, 2], "paddings": [3, 3]}),
    "k3x3_dilation2": ((2, 5, 9, 9), (8, 5, 3, 3),
                       {"strides": [1, 1], "paddings": [2, 2], "dilations": [2, 2]}),
    "k1x1_s2_n20": ((1, 24, 6, 6), (20, 24, 1, 1), {"strides": [2, 2]}),
    "groups4": ((2, 8, 7, 7), (12, 2, 3, 3), {"paddings": [1, 1], "groups": 4}),
    "depthwise": ((2, 6, 7, 7), (6, 1, 3, 3), {"strides": [2, 2], "paddings": [1, 1],
                                                "groups": 6}),
    "large_sums": ((1, 64, 5, 5), (16, 64, 3, 3), {"paddings": [1, 1]}),
}


@pytest.mark.parametrize("case", sorted(INT8_CONV_CASES))
def test_int8_conv2d_bit_for_bit(case):
    xs, ws, attrs = INT8_CONV_CASES[case]
    x, w = _levels(xs, 140), _levels(ws, 141)
    if case == "large_sums":  # sums past 2^24, where f32 sums would round
        x[:], w[:] = 127, 127
        w[::2] = -127
    want, got = lower_both("int8_conv2d", {"Input": [x], "Filter": [w]}, attrs)
    assert got["Output"][0].dtype == np.float32
    np.testing.assert_array_equal(got["Output"][0], want["Output"][0])
    if int(attrs.get("groups", 1)) == 1:
        strides = attrs.get("strides", [1, 1])
        gemm = quant_ops._int8_conv2d_gemm(
            torch.from_numpy(x), torch.from_numpy(w), strides, attrs.get("paddings", [0, 0]),
            attrs.get("dilations", [1, 1]))
        np.testing.assert_array_equal(gemm.numpy(), want["Output"][0])


def test_int8_conv2d_counts_its_rule():
    """Each call is counted under the rule it takes: "int8_conv2d" (the
    quant GEMM on the card) for groups == 1, "int8_conv2d_grouped" (the
    float64 convolution) otherwise."""
    from paddle_tpu_torch.ops import fused

    fused.reset_stats()
    for case in ("stem_k147_s2", "groups4", "depthwise"):
        xs, ws, attrs = INT8_CONV_CASES[case]
        lower_one("paddle_tpu_torch", "int8_conv2d",
                  {"Input": [_levels(xs, 1)], "Filter": [_levels(ws, 2)]}, attrs)
    assert fused.stats()["dispatches"] == {"int8_conv2d": 1, "int8_conv2d_grouped": 2}
    assert fused.stats()["launches"]["quant_gemm_int8"] == 0  # CPU: the plain version


# --------------------------------------------------------------------------
# registration and shape inference
# --------------------------------------------------------------------------


def test_every_op_type_of_the_slice_is_registered_as_in_jax():
    """The 32 op types of nn_extra_ops.py, the 14 of compose_ops.py and
    int8_conv2d, each with the JAX package's no_grad / stochastic flags;
    the port then lacks no op type of the JAX package's (the parameter
    server's 8 and prefetch / gen_nccl_id came last)."""
    import paddle_tpu.ops  # noqa: F401
    from paddle_tpu.ops import registry as jreg

    extra = set(CASES) | {"max_pool2d_with_index", "max_pool3d_with_index",
                          "max_pool2d_with_index_grad", "max_pool3d_with_index_grad",
                          "random_crop", "int8_conv2d"}
    assert len(extra) == 47
    for t in extra:
        j, p = jreg.get(t), registry.get(t)
        assert (p.no_grad, p.stochastic) == (j.no_grad, j.stochastic), t
        assert (p.grad is None) == (j.grad is None), t
    # a generic `<type>_grad` another test made in either registry is derived
    # in the port too, and does not count as lacking
    lacking = {t for t in set(jreg.OPS) - set(registry.OPS) if not registry.is_registered(t)}
    assert not lacking, sorted(lacking)
    for t in ("checkpoint_notify", "fake_init", "fetch_barrier", "gen_nccl_id",
              "listen_and_serv", "prefetch", "recv", "ref_by_trainer_id", "send",
              "send_barrier"):
        j, p = jreg.get(t), registry.get(t)
        assert (p.no_grad, p.is_host) == (j.no_grad, j.is_host), t


SHAPE_CASES = {
    "is_empty": ("is_empty", {"X": _r((3, 4), 150)}, {"Out": "bool"}, {}),
    "mean_iou": ("mean_iou", {"Predictions": np.asarray([0, 1, 2, 1], "int32"),
                              "Labels": np.asarray([0, 2, 2, 1], "int32")},
                 {"OutMeanIou": "float32", "OutWrong": "int32", "OutCorrect": "int32"},
                 {"num_classes": 3}),
    "crop_offsets": ("crop", {"X": _r((4, 6), 151), "Offsets": np.asarray([1, 2], "int32")},
                     {"Out": "float32"}, {"shape": [2, 3]}),
    "spp": ("spp", {"X": _r((2, 3, 13, 13), 152)}, {"Out": "float32"},
            {"pyramid_height": 4, "pooling_type": "max"}),
    "group_norm": ("group_norm", {"X": _r((2, 4, 3, 3), 153)},
                   {"Y": "float32", "Mean": "float32", "Variance": "float32"}, {"groups": 2}),
    "cudnn_lstm": ("cudnn_lstm", {"Input": _r((4, 2, 3), 154), "W": _lstm_blob(3, 5, 2, True, 155)},
                   {"Out": "float32", "last_h": "float32", "last_c": "float32"},
                   {"hidden_size": 5, "num_layers": 2, "is_bidirec": True}),
    "max_pool2d_with_index": ("max_pool2d_with_index", {"X": _r((2, 3, 7, 7), 156)},
                              {"Out": "float32", "Mask": "int32"},
                              {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]}),
}


@pytest.mark.parametrize("case", sorted(SHAPE_CASES))
def test_shape_inference_matches_a_run(case):
    """A one-op program's output vars take, when built, the shapes and
    dtypes that a run on the CPU fetches."""
    op_type, feeds, outs, attrs = SHAPE_CASES[case]
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        blk = main.global_block()
        ins = {s: [pt.layers.data(name=s.lower(), shape=list(a.shape), dtype=str(a.dtype),
                                  append_batch_size=False).name] for s, a in feeds.items()}
        for slot, dt in outs.items():
            blk.create_var(name="out_" + slot, dtype=dt)
        blk.append_op(type=op_type, inputs=ins,
                      outputs={s: ["out_" + s] for s in outs}, attrs=dict(attrs))
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope(place=pt.CPUPlace())):
        got = exe.run(main, feed={s.lower(): a for s, a in feeds.items()},
                      fetch_list=["out_" + s for s in outs])
    for slot, val in zip(outs, got):
        v = blk.var("out_" + slot)
        assert tuple(v.shape) == val.shape, (slot, v.shape, val.shape)
        assert np.dtype(v.dtype if v.dtype != "bool" else np.bool_) == val.dtype, (slot, v.dtype)
