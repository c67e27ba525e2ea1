"""The convolution, pooling and batch_norm cases of the torch port's CNN op
tests, shared by the parity tests against the JAX package
(tests/test_torch_cnn_ops.py) and the card's tests of the same lowerings
(tests/test_torch_cnn_cuda.py, which import no JAX)."""

CONV_CASES = {
    # name: (op type, x shape, filter shape, strides, paddings, dilations, groups)
    "3x3": ("conv2d", (2, 3, 9, 9), (4, 3, 3, 3), [1, 1], [0, 0], [1, 1], 1),
    "3x3_s2_p1": ("conv2d", (2, 3, 9, 9), (4, 3, 3, 3), [2, 2], [1, 1], [1, 1], 1),
    "s21_p12": ("conv2d", (2, 3, 9, 10), (4, 3, 3, 3), [2, 1], [1, 2], [1, 1], 1),
    "dilation2": ("conv2d", (2, 3, 10, 10), (4, 3, 3, 3), [1, 1], [2, 2], [2, 2], 1),
    "groups2": ("conv2d", (2, 4, 8, 8), (6, 2, 3, 3), [1, 1], [1, 1], [1, 1], 2),
    "stem_7x7_s2_p3": ("conv2d", (1, 3, 16, 16), (8, 3, 7, 7), [2, 2], [3, 3], [1, 1], 1),
    "1x1_s2": ("conv2d", (2, 8, 8, 8), (16, 8, 1, 1), [2, 2], [0, 0], [1, 1], 1),
    "lenet_5x5_p2": ("conv2d", (2, 1, 12, 12), (6, 1, 5, 5), [1, 1], [2, 2], [1, 1], 1),
    "depthwise": ("depthwise_conv2d", (2, 4, 8, 8), (4, 1, 3, 3), [1, 1], [1, 1], [1, 1], 4),
    "depthwise_s2": ("depthwise_conv2d", (2, 4, 9, 9), (8, 1, 3, 3), [2, 2], [1, 1], [1, 1], 4),
}


def conv_attrs(case):
    """The conv2d attrs of a CONV_CASES entry."""
    _, _, _, s, p, d, g = case
    return {"strides": s, "paddings": p, "dilations": d, "groups": g}


POOL_CASES = {
    "max_2x2_s2": ("max", [2, 2], [2, 2], [0, 0], {}),
    "max_3x3_s2_p1": ("max", [3, 3], [2, 2], [1, 1], {}),
    "avg_2x2_s2": ("avg", [2, 2], [2, 2], [0, 0], {}),
    "avg_3x3_s1_p1_exclusive": ("avg", [3, 3], [1, 1], [1, 1], {"exclusive": True}),
    "avg_3x3_s1_p1_inclusive": ("avg", [3, 3], [1, 1], [1, 1], {"exclusive": False}),
    "avg_3x3_s1_p2_exclusive": ("avg", [3, 3], [1, 1], [2, 2], {"exclusive": True}),
    "avg_global": ("avg", [1, 1], [1, 1], [0, 0], {"global_pooling": True}),
    "max_global": ("max", [2, 2], [1, 1], [0, 0], {"global_pooling": True}),
    "avg_adaptive_1x1": ("avg", [1, 1], [1, 1], [0, 0], {"adaptive": True}),
}


def pool_attrs(case):
    ptype, k, s, p, extra = POOL_CASES[case]
    return dict({"pooling_type": ptype, "ksize": k, "strides": s, "paddings": p}, **extra)


BN_CASES = {
    "train_nchw": ({"is_test": False}, (4, 3, 5, 5), "NCHW"),
    "test_nchw": ({"is_test": True}, (4, 3, 5, 5), "NCHW"),
    "global_stats": ({"use_global_stats": True}, (4, 3, 5, 5), "NCHW"),
    "train_nhwc": ({"is_test": False}, (4, 5, 5, 3), "NHWC"),
    "train_2d": ({"is_test": False}, (8, 6), "NCHW"),
}
