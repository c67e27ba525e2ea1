"""UCI housing regression (reference python/paddle/dataset/uci_housing.py:
train()/test() yielding (13-dim features, price))."""

import numpy as np

from . import common

__all__ = ["train", "test"]

_W = None


def _data(tag, n):
    global _W
    rng = common.synthetic_rng("uci-shared")
    if _W is None:
        _W = rng.randn(13).astype("float32")
    rng2 = common.synthetic_rng("uci-" + tag)
    x = rng2.randn(n, 13).astype("float32")
    y = x @ _W + 0.1 * rng2.randn(n).astype("float32")

    def reader():
        for i in range(n):
            yield x[i], np.asarray([y[i]], dtype="float32")

    return reader


def train():
    return _data("train", 404)


def test():
    return _data("test", 102)
