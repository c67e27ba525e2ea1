"""CIFAR-10/100 reader creators (reference python/paddle/dataset/cifar.py:
train10()/test10()/train100()/test100() yielding (3072-float image, label))."""

import numpy as np

from . import common

__all__ = ["train10", "test10", "train100", "test100"]


def _synthetic(tag, n, classes):
    rng = common.synthetic_rng("cifar-" + tag)
    imgs = rng.rand(n, 3, 32, 32).astype("float32") * 0.2
    labels = rng.randint(0, classes, n)
    for i in range(n):
        c = labels[i] % 3
        imgs[i, c, : 16, : 16] += (labels[i] + 1) / float(classes)

    def reader():
        for i in range(n):
            yield imgs[i].reshape(-1), int(labels[i])

    return reader


def train10():
    return _synthetic("train10", 4096, 10)


def test10():
    return _synthetic("test10", 512, 10)


def train100():
    return _synthetic("train100", 4096, 100)


def test100():
    return _synthetic("test100", 512, 100)
