"""MNIST reader creators (reference python/paddle/dataset/mnist.py:
train()/test() yielding (784-float image in [-1,1], int label)).

Serves real idx files from the local cache when present; otherwise a
deterministic synthetic stream with a learnable class-dependent pattern (so
convergence tests remain meaningful)."""

import gzip
import os
import struct

import numpy as np

from . import common

__all__ = ["train", "test"]

TRAIN_SIZE = 8192
TEST_SIZE = 1024


def _read_idx(images_path, labels_path, limit=None):
    with gzip.open(labels_path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        labels = np.frombuffer(f.read(), dtype=np.uint8)
    with gzip.open(images_path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        images = np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows * cols)
    if limit:
        images, labels = images[:limit], labels[:limit]
    for img, lbl in zip(images, labels):
        yield img.astype("float32") / 127.5 - 1.0, int(lbl)


def _synthetic(tag, n):
    rng = common.synthetic_rng("mnist-" + tag)
    imgs = (rng.rand(n, 784).astype("float32") - 0.5) * 0.2
    labels = rng.randint(0, 10, n)
    # class-dependent block pattern: rows [0:8]*class intensity
    for i in range(n):
        l = labels[i]
        img2d = imgs[i].reshape(28, 28)
        img2d[:14, :14] += l / 10.0
        img2d[14:, 14:] -= l / 10.0
    def reader():
        for i in range(n):
            yield imgs[i], int(labels[i])
    return reader


def train():
    imgs = common.local_path("mnist", "train-images-idx3-ubyte.gz")
    lbls = common.local_path("mnist", "train-labels-idx1-ubyte.gz")
    if os.path.exists(imgs) and os.path.exists(lbls):
        return lambda: _read_idx(imgs, lbls)
    return _synthetic("train", TRAIN_SIZE)


def test():
    imgs = common.local_path("mnist", "t10k-images-idx3-ubyte.gz")
    lbls = common.local_path("mnist", "t10k-labels-idx1-ubyte.gz")
    if os.path.exists(imgs) and os.path.exists(lbls):
        return lambda: _read_idx(imgs, lbls)
    return _synthetic("test", TEST_SIZE)
