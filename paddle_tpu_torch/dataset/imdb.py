"""IMDB sentiment (reference python/paddle/dataset/imdb.py: word_dict(),
train(word_dict)/test(word_dict) yielding (word-id sequence, 0/1 label)).
Synthetic streams use sentiment-bearing token distributions so text models
can actually learn."""

import numpy as np

from . import common

__all__ = ["word_dict", "train", "test"]

VOCAB = 5000


def word_dict():
    return {("w%d" % i).encode(): i for i in range(VOCAB)}


def _synthetic(tag, n):
    rng = common.synthetic_rng("imdb-" + tag)

    def reader():
        for i in range(n):
            label = int(rng.randint(0, 2))
            length = int(rng.randint(8, 64))
            # positive reviews skew toward low token ids, negative toward high
            base = rng.randint(0, VOCAB // 2, length)
            if label == 0:
                base = VOCAB // 2 + base
            yield base.astype("int64").tolist(), label

    return reader


def train(word_idx=None):
    return _synthetic("train", 2048)


def test(word_idx=None):
    return _synthetic("test", 256)
