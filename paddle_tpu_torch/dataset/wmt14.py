"""WMT14 fr→en reader creators (reference python/paddle/dataset/wmt14.py:
train/test yield (src_ids, trg_ids, trg_ids_next); get_dict returns
(src_dict, trg_dict); <s>=0, <e>=1, <unk>=2). Synthetic fallback: source
sentences whose target is a deterministic token mapping, so seq2seq models
can genuinely learn the translation."""

import numpy as np

from . import common

__all__ = ["train", "test", "get_dict"]

START, END, UNK_IDX = 0, 1, 2
TRAIN_PAIRS = 1000
TEST_PAIRS = 100


def _dicts(dict_size):
    src = {"<s>": 0, "<e>": 1, "<unk>": 2}
    trg = {"<s>": 0, "<e>": 1, "<unk>": 2}
    for i in range(dict_size - 3):
        src["f%04d" % i] = i + 3
        trg["e%04d" % i] = i + 3
    return src, trg


def get_dict(dict_size, reverse=False):
    src, trg = _dicts(dict_size)
    if reverse:
        src = {v: k for k, v in src.items()}
        trg = {v: k for k, v in trg.items()}
    return src, trg


def _reader_creator(tag, n, dict_size):
    def reader():
        rng = common.synthetic_rng("wmt14-" + tag)
        for _ in range(n):
            length = rng.randint(3, 12)
            src = [int(t) for t in rng.randint(3, dict_size, length)]
            # deterministic "translation": same content, reversed order —
            # the classic toy task attention must learn
            trg = [(t * 3 + 1) % (dict_size - 3) + 3 for t in reversed(src)]
            trg_in = [START] + trg
            trg_next = trg + [END]
            yield src, trg_in, trg_next

    return reader


def train(dict_size):
    return _reader_creator("train", TRAIN_PAIRS, dict_size)


def test(dict_size):
    return _reader_creator("test", TEST_PAIRS, dict_size)
