"""PTB language-model reader creators (reference
python/paddle/dataset/imikolov.py: build_dict + train/test yielding n-gram
id tuples or SEQ pairs). Synthetic fallback: a Markov-ish token stream with a
Zipfian vocabulary so next-word prediction is learnable."""

import numpy as np

from . import common

__all__ = ["train", "test", "build_dict", "DataType"]

VOCAB = 2072  # small PTB-like vocab for the synthetic stream
TRAIN_SENTENCES = 2000
TEST_SENTENCES = 200


class DataType:
    NGRAM = 1
    SEQ = 2


def build_dict(min_word_freq=50):
    """word -> id map; id 0..VOCAB-1, plus <unk>/<e>/<s> like the reference
    (ids chosen to match usage: <s>=start, <e>=end, <unk>=last)."""
    d = {"<s>": 0, "<e>": 1, "<unk>": 2}
    for i in range(VOCAB - 3):
        d["w%04d" % i] = i + 3
    return d


def _sentences(tag, n):
    rng = common.synthetic_rng("imikolov-" + tag)
    # Zipf-distributed tokens with a deterministic bigram bias: the next
    # token tends toward (prev*7+3) % VOCAB, so an LM can beat uniform
    for _ in range(n):
        length = rng.randint(5, 20)
        sent = [int(rng.zipf(1.3)) % (VOCAB - 3) + 3]
        for _ in range(length - 1):
            if rng.rand() < 0.6:
                sent.append((sent[-1] * 7 + 3) % (VOCAB - 3) + 3)
            else:
                sent.append(int(rng.zipf(1.3)) % (VOCAB - 3) + 3)
        yield sent


def _reader_creator(tag, n_sent, word_idx, n, data_type):
    def reader():
        for sent in _sentences(tag, n_sent):
            if data_type == DataType.NGRAM:
                ids = [0] * (n - 1) + sent + [1]
                for i in range(n, len(ids) + 1):
                    yield tuple(ids[i - n : i])
            else:
                ids = [0] + sent + [1]
                yield ids[:-1], ids[1:]

    return reader


def train(word_idx, n, data_type=DataType.NGRAM):
    return _reader_creator("train", TRAIN_SENTENCES, word_idx, n, data_type)


def test(word_idx, n, data_type=DataType.NGRAM):
    return _reader_creator("test", TEST_SENTENCES, word_idx, n, data_type)
