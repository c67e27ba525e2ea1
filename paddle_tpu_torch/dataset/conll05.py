"""CoNLL-2005 SRL reader creators (reference python/paddle/dataset/
conll05.py: test() yields (word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2,
verb_ids, mark, label_ids) — 8 input slots + label; get_dict() returns
(word_dict, verb_dict, label_dict))."""

import numpy as np

from . import common

__all__ = ["test", "get_dict", "get_embedding"]

WORD_VOCAB = 4000
VERB_VOCAB = 200
N_LABELS = 59  # CoNLL05 label count (B-/I- args + O)
SENTENCES = 500


def get_dict():
    word_dict = {"w%04d" % i: i for i in range(WORD_VOCAB)}
    verb_dict = {"v%03d" % i: i for i in range(VERB_VOCAB)}
    label_dict = {"l%02d" % i: i for i in range(N_LABELS)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    """Pretrained word embedding matrix analog (reference serves emb.txt)."""
    rng = common.synthetic_rng("conll05-emb")
    return rng.rand(WORD_VOCAB, 32).astype("float32") * 0.1


def _samples(tag, n):
    rng = common.synthetic_rng("conll05-" + tag)
    for _ in range(n):
        length = rng.randint(4, 18)
        words = [int(w) for w in rng.randint(0, WORD_VOCAB, length)]
        verb_pos = int(rng.randint(0, length))
        verb = words[verb_pos] % VERB_VOCAB
        pad = lambda i: words[i] if 0 <= i < length else 0
        ctx_n2 = [pad(verb_pos - 2)] * length
        ctx_n1 = [pad(verb_pos - 1)] * length
        ctx_0 = [pad(verb_pos)] * length
        ctx_p1 = [pad(verb_pos + 1)] * length
        ctx_p2 = [pad(verb_pos + 2)] * length
        mark = [1 if i == verb_pos else 0 for i in range(length)]
        # learnable labels: function of distance to the verb
        labels = [
            min(abs(i - verb_pos), N_LABELS - 1) for i in range(length)
        ]
        yield (
            words,
            ctx_n2,
            ctx_n1,
            ctx_0,
            ctx_p1,
            ctx_p2,
            [verb] * length,
            mark,
            labels,
        )


def test():
    return lambda: _samples("test", SENTENCES)
