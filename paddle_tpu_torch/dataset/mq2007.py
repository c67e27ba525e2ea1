"""MQ2007 learning-to-rank reader creators (reference python/paddle/dataset/
mq2007.py: modes pointwise (feature46, relevance), pairwise (better, worse),
listwise (per-query feature list, label list))."""

import numpy as np

from . import common

__all__ = ["train", "test"]

N_FEATURES = 46
N_QUERIES = 120
DOCS_PER_QUERY = 8


def _queries(tag, n):
    rng = common.synthetic_rng("mq2007-" + tag)
    w = common.synthetic_rng("mq2007-w").rand(N_FEATURES) - 0.5  # hidden scorer
    for _ in range(n):
        feats = rng.rand(DOCS_PER_QUERY, N_FEATURES).astype("float32")
        scores = feats @ w
        rel = np.digitize(scores, np.quantile(scores, [0.5, 0.85]))
        yield feats, rel.astype("int64")


def _creator(tag, n, format):
    def reader():
        for feats, rel in _queries(tag, n):
            if format == "pointwise":
                for f, r in zip(feats, rel):
                    yield f, int(r)
            elif format == "pairwise":
                for i in range(len(rel)):
                    for j in range(len(rel)):
                        if rel[i] > rel[j]:
                            yield feats[i], feats[j]
            else:  # listwise
                yield feats, rel

    return reader


def train(format="pairwise"):
    return _creator("train", N_QUERIES, format)


def test(format="pairwise"):
    return _creator("test", N_QUERIES // 6, format)
