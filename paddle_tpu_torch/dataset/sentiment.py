"""Movie-review sentiment reader creators (reference python/paddle/dataset/
sentiment.py over NLTK movie_reviews: train/test yield (word_ids, 0|1);
get_word_dict())."""

from . import common

__all__ = ["train", "test", "get_word_dict"]

VOCAB = 5147  # reference's movie_reviews vocab magnitude
POS_MARKERS = tuple(range(10, 60))  # synthetic "positive" token ids


def get_word_dict():
    return {"w%04d" % i: i for i in range(VOCAB)}


def _samples(tag, n):
    rng = common.synthetic_rng("sentiment-" + tag)
    for _ in range(n):
        label = int(rng.rand() < 0.5)
        length = rng.randint(8, 40)
        ids = [int(w) for w in rng.randint(60, VOCAB, length)]
        # learnable: positive docs contain marker tokens
        if label == 0:  # reference: 0 = positive class order per file list
            k = rng.randint(2, 6)
            for pos in rng.randint(0, length, k):
                ids[pos] = int(rng.choice(POS_MARKERS))
        yield ids, label


def train():
    return lambda: _samples("train", 800)


def test():
    return lambda: _samples("test", 200)
