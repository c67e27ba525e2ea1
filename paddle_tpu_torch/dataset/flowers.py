"""Oxford-102 flowers reader creators (reference python/paddle/dataset/
flowers.py: train/test/valid yield (3x224x224 float image, int label))."""

from . import common

__all__ = ["train", "test", "valid"]

N_CLASSES = 102


def _samples(tag, n, use_xmap=True):
    rng = common.synthetic_rng("flowers-" + tag)
    for _ in range(n):
        label = int(rng.randint(0, N_CLASSES))
        img = (rng.rand(3, 224, 224).astype("float32") - 0.5) * 0.1
        # class-dependent color cast: learnable by any conv net
        img[label % 3] += (label / N_CLASSES) * 0.5
        yield img.reshape(-1), label


def train(use_xmap=True):
    return lambda: _samples("train", 512, use_xmap)


def test(use_xmap=True):
    return lambda: _samples("test", 64, use_xmap)


def valid(use_xmap=True):
    return lambda: _samples("valid", 64, use_xmap)
