"""VOC2012 segmentation reader creators (reference python/paddle/dataset/
voc2012.py: train/test/val yield (3xHxW image bytes, HxW label mask))."""

import numpy as np

from . import common

__all__ = ["train", "test", "val"]

N_CLASSES = 21
H = W = 64  # synthetic tier keeps masks small


def _samples(tag, n):
    rng = common.synthetic_rng("voc2012-" + tag)
    for _ in range(n):
        img = (rng.rand(3, H, W).astype("float32") - 0.5) * 0.2
        mask = np.zeros((H, W), "int64")
        # one rectangular object of a random class; its channel is brightened
        cls = int(rng.randint(1, N_CLASSES))
        y0, x0 = rng.randint(0, H // 2), rng.randint(0, W // 2)
        y1, x1 = y0 + rng.randint(8, H // 2), x0 + rng.randint(8, W // 2)
        mask[y0:y1, x0:x1] = cls
        img[cls % 3, y0:y1, x0:x1] += 0.5
        yield img, mask


def train():
    return lambda: _samples("train", 256)


def test():
    return lambda: _samples("test", 32)


def val():
    return lambda: _samples("val", 32)
