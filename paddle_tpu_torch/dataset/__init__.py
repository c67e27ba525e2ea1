"""Dataset package (reference python/paddle/dataset/): the thirteen
datasets of the JAX package.

The reference downloads from public mirrors at import time. Here each
dataset module serves from a local cache dir (`PADDLE_TPU_DATA_HOME`,
default ~/.cache/paddle_tpu/dataset) when real files exist there, and
otherwise a deterministic synthetic sample stream with the same shapes and
labels, the same stream as the JAX package's for the same dataset (the
other eleven serve the synthetic stream alone).
"""

from . import (  # noqa: F401
    cifar,
    common,
    conll05,
    flowers,
    imdb,
    imikolov,
    mnist,
    movielens,
    mq2007,
    sentiment,
    uci_housing,
    voc2012,
    wmt14,
    wmt16,
)

__all__ = [
    "mnist",
    "cifar",
    "uci_housing",
    "imdb",
    "imikolov",
    "movielens",
    "sentiment",
    "conll05",
    "flowers",
    "voc2012",
    "wmt14",
    "wmt16",
    "mq2007",
    "common",
]
