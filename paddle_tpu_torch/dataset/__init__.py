"""Dataset package (reference python/paddle/dataset/): mnist and cifar, as
in the JAX package.

The reference downloads from public mirrors at import time. Here each
dataset module serves from a local cache dir (`PADDLE_TPU_DATA_HOME`,
default ~/.cache/paddle_tpu/dataset) when real files exist there, and
otherwise a deterministic synthetic sample stream with the same shapes and
labels, the same stream as the JAX package's for the same dataset. The
other datasets of the JAX package come with the models that read them.
"""

from . import cifar, common, mnist  # noqa: F401

__all__ = ["mnist", "cifar", "common"]
