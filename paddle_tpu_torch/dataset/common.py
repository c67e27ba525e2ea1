"""Shared dataset plumbing (reference python/paddle/dataset/common.py —
download cache dir, md5 checks; here: local cache dir + synthetic fallback)."""

import hashlib
import os

import numpy as np

DATA_HOME = os.environ.get(
    "PADDLE_TPU_DATA_HOME",
    os.path.join(os.path.expanduser("~"), ".cache", "paddle_tpu", "dataset"),
)


def local_path(*parts):
    return os.path.join(DATA_HOME, *parts)


def have_local(*parts):
    return os.path.exists(local_path(*parts))


def synthetic_rng(tag):
    """Deterministic per-dataset RNG so synthetic streams are reproducible
    across processes (stable hash — Python's str hash is per-process salted)."""
    seed = int.from_bytes(hashlib.sha256(tag.encode()).digest()[:4], "big")
    return np.random.RandomState(seed % (2**31))
