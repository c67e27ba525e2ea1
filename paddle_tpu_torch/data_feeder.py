"""DataFeeder: convert reader samples (tuples of numpy/lists) into feed dicts
(reference python/paddle/fluid/data_feeder.py). LoD (ragged) fields are padded
dense with a companion `<name>@LEN` length vector — the padded-dense stand-in
for LoDTensor (SURVEY.md §5.7: LoD → ragged/segment-id representations)."""

import numpy as np

from . import framework
from .framework import Variable

__all__ = ["DataFeeder"]


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None):
        self.feed_vars = []
        program = program or framework.default_main_program()
        for v in feed_list:
            if isinstance(v, str):
                v = program.global_block().var(v)
            self.feed_vars.append(v)
        self.place = place

    def feed(self, iterable):
        """iterable of sample tuples → {name: batch array} (+ @LEN for ragged
        fields)."""
        columns = [[] for _ in self.feed_vars]
        for sample in iterable:
            assert len(sample) == len(self.feed_vars), (
                "sample arity %d != feed arity %d" % (len(sample), len(self.feed_vars))
            )
            for c, val in zip(columns, sample):
                c.append(np.asarray(val))
        out = {}
        for var, col in zip(self.feed_vars, columns):
            if var.lod_level and var.lod_level > 0:
                lens = np.asarray([len(x) for x in col], dtype=np.int32)
                maxlen = max(int(lens.max()), 1)
                sample_shape = col[0].shape[1:] if col[0].ndim > 1 else ()
                batch = np.zeros(
                    (len(col), maxlen) + tuple(sample_shape),
                    dtype=np.dtype(var.dtype) if var.dtype != "bfloat16" else np.float32,
                )
                for i, x in enumerate(col):
                    batch[i, : len(x)] = x
                # fluid convention: ragged int fields are (..., 1) shaped
                if var.shape and batch.ndim < len(var.shape) + 1:
                    batch = batch[..., None]
                out[var.name] = batch
                out[var.name + "@LEN"] = lens
            else:
                batch = np.stack(col)
                want_rank = len(var.shape) if var.shape else batch.ndim
                # fluid convention: scalar-ish fields get a trailing unit dim
                if batch.ndim == want_rank - 1:
                    batch = batch[..., None]
                out[var.name] = batch
        return out

    def feed_parallel(self, iterable, num_places=None):
        """reference data_feeder.py feed_parallel — returns one merged feed
        (our ParallelExecutor takes the global batch and shards it)."""
        return self.feed(iterable)
