"""LoDTensor construction helpers (reference python/paddle/fluid/
lod_tensor.py: create_lod_tensor / create_random_int_lodtensor), as in the
JAX package.

Ragged batches ride as padded dense arrays plus an explicit sequence-length
vector instead of offset tables, so the helpers return (padded_array,
seq_len) pairs, the convention the sequence ops and DataFeeder consume."""

import numpy as np

__all__ = ["create_lod_tensor", "create_random_int_lodtensor", "to_dlpack", "from_dlpack"]


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """Build a padded batch from per-sequence rows.

    `data`: list of per-sequence numpy arrays/lists, or a flat (sum_len, d)
    array partitioned by `recursive_seq_lens` (one level, like the reference's
    common case). Returns (padded [B, T, ...], seq_len [B]) — LoD level 1."""
    if isinstance(recursive_seq_lens[0], (list, tuple)):
        if len(recursive_seq_lens) != 1:
            raise ValueError(
                "padded-dense LoD supports one recursion level "
                "(deeper nesting is a reshape away for every reference use)"
            )
        seq_lens = list(recursive_seq_lens[0])
    else:
        seq_lens = list(recursive_seq_lens)

    if isinstance(data, (list, tuple)):
        rows = [np.asarray(d) for d in data]
    else:
        flat = np.asarray(data)
        rows = []
        ofs = 0
        for n in seq_lens:
            rows.append(flat[ofs : ofs + n])
            ofs += n
    if len(rows) != len(seq_lens):
        raise ValueError("data has %d sequences but lens has %d" % (len(rows), len(seq_lens)))
    t = max(seq_lens) if seq_lens else 0
    tail = rows[0].shape[1:] if rows and rows[0].ndim > 1 else ()
    out = np.zeros((len(rows), t) + tuple(tail), rows[0].dtype if rows else np.float32)
    for i, (r, n) in enumerate(zip(rows, seq_lens)):
        out[i, :n] = np.asarray(r).reshape((n,) + tuple(tail))
    return out, np.asarray(seq_lens, np.int64)


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place, low, high):
    lens = (
        recursive_seq_lens[0]
        if isinstance(recursive_seq_lens[0], (list, tuple))
        else recursive_seq_lens
    )
    rows = [
        np.random.randint(low, high + 1, size=(n,) + tuple(base_shape))
        for n in lens
    ]
    return create_lod_tensor(rows, [list(lens)], place)


def to_dlpack(value):
    """A DLPack-capable tensor of a framework value (reference
    framework/dlpack_tensor.cc): a torch tensor as it is (consumed by
    torch.utils.dlpack.from_dlpack or np.from_dlpack, zero-copy), anything
    else as a CPU tensor."""
    import torch

    return value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))


def from_dlpack(tensor, place=None):
    """A DLPack-capable tensor (numpy's, another framework's) as a torch
    tensor on the place's device (CUDAPlace(0) unless given), zero-copy
    where it already lies there."""
    import torch

    from .place import to_device

    return torch.from_dlpack(tensor).to(to_device(place))
