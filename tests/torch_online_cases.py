"""What the online tests compare of a model repository, shared by the CPU
parity tests (tests/test_torch_online.py) and the card's
(tests/test_torch_online_cuda.py, which import no JAX)."""

import json
import os

import numpy as np

# wall-clock fields; a shard's sha256 also hashes its zip entries' write times
_CLOCKED = ("sha256", "wall_time", "ack_wall_time", "stamp_wall_time")


def _scrub(doc):
    if isinstance(doc, dict):
        return {k: _scrub(v) for k, v in doc.items() if k not in _CLOCKED}
    if isinstance(doc, list):
        return [_scrub(v) for v in doc]
    return doc


def tree(root):
    """{relative path: content} of a repository: JSON files parsed without
    their clocked fields, npz files as {key: (dtype, shape, bytes)}, any
    other file as its size."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            rel = os.path.relpath(path, root)
            if f.endswith(".json"):
                with open(path) as fh:
                    out[rel] = _scrub(json.load(fh))
            elif f.endswith(".npz"):
                with np.load(path) as z:
                    out[rel] = {k: (str(z[k].dtype), z[k].shape, z[k].tobytes()) for k in z.files}
            else:
                out[rel] = os.path.getsize(path)
    return out
