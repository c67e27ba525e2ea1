"""Persistent compile cache for the serving engines (the torch counterpart
of paddle_tpu/serving/compile_cache.py:1-231).

The JAX package stores serialized `jax.export` artifacts and hands XLA's
executable cache the same directory. A CUDA graph cannot be serialized, so
the port's artifact is what a torch process can reload instead of
preparing again:

- the served block as it is prepared: the program pruned to the ops the
  fetches need, in io.py's program dict form;
- the shape and dtype facts the meta-tensor analysis derived for every
  variable at the variant's padded feed shapes (analysis/dataflow.py).

A hit skips the preparation (pruning, the analysis that runs every op's
lowering on meta tensors); the engine still captures each variant's CUDA
graph at warmup, counted apart from `traces`. The nvcc builds persist in
paddle_tpu_torch/_build/ on their own and do not move here.

Keys (`variant_key`) fold in, where the JAX package folds jax / jaxlib /
the platform, the torch version, its CUDA version, the device's name and
the kernels' build tag (ops/_build.build_tag), so an artifact prepared for
another stack misses cleanly. Writes are atomic (tmp + os.replace) and
content-keyed, so replicas sharing a directory race only to write equal
bytes; a torn or incompatible entry counts as a miss. Hits and misses ride
the registry as `serving/compile_cache/{hits,misses}`.

`export_compiled`'s artifact layout (the JAX module's lines 232-291) comes
with inference.py (ROADMAP A7).
"""

import hashlib
import json
import os

__all__ = ["CompileCache", "variant_key"]

ARTIFACT_SUFFIX = ".variant.json"
FORMAT = 1


def _versions():
    """The stack an artifact is valid for: torch, its CUDA, the device the
    process serves on (the card's name; "cpu" without one) and the kernels'
    build tag."""
    import torch

    from ..ops import _build

    device = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
    return {"torch": torch.__version__, "cuda": torch.version.cuda, "device": device,
            "kernels": _build.build_tag()}


def variant_key(fingerprint, feed_avals, fetch_names, state_avals=None, geometry=None):
    """Content key for one prepared serving variant.

    `feed_avals` is {name: (shape tuple, dtype str)} at the PADDED bucket
    shapes. Stateful (generation) variants also pass `state_avals` (the KV
    pools' {name: (shape, dtype)}) and `geometry`, the engine's page
    layout; an int8 ServingEngine passes {"precision": "int8"}, since its
    rewritten program shares the model dir's fingerprint with the native
    one. Parameter VALUES are absent: set_params swaps same-shape values,
    so every cached variant stays valid across a hot swap."""
    doc = {
        "fingerprint": fingerprint,
        "feeds": sorted(
            (n, list(shape), str(dtype)) for n, (shape, dtype) in feed_avals.items()
        ),
        "fetches": list(fetch_names),
        "format": FORMAT,
    }
    doc.update(_versions())
    if state_avals:
        doc["state"] = sorted(
            (n, list(shape), str(dtype)) for n, (shape, dtype) in state_avals.items()
        )
    if geometry:
        doc["geometry"] = {k: geometry[k] for k in sorted(geometry)}
    return hashlib.sha256(json.dumps(doc, sort_keys=True).encode()).hexdigest()


def _jsonable(v):
    """numpy scalars and arrays inside op attrs as JSON values."""
    if hasattr(v, "tolist"):
        return v.tolist()
    raise TypeError("attr of type %s is not JSON-serializable" % type(v).__name__)


def _atomic_write_bytes(path, blob):
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


class CompileCache:
    """Keyed store of prepared serving variants: `<dir>/<key>.variant.json`
    holds {"artifact": ..., "meta": ...}; the key is the identity, the meta
    (model name, feed shapes, versions) is for a reader."""

    def __init__(self, cache_dir, enable_xla_cache=True):
        # enable_xla_cache: the JAX signature's; there is no XLA layer here
        self.dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)
        from ..observability import registry as _registry

        reg = _registry.default_registry()
        self._hits = reg.counter(
            "serving/compile_cache/hits",
            "serving variants loaded from the persistent compile cache",
        )
        self._misses = reg.counter(
            "serving/compile_cache/misses",
            "serving variants prepared because the cache had no usable entry",
        )

    def _path(self, key):
        return os.path.join(self.dir, key + ARTIFACT_SUFFIX)

    def get(self, key):
        """The stored artifact (a dict) for `key`, or None. A missing, torn
        or foreign entry counts a miss; a readable one a hit."""
        try:
            with open(self._path(key), "rb") as f:
                doc = json.loads(f.read().decode())
            artifact = doc["artifact"]
            if doc.get("key") != key or not isinstance(artifact, dict):
                raise ValueError("entry does not hold %s" % key)
        except (OSError, ValueError, KeyError, TypeError):
            self._misses.inc()
            return None
        self._hits.inc()
        return artifact

    def put(self, key, exported, meta=None):
        """Store an artifact atomically; concurrent writers of one key write
        equal bytes, so the last rename wins safely."""
        doc = {"key": key, "artifact": exported, "meta": dict(meta or {}, **_versions())}
        blob = json.dumps(doc, sort_keys=True, default=_jsonable).encode()
        _atomic_write_bytes(self._path(key), blob)

    def get_or_build(self, key, build, meta=None):
        """(artifact, hit). `build()` runs only on a miss; its result is
        stored before returning."""
        artifact = self.get(key)
        if artifact is not None:
            return artifact, True
        artifact = build()
        self.put(key, artifact, meta=meta)
        return artifact, False

    def stats(self):
        return {"hits": int(self._hits.value()), "misses": int(self._misses.value())}
