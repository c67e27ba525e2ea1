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

The compiled artifacts of inference.export_compiled and
train_export.export_train_step (the JAX module's lines 225-291) are one
`.npz` each (`artifact_path`, `write_artifact`, `read_artifact`):
torch.export.save's bytes of the exported program in place of the JAX
package's StableHLO, the feed and fetch names, the feeds' dtypes, the
`ro:` / `mut:` state (bf16 stored as f32 with a dtype record) and the
stack it was made on (`_versions`): reading it on another stack raises and
names what differs.
"""

import hashlib
import io
import json
import os

import numpy as np

__all__ = ["CompileCache", "artifact_path", "read_artifact", "variant_key", "write_artifact"]

ARTIFACT_SUFFIX = ".variant.json"
# a compiled artifact's file (np.savez appends it where it is missing)
EXPORT_SUFFIX = ".npz"
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


# ---------------------------------------------------------------------------
# compiled artifacts (inference.export_compiled, train_export): one .npz
# ---------------------------------------------------------------------------


def artifact_path(out_path):
    """The path np.savez actually writes for `out_path` (it appends `.npz`
    when missing)."""
    return out_path if out_path.endswith(EXPORT_SUFFIX) else out_path + EXPORT_SUFFIX


def write_artifact(out_path, program, feed_names, fetch_names, ro, mut, feed_dtypes, device,
                   extra=None):
    """Write one compiled artifact and return the path written: the
    exported program (torch.export.ExportedProgram), the feed and fetch
    names, each feed's dtype, the state `ro` / `mut` ({name: tensor}), the
    type of the device it runs on, the stack it was made on, and `extra`
    arrays ({"__rng__": ...}) as they are."""
    import torch

    from .. import io as _io

    buf = io.BytesIO()
    torch.export.save(program, buf)
    arrays, dtypes = {}, {}
    for prefix, group in (("ro:", ro), ("mut:", mut)):
        for k, v in group.items():
            arrays[prefix + k], stored = _io._to_numpy(v)
            if stored:
                dtypes[prefix + k] = stored
    path = artifact_path(out_path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(
        path,
        __torch_export__=np.frombuffer(buf.getvalue(), np.uint8),
        __feed_names__=np.array(list(feed_names)),
        __fetch_names__=np.array(list(fetch_names)),
        __feed_dtypes__=np.array(json.dumps({n: str(d).replace("torch.", "")
                                             for n, d in feed_dtypes.items() if d})),
        __param_dtypes__=np.array(json.dumps(dtypes)),
        __device__=np.array(device.type),
        __versions__=np.array(json.dumps(_versions(), sort_keys=True)),
        **dict(extra or {}),
        **arrays,
    )
    return path


def read_artifact(path):
    """Inverse of write_artifact: {program (the loaded ExportedProgram),
    feed_names, fetch_names, feed_dtypes, ro, mut (tensors on the device the
    artifact runs on), device, extra}. Raises where the artifact was made
    on another stack (torch, CUDA, the device's name, the kernels' build),
    naming each difference."""
    import torch

    from .. import io as _io
    from ..place import to_device

    data = np.load(artifact_path(path))
    made = json.loads(str(data["__versions__"]))
    here = _versions()
    diff = ["%s %r, here %r" % (k, made.get(k), here.get(k))
            for k in sorted(set(made) | set(here)) if made.get(k) != here.get(k)]
    if diff:
        raise RuntimeError("compiled artifact %s was made on another stack: %s"
                           % (path, "; ".join(diff)))
    from ..place import CPUPlace, CUDAPlace

    device = to_device(CUDAPlace(0) if str(data["__device__"]) == "cuda" else CPUPlace())
    dtypes = json.loads(str(data["__param_dtypes__"]))
    program = torch.export.load(io.BytesIO(data["__torch_export__"].tobytes()))

    def _state(prefix):
        return {k[len(prefix):]: _io._to_tensor(data[k], dtypes.get(k), device)
                for k in data.files if k.startswith(prefix)}

    return {
        "program": program,
        "feed_names": [str(s) for s in data["__feed_names__"]],
        "fetch_names": [str(s) for s in data["__fetch_names__"]],
        "feed_dtypes": {n: getattr(torch, d) for n, d in
                        json.loads(str(data["__feed_dtypes__"])).items()},
        "ro": _state("ro:"),
        "mut": _state("mut:"),
        "device": device,
        "extra": {k: data[k] for k in data.files
                  if k.startswith("__") and k not in _LAYOUT_KEYS},
    }


_LAYOUT_KEYS = ("__torch_export__", "__feed_names__", "__fetch_names__", "__feed_dtypes__",
                "__param_dtypes__", "__device__", "__versions__")
