"""Async, host-sharded, replicated checkpoints: the elastic format (the JAX
package's resilience/async_ckpt.py on torch; the files and the manifests are
the JAX package's, so each package loads what the other writes).

Reference analog: the pserver checkpoint path (checkpoint_notify_op →
each pserver persisting its own table shard) plus the etcd master snapshot
(go/master/service.go) — state survives because every owner writes its own
shard and a coordinator commits a single consistent record. Here the same
protocol is rebuilt for a ZeRO-1 / ep-sharded cluster as plain files:

Layout (one directory per checkpoint under a common root):

    <root>/eckpt-00000042/
        shard-00000-of-00002.npz      host 0's owned row ranges of EVERY
                                      checkpointable array (the embedding
                                      .npz layout, generalized past tables)
        shard-00000.ok.json           per-host "my shard landed" marker
        replica-00001-by-00000.npz    host 0's copy of host 1's shard — the
                                      neighbor replica: losing any ONE host
                                      (or its host-local files) loses nothing
        commit-00000.json             per-host commit marker (files + sha256)
        MANIFEST.json                 written atomically LAST by rank 0, only
                                      after every host's commit marker exists

Commit discipline (per host):
  1. slice own ranges, write shard tmp → fsync → rename → fsync dir,
     publish the `.ok` marker;
  2. wait for the RIGHT neighbor's `.ok`, byte-copy its landed shard into a
     replica file (the filesystem stands in for the replica RPC a
     host-local-storage deployment would use), verify the checksum;
  3. publish the commit marker.
Rank 0 then waits for all commit markers (the cross-host barrier) and
publishes MANIFEST.json atomically — fsyncing file and directory — so a
crash at ANY point leaves either a previous complete checkpoint or a
manifest-less directory that `latest_valid_elastic` skips.

The manifest records the topology (num_hosts/dp/ep) and per-host range plan
at save time plus a data cursor (epoch, batch index, shard seed), so
`load_elastic` can reassemble the FULL arrays on any later topology —
shard count on disk is independent of the mesh that resumes (the same
contract as embedding.EmbeddingEngine.load_sharded: the next executor run
places the state on whatever mesh is live). A bf16 array is stored widened
to f32 with "bfloat16" as its recorded dtype, and loads back as a
torch.bfloat16 tensor (numpy has no bfloat16); every other array loads as
numpy.

`AsyncCheckpointer` is the training-loop face: `save()` blocks only for the
device-to-host copy (the measured step stall, resilience/ckpt_stall_ms),
made into pinned host buffers that it allocates once and reuses, and a
daemon writer does everything else off the step path.

Incremental deltas (the online-learning format, docs/online.md): a
`eckpt-delta-%08d` directory references a base eckpt and carries only the
params that changed since its parent — dirty dense arrays whole, embedding
tables as (touched row ids, touched row values) pairs keyed `<name>` +
`<name>@rows`. Deltas form a chain base → d1 → d2 → … linked by
`parent_step`; each link reuses the shard/commit/manifest-last ladder (no
neighbor replicas: deltas are small and frequent, and losing one only costs
staleness — the base checkpoint is the durability anchor).
`resolve_delta_chain` returns the longest valid prefix, skipping a
torn/manifest-less delta the same way `latest_valid_elastic` skips torn
bases; `load_with_deltas` replays the chain into full arrays. Compaction is
the writer's job: publish a fresh base once the chain exceeds its budget,
then `gc_elastic_deltas` (manifest-first, like base GC) retires the stale
chain.
"""

import json
import os
import re
import shutil
import threading
import time
import warnings
import zlib

import numpy as np
import torch

from . import faults, health
from .checkpoint import _sha256
from .retry import DeadlineExceeded

__all__ = [
    "AsyncCheckpointer",
    "plan_host_ranges",
    "write_elastic_checkpoint",
    "verify_elastic_checkpoint",
    "latest_valid_elastic",
    "load_elastic",
    "list_elastic_checkpoints",
    "write_elastic_delta",
    "list_elastic_deltas",
    "verify_elastic_delta",
    "resolve_delta_chain",
    "apply_delta",
    "load_with_deltas",
    "gc_elastic_deltas",
]

MANIFEST = "MANIFEST.json"
_ECKPT_RE = re.compile(r"^eckpt-(\d+)$")
_DELTA_RE = re.compile(r"^eckpt-delta-(\d+)$")
# npz key suffix for a table delta's touched-row-id array; the bare key holds
# the touched rows' values. "@" keeps the pair out of any var namespace.
ROWS_KEY = "@rows"


def _registry():
    from ..observability.registry import default_registry

    return default_registry()


def _shard_file(h, n):
    return "shard-%05d-of-%05d.npz" % (h, n)


def _shard_ok(h):
    return "shard-%05d.ok.json" % h


def _replica_file(owner, writer):
    return "replica-%05d-by-%05d.npz" % (owner, writer)


def _commit_file(h):
    return "commit-%05d.json" % h


def _fsync_dir(path):
    """Durably record a directory entry (a rename alone is not durable until
    the PARENT directory's metadata hits disk) — io.fsync_dir, imported
    lazily so this module stays import-light."""
    from .. import io as fluid_io

    fluid_io.fsync_dir(path)


def _atomic_write(path, data, binary=False):
    """tmp → write → fsync(file) → rename → fsync(dir). The full durability
    ladder: after this returns, a power cut cannot surface a torn or
    disappearing file at `path`."""
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "wb" if binary else "w") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


# ------------------------------------------------------------ partition plan


def plan_host_ranges(shapes, num_hosts):
    """Deterministic ownership plan: name -> [lo, hi) row range per host.

    Arrays whose leading dim can be split `num_hosts` ways get balanced
    contiguous row ranges (exactly the ZeRO-1 / ep shard a host already
    holds); smaller arrays and scalars are wholly owned by a stable-hash
    host (entry value None = "the whole array"). The plan is a pure function
    of (sorted names, shapes, num_hosts), so a restore needs only the
    manifest — never the saving process.
    """
    num_hosts = int(num_hosts)
    if num_hosts < 1:
        raise ValueError("num_hosts must be >= 1, got %d" % num_hosts)
    plans = [dict() for _ in range(num_hosts)]
    for name in sorted(shapes):
        shape = tuple(shapes[name])
        rows = shape[0] if shape else 0
        if shape and rows >= num_hosts > 1:
            for h in range(num_hosts):
                plans[h][name] = [h * rows // num_hosts,
                                  (h + 1) * rows // num_hosts]
        else:
            owner = zlib.crc32(name.encode()) % num_hosts
            plans[owner][name] = None
    return plans


def _widen(a):
    """(storable numpy array, original dtype string): a bf16 tensor is stored
    as f32 (lossless widening, as io.save_arrays does) and recorded as
    "bfloat16"; a tensor of another dtype goes to numpy as it is."""
    if isinstance(a, torch.Tensor):
        t = a.detach()
        if t.dtype == torch.bfloat16:
            return t.float().cpu().numpy(), "bfloat16"
        a = t.cpu().numpy()
    a = np.asarray(a)
    return a, str(a.dtype)


def _shape(a):
    return tuple(a.shape) if isinstance(a, torch.Tensor) else np.asarray(a).shape


def _bf16(arr):
    """An f32 array narrowed back to the bf16 tensor it was saved from."""
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32)).to(torch.bfloat16)


# ------------------------------------------------------------- write path


def _write_npz(dirname, fname, payload):
    """Atomic, durable .npz of a name->array dict, with the existing
    `ckpt_crash` hook between tmp write and rename (same fault grammar as
    io.save_arrays, so PADDLE_TPU_FAULTS=ckpt_crash:... tears elastic
    checkpoints too)."""
    path = os.path.join(dirname, fname)
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    if faults.fires("ckpt_crash"):
        raise faults.InjectedFault("ckpt_crash during save of %r" % path)
    os.replace(tmp, path)
    _fsync_dir(dirname)
    return path


def _write_host_shard(dirname, host_id, num_hosts, arrays, plan_h):
    payload = {}
    for name, rng in plan_h.items():
        a, _dt = _widen(arrays[name])
        payload[name] = a if rng is None else a[rng[0]:rng[1]]
    fname = _shard_file(host_id, num_hosts)
    path = _write_npz(dirname, fname, payload)
    marker = {
        "host": host_id,
        "file": fname,
        "sha256": _sha256(path),
        "size": os.path.getsize(path),
    }
    _atomic_write(os.path.join(dirname, _shard_ok(host_id)),
                  json.dumps(marker))
    return marker


def _wait_for(path, timeout, what):
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise DeadlineExceeded(
                "elastic checkpoint barrier: %s (%s) missing after %.1fs"
                % (what, path, timeout)
            )
        time.sleep(0.01)


def _write_replica(dirname, owner, writer, timeout):
    """Copy the (landed, checksummed) neighbor shard into a replica file.
    Through a shared checkpoint filesystem this is a byte copy; with
    host-local storage the same bytes would travel the replica RPC — the
    protocol (land, verify, then commit) is identical."""
    ok_path = os.path.join(dirname, _shard_ok(owner))
    _wait_for(ok_path, timeout, "shard marker of host %d" % owner)
    with open(ok_path) as f:
        marker = json.load(f)
    src = os.path.join(dirname, marker["file"])
    with open(src, "rb") as f:
        data = f.read()
    dst = _replica_file(owner, writer)
    _atomic_write(os.path.join(dirname, dst), data, binary=True)
    if _sha256(os.path.join(dirname, dst)) != marker["sha256"]:
        raise IOError(
            "replica of host %d shard failed checksum after copy" % owner
        )
    return {"file": dst, "sha256": marker["sha256"], "size": marker["size"]}


def _write_commit(dirname, host_id, files):
    faults.crash("eckpt_commit_crash", dirname)
    _atomic_write(
        os.path.join(dirname, _commit_file(host_id)),
        json.dumps({"host": host_id, "files": files}),
    )


def _wait_commit_barrier(dirname, num_hosts, timeout):
    for h in range(num_hosts):
        _wait_for(os.path.join(dirname, _commit_file(h)), timeout,
                  "commit marker of host %d" % h)


def write_elastic_checkpoint(
    root,
    arrays,
    step,
    num_hosts=1,
    host_id=0,
    cursor=None,
    topology=None,
    keep_last=3,
    barrier_timeout=None,
):
    """One host's full contribution to elastic checkpoint `step`: shard +
    neighbor replica + commit marker; rank 0 additionally runs the barrier,
    publishes the manifest, and GCs old checkpoints. Returns the checkpoint
    dir (all hosts). Synchronous — AsyncCheckpointer calls this off-thread."""
    if barrier_timeout is None:
        from .. import flags as _flags

        barrier_timeout = float(
            _flags.get_flags("elastic_barrier_timeout_s")[
                "elastic_barrier_timeout_s"]
        )
    ckpt_dir = os.path.join(root, "eckpt-%08d" % step)
    os.makedirs(ckpt_dir, exist_ok=True)
    shapes = {n: _shape(a) for n, a in arrays.items()}
    plans = plan_host_ranges(shapes, num_hosts)
    files = {}
    marker = _write_host_shard(ckpt_dir, host_id, num_hosts, arrays,
                               plans[host_id])
    files[marker["file"]] = {"sha256": marker["sha256"],
                             "size": marker["size"]}
    if num_hosts > 1:
        owner = (host_id + 1) % num_hosts
        rep = _write_replica(ckpt_dir, owner, host_id, barrier_timeout)
        files[rep["file"]] = {"sha256": rep["sha256"], "size": rep["size"]}
    _write_commit(ckpt_dir, host_id, files)
    if host_id == 0:
        _wait_commit_barrier(ckpt_dir, num_hosts, barrier_timeout)
        _publish_manifest(ckpt_dir, arrays, step, num_hosts, plans, cursor,
                          topology)
        if keep_last and keep_last > 0:
            for _s, old in list_elastic_checkpoints(root)[keep_last:]:
                # unlink the manifest FIRST (atomic): a GC killed mid-rmtree
                # must leave a manifest-less dir (skipped by recovery), never
                # a manifest whose data files are half-deleted
                try:
                    os.unlink(os.path.join(old, MANIFEST))
                except OSError:
                    pass
                shutil.rmtree(old, ignore_errors=True)
    return ckpt_dir


def _publish_manifest(ckpt_dir, arrays, step, num_hosts, plans, cursor,
                      topology):
    all_files = {}
    for h in range(num_hosts):
        with open(os.path.join(ckpt_dir, _commit_file(h))) as f:
            all_files.update(json.load(f)["files"])
    meta = {}
    for n, a in arrays.items():
        stored, orig = _widen(a)
        meta[n] = {
            "shape": list(_shape(a)),
            "dtype": orig,
            "stored_dtype": str(stored.dtype),
        }
    manifest = {
        "version": 1,
        "step": int(step),
        "num_hosts": int(num_hosts),
        "topology": dict(topology or {}),
        "cursor": dict(cursor or {}),
        "arrays": meta,
        "ranges": [
            {n: r for n, r in plan.items()} for plan in plans
        ],
        "files": all_files,
    }
    faults.crash("manifest_crash", ckpt_dir)
    _atomic_write(os.path.join(ckpt_dir, MANIFEST),
                  json.dumps(manifest, indent=1))
    try:
        now = time.time()
        _registry().counter(
            "resilience/ckpt_commits",
            help="elastic checkpoints committed (manifest published)",
        ).inc()
        _registry().gauge(
            "resilience/last_ckpt_unixtime",
            help="wall time of the last committed elastic checkpoint",
        ).set(now)
        _registry().gauge(
            "resilience/last_ckpt_step",
            help="step of the last committed elastic checkpoint",
        ).set(float(step))
    except Exception:
        pass  # observability must never fail a commit


# -------------------------------------------------------------- read path


def list_elastic_checkpoints(root):
    """[(step, dirpath)] newest first."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    out = []
    for name in names:
        m = _ECKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(root, name)))
    out.sort(reverse=True)
    return out


def _read_manifest(ckpt_dir):
    with open(os.path.join(ckpt_dir, MANIFEST)) as f:
        return json.load(f)


def _host_source(ckpt_dir, manifest, h):
    """The readable, checksum-verified file holding host h's ranges: its
    primary shard if intact, else any replica of it — this OR is exactly the
    lose-any-one-host guarantee."""
    files = manifest["files"]
    num_hosts = manifest["num_hosts"]
    candidates = [_shard_file(h, num_hosts)] + [
        _replica_file(h, w) for w in range(num_hosts) if w != h
    ]
    for fname in candidates:
        meta = files.get(fname)
        if meta is None:
            continue
        path = os.path.join(ckpt_dir, fname)
        try:
            if (os.path.getsize(path) == meta["size"]
                    and _sha256(path) == meta["sha256"]):
                return path
        except OSError:
            continue
    return None


def verify_elastic_checkpoint(ckpt_dir):
    """True iff the manifest exists and EVERY host's ranges are recoverable
    from at least one intact file (primary or replica)."""
    try:
        manifest = _read_manifest(ckpt_dir)
    except (OSError, ValueError):
        return False
    try:
        return all(
            _host_source(ckpt_dir, manifest, h) is not None
            for h in range(manifest["num_hosts"])
        )
    except (KeyError, TypeError):
        return False


def latest_valid_elastic(root):
    """(step, dir) of the newest recoverable elastic checkpoint, or None.
    Unrecoverable candidates are counted + warned, never raised over."""
    for step, ckpt_dir in list_elastic_checkpoints(root):
        if verify_elastic_checkpoint(ckpt_dir):
            return step, ckpt_dir
        health.incr("ckpt_skipped_invalid")
        warnings.warn(
            "skipping unrecoverable elastic checkpoint %s (missing manifest "
            "or a host's ranges have neither shard nor replica)" % ckpt_dir
        )
    return None


def load_elastic(ckpt_dir):
    """Reassemble the FULL name->array dict from per-host shards, falling
    back to replicas for any host whose primary is gone. Topology-blind by
    construction: the caller overlays the full arrays into a scope and the
    next executor run places them on whatever mesh is live (a
    ParallelExecutor shards its state at its first run), so a dp=N/ep=K
    checkpoint resumes on dp=M/ep=J. Returns (step, arrays, manifest): numpy
    arrays, bf16 ones as torch.bfloat16 tensors."""
    manifest = _read_manifest(ckpt_dir)
    num_hosts = manifest["num_hosts"]
    meta = manifest["arrays"]
    out = {}
    for h in range(num_hosts):
        src = _host_source(ckpt_dir, manifest, h)
        if src is None:
            raise IOError(
                "elastic checkpoint %s: host %d has neither an intact shard "
                "nor a replica — more than one host lost" % (ckpt_dir, h)
            )
        with np.load(src) as z:
            for name, rng in manifest["ranges"][h].items():
                m = meta[name]
                if name not in out:
                    out[name] = np.empty(
                        tuple(m["shape"]), dtype=np.dtype(m["stored_dtype"])
                    )
                if rng is None:
                    out[name] = np.asarray(z[name]).reshape(
                        tuple(m["shape"])
                    ).astype(np.dtype(m["stored_dtype"]))
                else:
                    out[name][rng[0]:rng[1]] = z[name]
    for name, m in meta.items():
        if "bfloat16" in m["dtype"]:
            out[name] = _bf16(out[name])
    return manifest["step"], out, manifest


# ------------------------------------------------------ incremental deltas


def _plan_delta(dense_shapes, rows_counts, num_hosts):
    """Ownership plan for a delta's payload keys. Dense keys reuse
    plan_host_ranges; each table's (values, @rows) pair splits over the SAME
    touched-row ranges so a host's shard is self-contained (scattering host
    h's values needs host h's ids)."""
    plans = plan_host_ranges(dense_shapes, num_hosts)
    for name in sorted(rows_counts):
        n = int(rows_counts[name])
        if n >= num_hosts > 1:
            for h in range(num_hosts):
                lo, hi = h * n // num_hosts, (h + 1) * n // num_hosts
                plans[h][name] = [lo, hi]
                plans[h][name + ROWS_KEY] = [lo, hi]
        else:
            owner = zlib.crc32(name.encode()) % num_hosts
            plans[owner][name] = None
            plans[owner][name + ROWS_KEY] = None
    return plans


def write_elastic_delta(
    root,
    step,
    base_step,
    parent_step,
    dense,
    rows=None,
    num_hosts=1,
    host_id=0,
    cursor=None,
    stamp=None,
    barrier_timeout=None,
):
    """One host's contribution to incremental delta `step` on the chain
    rooted at `base_step` (parent_step = the previous link, or base_step for
    the first delta). `dense` maps name -> full dirty array; `rows` maps
    table name -> (row_ids, row_values, full_shape). Same commit discipline
    as the base format minus the neighbor replica; rank 0 runs the barrier
    and publishes the manifest LAST, so a crash mid-write leaves a
    manifest-less dir that resolve_delta_chain skips. Returns the delta
    dir."""
    if barrier_timeout is None:
        from .. import flags as _flags

        barrier_timeout = float(
            _flags.get_flags("elastic_barrier_timeout_s")[
                "elastic_barrier_timeout_s"]
        )
    rows = rows or {}
    delta_dir = os.path.join(root, "eckpt-delta-%08d" % step)
    os.makedirs(delta_dir, exist_ok=True)
    payload = {}
    meta = {}
    rows_counts = {}
    for n, a in dense.items():
        stored, orig = _widen(a)
        payload[n] = stored
        meta[n] = {
            "kind": "dense",
            "shape": list(stored.shape),
            "dtype": orig,
            "stored_dtype": str(stored.dtype),
        }
    for n, (ids, vals, full_shape) in rows.items():
        ids = np.asarray(ids, dtype=np.int64)
        stored, orig = _widen(vals)
        if stored.shape[:1] != ids.shape:
            raise ValueError(
                "table %r delta: %d row values for %d row ids"
                % (n, stored.shape[0], ids.shape[0])
            )
        payload[n] = stored
        payload[n + ROWS_KEY] = ids
        rows_counts[n] = ids.shape[0]
        meta[n] = {
            "kind": "rows",
            "shape": list(full_shape),
            "dtype": orig,
            "stored_dtype": str(stored.dtype),
            "rows": int(ids.shape[0]),
        }
    dense_shapes = {n: _shape(a) for n, a in dense.items()}
    plans = _plan_delta(dense_shapes, rows_counts, num_hosts)
    files = {}
    marker = _write_host_shard(delta_dir, host_id, num_hosts, payload,
                               plans[host_id])
    files[marker["file"]] = {"sha256": marker["sha256"],
                             "size": marker["size"]}
    _write_commit(delta_dir, host_id, files)
    if host_id == 0:
        _wait_commit_barrier(delta_dir, num_hosts, barrier_timeout)
        all_files = {}
        for h in range(num_hosts):
            with open(os.path.join(delta_dir, _commit_file(h))) as f:
                all_files.update(json.load(f)["files"])
        manifest = {
            "version": 1,
            "kind": "delta",
            "step": int(step),
            "base_step": int(base_step),
            "parent_step": int(parent_step),
            "num_hosts": int(num_hosts),
            "cursor": dict(cursor or {}),
            "stamp": dict(stamp or {}),
            "arrays": meta,
            "ranges": [{n: r for n, r in plan.items()} for plan in plans],
            "files": all_files,
        }
        faults.crash("manifest_crash", delta_dir)
        _atomic_write(os.path.join(delta_dir, MANIFEST),
                      json.dumps(manifest, indent=1))
        try:
            _registry().counter(
                "resilience/delta_commits",
                help="incremental checkpoint deltas committed",
            ).inc()
        except Exception:
            pass
    return delta_dir


def list_elastic_deltas(root):
    """[(step, dirpath)] of delta dirs, newest first."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    out = []
    for name in names:
        m = _DELTA_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(root, name)))
    out.sort(reverse=True)
    return out


def _delta_source(delta_dir, manifest, h):
    """Host h's checksum-verified delta shard, or None. Deltas have no
    replicas — a torn shard makes the whole delta (and everything chained
    past it) unusable, which costs only staleness."""
    fname = _shard_file(h, manifest["num_hosts"])
    meta = manifest["files"].get(fname)
    if meta is None:
        return None
    path = os.path.join(delta_dir, fname)
    try:
        if (os.path.getsize(path) == meta["size"]
                and _sha256(path) == meta["sha256"]):
            return path
    except OSError:
        pass
    return None


def verify_elastic_delta(delta_dir):
    """True iff the delta's manifest exists and every host's shard is
    intact."""
    try:
        manifest = _read_manifest(delta_dir)
    except (OSError, ValueError):
        return False
    if manifest.get("kind") != "delta":
        return False
    try:
        return all(
            _delta_source(delta_dir, manifest, h) is not None
            for h in range(manifest["num_hosts"])
        )
    except (KeyError, TypeError):
        return False


def resolve_delta_chain(root, upto_step=None):
    """(base_step, base_dir, [(step, delta_dir), ...]) — the newest valid
    base at or below `upto_step` plus the longest valid chain of deltas
    rooted at it (ascending, each link's parent_step matching the previous
    step). A torn/manifest-less delta ends the chain THERE — later deltas
    reference an unusable parent — exactly the skip discipline
    latest_valid_elastic applies to torn bases. Returns None when no valid
    base exists."""
    base = None
    for step, ckpt_dir in list_elastic_checkpoints(root):
        if upto_step is not None and step > upto_step:
            continue
        if verify_elastic_checkpoint(ckpt_dir):
            base = (step, ckpt_dir)
            break
        health.incr("ckpt_skipped_invalid")
    if base is None:
        return None
    base_step, base_dir = base
    chain = []
    parent = base_step
    for step, delta_dir in sorted(list_elastic_deltas(root)):
        if step <= base_step:
            continue
        if upto_step is not None and step > upto_step:
            break
        try:
            manifest = _read_manifest(delta_dir)
        except (OSError, ValueError):
            manifest = None
        if manifest is None or not verify_elastic_delta(delta_dir):
            health.incr("delta_skipped_invalid")
            warnings.warn(
                "skipping torn/manifest-less delta %s; chain ends at step %d"
                % (delta_dir, parent)
            )
            break
        if manifest.get("base_step") != base_step:
            # a stale chain rooted at an older (or GC'd) base: not ours
            continue
        if manifest.get("parent_step") != parent:
            warnings.warn(
                "delta %s parents step %s but the chain is at %d — gap; "
                "chain ends" % (delta_dir, manifest.get("parent_step"), parent)
            )
            break
        chain.append((step, delta_dir))
        parent = step
    return base_step, base_dir, chain


def apply_delta(delta_dir, arrays):
    """Replay one delta onto a full name->array dict (from load_elastic or a
    previous apply_delta): dense entries overwrite whole arrays, table
    entries scatter touched-row values at their ids. Never mutates the input
    dict's arrays — touched tables are copied first (the reader-side
    copy-on-publish). Returns (step, new arrays dict, manifest)."""
    manifest = _read_manifest(delta_dir)
    meta = manifest["arrays"]
    num_hosts = manifest["num_hosts"]

    buffers = {}

    def _buffer(key, shape, dtype):
        if key not in buffers:
            buffers[key] = np.empty(tuple(shape), dtype=np.dtype(dtype))
        return buffers[key]

    for h in range(num_hosts):
        ranges = manifest["ranges"][h]
        if not ranges:
            continue
        src = _delta_source(delta_dir, manifest, h)
        if src is None:
            raise IOError(
                "delta %s: host %d shard missing or torn" % (delta_dir, h)
            )
        with np.load(src) as z:
            for key, rng in ranges.items():
                name = key[:-len(ROWS_KEY)] if key.endswith(ROWS_KEY) else key
                m = meta[name]
                if m["kind"] == "dense":
                    buf = _buffer(key, m["shape"], m["stored_dtype"])
                elif key.endswith(ROWS_KEY):
                    buf = _buffer(key, (m["rows"],), "int64")
                else:
                    buf = _buffer(
                        key, (m["rows"],) + tuple(m["shape"][1:]),
                        m["stored_dtype"],
                    )
                if rng is None:
                    buf[...] = np.asarray(z[key]).reshape(buf.shape)
                else:
                    buf[rng[0]:rng[1]] = z[key]

    out = dict(arrays)
    for name, m in meta.items():
        if m["kind"] == "dense":
            full = buffers[name]
            out[name] = _bf16(full) if "bfloat16" in m["dtype"] else full
        else:
            if name not in out:
                raise KeyError(
                    "delta %s updates rows of %r, absent from the base"
                    % (delta_dir, name)
                )
            ids = buffers[name + ROWS_KEY]
            vals = buffers[name]
            base, _dt = _widen(out[name])
            base = np.array(base)  # copy-on-publish
            if list(base.shape) != list(m["shape"]):
                raise ValueError(
                    "delta %s: table %r is %s on disk but %s live"
                    % (delta_dir, name, m["shape"], list(base.shape))
                )
            base[ids] = vals.astype(base.dtype)
            out[name] = _bf16(base) if "bfloat16" in m["dtype"] else base
    return manifest["step"], out, manifest


def load_with_deltas(root, upto_step=None):
    """Full arrays at the newest (or `upto_step`-bounded) published version:
    load the base eckpt, then replay its valid delta chain in order. Returns
    (step, arrays, info) where info records the chain walked and the last
    link's manifest stamp — None when no valid base exists."""
    found = resolve_delta_chain(root, upto_step=upto_step)
    if found is None:
        return None
    base_step, base_dir, chain = found
    step, arrays, manifest = load_elastic(base_dir)
    stamp = dict(manifest.get("stamp") or {})
    cursor = dict(manifest.get("cursor") or {})
    for _s, delta_dir in chain:
        step, arrays, manifest = apply_delta(delta_dir, arrays)
        stamp = dict(manifest.get("stamp") or stamp)
        cursor = dict(manifest.get("cursor") or cursor)
    info = {
        "base_step": base_step,
        "base_dir": base_dir,
        "deltas": [s for s, _ in chain],
        "stamp": stamp,
        "cursor": cursor,
    }
    return step, arrays, info


def gc_elastic_deltas(root, keep_base_step=None, before_step=None):
    """Retire delta dirs: those rooted at a different base than
    `keep_base_step` (stale chains after a compaction) and/or those at or
    below `before_step`. Manifest-first, like base GC — a GC killed
    mid-rmtree leaves a manifest-less dir the chain walk already skips.
    Returns the number of dirs removed."""
    removed = 0
    for step, delta_dir in list_elastic_deltas(root):
        stale = False
        if before_step is not None and step <= before_step:
            stale = True
        if keep_base_step is not None and not stale:
            try:
                manifest = _read_manifest(delta_dir)
                stale = manifest.get("base_step") != int(keep_base_step)
            except (OSError, ValueError):
                stale = True  # torn dir: nothing can chain through it
        if not stale:
            continue
        try:
            os.unlink(os.path.join(delta_dir, MANIFEST))
        except OSError:
            pass
        shutil.rmtree(delta_dir, ignore_errors=True)
        removed += 1
    return removed


# --------------------------------------------------------- async front-end


class AsyncCheckpointer:
    """Training-loop checkpoint front-end: `save()` stalls the step only for
    the device-to-host copy; a daemon thread runs the shard / replica /
    barrier / manifest protocol. One save in flight at a time: a save issued
    while the writer is busy first waits for it (bounded staleness, never
    unbounded queue growth).

    The copy lands in pinned host buffers, one per array, made at the first
    save that needs them and reused by every later one (a new pinned block
    costs a cudaHostAlloc of tens of ms); the writer reads them, and the next
    save waits for the writer before it overwrites them. `stats` holds the
    last save's readings: "stall_ms", "state_bytes", "pinned_blocks" (made
    in that save) and, once committed, "write_ms" (save to manifest).

    A background failure is deferred and re-raised on the next save() or
    wait(): a checkpoint failure must surface, but never asynchronously
    corrupt an unrelated step.
    """

    def __init__(self, root, num_hosts=1, host_id=0, keep_last=3,
                 topology=None, barrier_timeout=None):
        self.root = root
        self.num_hosts = int(num_hosts)
        self.host_id = int(host_id)
        self.keep_last = keep_last
        self.topology = dict(topology or {})
        self.barrier_timeout = barrier_timeout
        self.stats = {}
        self.pinned_blocks = 0  # pinned host buffers made, all saves
        self._pinned = {}  # name -> pinned CPU tensor, reused across saves
        self._thread = None
        self._error = None
        self._last_commit_dir = None
        self._lock = threading.Lock()

    # -- metrics ----------------------------------------------------------
    def _observe_stall(self, ms):
        try:
            _registry().histogram(
                "resilience/ckpt_stall_ms",
                help="step-visible checkpoint stall (device->host copy for "
                     "async saves; full write for sync)",
            ).observe(ms)
            last = _registry().gauge("resilience/last_ckpt_unixtime").value()
            if last:
                _registry().gauge(
                    "resilience/last_ckpt_age_s",
                    help="seconds since the last committed elastic checkpoint",
                ).set(max(0.0, time.time() - last))
        except Exception:
            pass

    def _host(self, name, t):
        """The pinned buffer of `name`, holding a copy of device tensor `t`
        once the stream has run the copy queued here."""
        buf = self._pinned.get(name)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = self._pinned[name] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.pinned_blocks += 1
        buf.copy_(t.detach(), non_blocking=True)
        return buf

    # -- lifecycle --------------------------------------------------------
    def save(self, arrays, step, cursor=None, block=False):
        """Copy `arrays` (name -> tensor or array) to host memory now and
        persist them in the background. Returns the step-visible stall in
        seconds. `block=True` also waits for the commit (emergency saves)."""
        self.wait()  # the previous writer must finish; re-raises its failure
        t0 = time.perf_counter()
        blocks0 = self.pinned_blocks
        snap, streams, nbytes = {}, set(), 0
        for n, a in arrays.items():
            if isinstance(a, torch.Tensor) and a.device.type == "cuda":
                snap[n] = self._host(n, a)
                streams.add(a.device)
            elif isinstance(a, torch.Tensor):
                snap[n] = a.detach().to("cpu", copy=True)
            else:
                snap[n] = np.array(np.asarray(a))
            nbytes += (snap[n].numel() * snap[n].element_size()
                       if isinstance(snap[n], torch.Tensor) else snap[n].nbytes)
        for device in streams:
            # the copies are queued behind the step that wrote the state;
            # their end is the stall
            torch.cuda.current_stream(device).synchronize()
        stall = time.perf_counter() - t0
        self._observe_stall(stall * 1000.0)
        self.stats = {"step": int(step), "stall_ms": stall * 1000.0, "state_bytes": nbytes,
                      "pinned_blocks": self.pinned_blocks - blocks0}
        t = threading.Thread(
            target=self._write, args=(snap, step, cursor, t0), daemon=True,
            name="eckpt-writer-%d" % step,
        )
        with self._lock:
            self._thread = t
        t.start()
        if block:
            self.wait()
        return stall

    def _write(self, snap, step, cursor, t0):
        try:
            d = write_elastic_checkpoint(
                self.root, snap, step,
                num_hosts=self.num_hosts, host_id=self.host_id,
                cursor=cursor, topology=self.topology,
                keep_last=self.keep_last,
                barrier_timeout=self.barrier_timeout,
            )
            with self._lock:
                self._last_commit_dir = d
                self.stats["write_ms"] = (time.perf_counter() - t0) * 1000.0
        except BaseException as e:  # deferred to the next save()/wait()
            with self._lock:
                self._error = e
            health.incr("ckpt_async_failed")

    def wait(self):
        """Join any in-flight write; raise its deferred failure."""
        with self._lock:
            t = self._thread
        if t is not None:
            t.join()
            with self._lock:
                self._thread = None
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    @property
    def last_commit_dir(self):
        with self._lock:
            return self._last_commit_dir

    def close(self):
        try:
            self.wait()
        except Exception:
            pass
