"""Crash-safe, manifest-based checkpoints (the JAX package's
resilience/checkpoint.py, on torch).

Layout (one directory per checkpoint under a common root):

    <root>/ckpt-00000012/
        <var>.npy            tensor payloads (io.save_arrays layout, so a
        <var>.npy.dtype      checkpoint is also readable by io.load_arrays)
        MANIFEST.json        {"version": 1, "step": 12,
                              "files": {"<rel>": {"sha256": ..., "size": ...}}}

The files are the JAX package's, so each package resumes from what the
other wrote. Commit discipline: tensor files land first (each one atomically
and durably: write a temp, fsync, rename, then one fsync of the directory;
io.save_arrays), the MANIFEST is written last with the same ladder. A crash
or a power cut at any point leaves either a previous complete checkpoint, or
a manifest-less / checksum-mismatched directory that load_latest_valid
skips (the reference's etcd master snapshot, go/master/service.go:166-207,
generalized to a directory of tensors).

Values go to the host as numpy arrays (a bf16 tensor as a CPU bf16 tensor:
numpy has no bfloat16) and come back as tensors on the scope's device.
`resume_or_init` is the trainer-loop entry: run the startup program, then
overlay the latest valid checkpoint if one exists.
"""

import hashlib
import json
import os
import re
import shutil
import warnings

import numpy as np
import torch

from . import faults, health

__all__ = [
    "save_checkpoint",
    "load_latest_valid",
    "latest_valid_dir",
    "resume_or_init",
    "snapshot_persistables",
    "verify_checkpoint",
]

MANIFEST = "MANIFEST.json"
_CKPT_RE = re.compile(r"^ckpt-(\d+)$")


def _sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _list_checkpoints(root):
    """[(step, dirpath)] newest first."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    out = []
    for name in names:
        m = _CKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(root, name)))
    out.sort(reverse=True)
    return out


def save_checkpoint(root, arrays, step, keep_last=3):
    """Write `arrays` (name -> array or tensor) as checkpoint `step` under
    `root`; returns the checkpoint directory. Old checkpoints beyond the
    newest `keep_last` are deleted after the new manifest commits, so GC can
    never leave fewer than one valid checkpoint behind."""
    from .. import io as fluid_io

    ckpt_dir = os.path.join(root, "ckpt-%08d" % step)
    if os.path.isdir(ckpt_dir):
        # a previous crashed or duplicate attempt at this step: rewrite cleanly
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    fluid_io.save_arrays(ckpt_dir, arrays)  # carries the ckpt_crash hook
    files = {}
    for dirpath, _dirs, fnames in os.walk(ckpt_dir):
        for fname in sorted(fnames):
            if fname == MANIFEST or ".tmp." in fname:
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, ckpt_dir)
            files[rel] = {"sha256": _sha256(path), "size": os.path.getsize(path)}
    faults.crash("manifest_crash", ckpt_dir)
    manifest = {"version": 1, "step": int(step), "files": files}
    # every data file and the directory entries are on disk before the
    # manifest publishes (save_arrays fsyncs both); the manifest itself gets
    # file fsync -> rename -> directory fsync
    tmp = os.path.join(ckpt_dir, "%s.tmp.%d" % (MANIFEST, os.getpid()))
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(ckpt_dir, MANIFEST))
    fluid_io.fsync_dir(ckpt_dir)
    if keep_last and keep_last > 0:
        for _s, old in _list_checkpoints(root)[keep_last:]:
            # the manifest goes first (an atomic unlink): a GC killed
            # mid-rmtree leaves a manifest-less dir that recovery skips
            try:
                os.unlink(os.path.join(old, MANIFEST))
            except OSError:
                pass
            shutil.rmtree(old, ignore_errors=True)
    return ckpt_dir


def verify_checkpoint(ckpt_dir):
    """True iff the manifest exists and every listed file matches its
    recorded size and sha256 (torn or partial checkpoints fail here)."""
    try:
        with open(os.path.join(ckpt_dir, MANIFEST)) as f:
            manifest = json.load(f)
        files = manifest["files"]
    except (OSError, ValueError, KeyError):
        return False
    for rel, meta in files.items():
        path = os.path.join(ckpt_dir, rel)
        try:
            if os.path.getsize(path) != meta["size"]:
                return False
            if _sha256(path) != meta["sha256"]:
                return False
        except (OSError, KeyError):
            return False
    return True


def latest_valid_dir(root):
    """(step, dir) of the newest checkpoint that verifies, or None. Invalid
    candidates are counted and warned about, never raised over."""
    for step, ckpt_dir in _list_checkpoints(root):
        if verify_checkpoint(ckpt_dir):
            return step, ckpt_dir
        health.incr("ckpt_skipped_invalid")
        warnings.warn(
            "skipping invalid/torn checkpoint %s (no manifest or checksum "
            "mismatch)" % ckpt_dir
        )
    return None


def load_latest_valid(root):
    """(step, name -> CPU tensor) of the newest consistent checkpoint, or
    None."""
    from .. import io as fluid_io

    found = latest_valid_dir(root)
    if found is None:
        return None
    step, ckpt_dir = found
    return step, fluid_io.load_arrays(ckpt_dir)


def host_copy(val):
    """A host copy of a scope value that no later step can change: a numpy
    array, or a CPU tensor for bf16 (numpy has no bfloat16). On the card a
    replayed graph updates its state tensors in place, so a reference would
    not do."""
    if isinstance(val, torch.Tensor):
        t = val.detach()
        if t.dtype == torch.bfloat16:
            return t.to("cpu", copy=True)
        return t.to("cpu", copy=True).numpy()
    return np.array(np.asarray(val))


def checkpointable(program, scope):
    """name -> live scope value of the program's persistables minus the
    gradient staging names (`*@GRAD`), the save_persistables set. A value a
    ParallelExecutor holds as this rank's rows (ZeRO-1 moments, ep tables)
    is gathered whole, so every rank of its axes must call."""
    from ..io import _is_persistable
    from ..parallel.collectives import gathered_state

    out = {}
    for v in program.list_vars():
        if not _is_persistable(v) or "@" in v.name:
            continue
        if scope.find_var(v.name) is not None:
            out[v.name] = gathered_state(scope, v.name)
    return out


def snapshot_persistables(program, scope=None):
    """Host-side name -> array snapshot of the program's persistable state
    (params, optimizer accumulators, lr): the checkpointable set, copied to
    the host now."""
    from ..executor import global_scope

    scope = scope or global_scope()
    return {n: host_copy(v) for n, v in checkpointable(program, scope).items()}


def overlay(scope, arrays, program=None):
    """Land loaded arrays in `scope` as tensors on its device (copies; only
    the names `program` knows when one is given). A name the scope holds in
    a captured graph's state is rebound, and the graph's next replay copies
    the value into its own tensor; a name held as this rank's rows takes its
    rows of the value."""
    from ..io import _to_tensor
    from ..parallel.collectives import reshard_state

    allowed = None if program is None else {v.name for v in program.list_vars()}
    for name, arr in arrays.items():
        if allowed is not None and name not in allowed:
            continue
        if isinstance(arr, torch.Tensor):
            val = arr.detach().to(scope.device, copy=True)
        else:
            val = _to_tensor(np.asarray(arr), None, scope.device)
        if name in scope.row_shards:
            reshard_state(scope, name, val)  # this rank's rows of it
        else:
            scope.set_var(name, val)


def resume_or_init(exe, startup_program, root, scope=None, program=None):
    """Trainer-loop entry: run the startup program, then overlay the latest
    valid checkpoint from `root` (if any) onto the scope. Returns the number
    of completed steps recorded in that checkpoint (0 for a fresh start),
    the index the training loop resumes from.

    `program` optionally restricts the restore to names that program knows
    (a checkpoint written by a wider program must not leak foreign vars into
    this scope)."""
    from ..executor import global_scope

    exe.run(startup_program)
    found = load_latest_valid(root)
    if found is None:
        return 0
    step, arrays = found
    overlay(scope or global_scope(), arrays, program)
    health.incr("resumed_from_checkpoint")
    return step
