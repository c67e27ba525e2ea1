"""Checkpoint and inference-model I/O (the torch counterpart of
paddle_tpu/io.py; reference python/paddle/fluid/io.py save/load_vars,
save/load_params, save/load_persistables and save/load_inference_model).

The on-disk layout is the JAX package's, so each package reads what the
other writes: one `<name>.npy` per var with a `<name>.npy.dtype` sidecar
(empty for a native dtype, "bfloat16" for a bf16 var stored as f32), or one
`.npz` with a `__dtypes__.json` beside it (the `filename=` form), and the
program as JSON (`__model__`) with its feed and fetch names. Save and load
are host-side operations on the Scope: tensors go to numpy on the host and
come back as tensors on the scope's device. Each file is written to a temp
name, flushed to disk and renamed into place; save_arrays carries the
`ckpt_crash` fault hook (resilience/faults.py) between the first temp write
and its rename, drawn once a save call, so a fault plan tears whole
checkpoints as it does in the JAX package.
"""

import hashlib
import json
import os

import numpy as np
import torch

from . import framework
from .executor import global_scope
from .framework import Parameter, Program, Variable
from .ops.registry import torch_dtype
from .parallel.collectives import gathered_state, reshard_state
from .parallel.multihost import barrier, host_index

__all__ = [
    "save_vars",
    "save_params",
    "save_persistables",
    "load_vars",
    "load_params",
    "load_persistables",
    "save_inference_model",
    "load_inference_model",
    "get_inference_program",
    "inference_model_fingerprint",
]

MODEL_FILENAME = "__model__"


def fsync_dir(path):
    """Durably record a directory's entries after renames (best effort on
    filesystems that refuse O_RDONLY directory opens)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _to_numpy(val):
    """(array, stored dtype tag): bf16 widens to f32 (exact) and is tagged
    "bfloat16"; other dtypes travel as they are."""
    if isinstance(val, torch.Tensor):
        t = val.detach()
        if t.dtype == torch.bfloat16:
            return t.float().to("cpu").numpy(), "bfloat16"
        return t.to("cpu").numpy(), None
    a = np.asarray(val)
    if "bfloat16" in str(a.dtype):
        return a.astype(np.float32), "bfloat16"
    return a, None


def _to_tensor(arr, stored, device):
    """A loaded array as a tensor on `device`, bf16 where the save tagged
    it, else in the framework dtype of its numpy dtype (a copy: the array's
    buffer is never shared)."""
    dt = torch.bfloat16 if stored == "bfloat16" else torch_dtype(arr.dtype)
    t = torch.from_numpy(np.array(arr, dtype=np.float32 if stored == "bfloat16" else None))
    return t.to(device=device, dtype=dt)


def _atomic_write(path, write, crash=False):
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    if crash:
        # the injected death: the temp exists, the rename never happens
        from .resilience import faults

        raise faults.InjectedFault("ckpt_crash during save of %r" % path)
    os.replace(tmp, path)


def save_arrays(dirname, arrays):
    """Per-var `<name>.npy` of a name -> array/tensor dict, each with its
    `<name>.npy.dtype` sidecar, written atomically (the layout load_vars
    reads; also the pserver's shard checkpoint and the manifest
    checkpoint's payload). The `ckpt_crash` fault is drawn once a call and
    fires between the first temp write and its rename: the torn state a
    checkpoint's verification must skip."""
    from .resilience import faults

    os.makedirs(dirname, exist_ok=True)
    crash_now = faults.fires("ckpt_crash")
    dirs_touched = set()
    for name, val in arrays.items():
        arr, orig_dtype = _to_numpy(val)
        path = os.path.join(dirname, name + ".npy")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _atomic_write(path, lambda f: np.save(f, arr), crash_now)
        _atomic_write(path + ".dtype", lambda f: f.write((orig_dtype or "").encode()))
        dirs_touched.add(os.path.dirname(path))
    for d in sorted(dirs_touched):
        fsync_dir(d)


def load_arrays(dirname):
    """Inverse of save_arrays: every `<name>.npy` under dirname (names may
    hold path separators) as a CPU tensor, bf16 where its sidecar or a
    legacy meta says so; orphaned atomic-write temps are skipped."""
    meta = _load_dtype_meta(dirname)
    out = {}
    for root, _dirs, files in os.walk(dirname):
        for fname in sorted(files):
            if not fname.endswith(".npy") or ".tmp." in fname:
                continue
            path = os.path.join(root, fname)
            name = os.path.relpath(path, dirname)[: -len(".npy")]
            out[name] = _to_tensor(np.load(path), _stored_dtype(dirname, name, meta), "cpu")
    return out


def _load_dtype_meta(dirname):
    """Merge every legacy `__dtypes__*.json` in dirname into a name -> dtype
    map (sidecars, checked first by _stored_dtype, win over it)."""
    meta = {}
    try:
        names = sorted(os.listdir(dirname))
    except OSError:
        return meta
    for fname in names:
        if fname.startswith("__dtypes__") and fname.endswith(".json"):
            try:
                with open(os.path.join(dirname, fname)) as f:
                    meta.update(json.load(f))
            except (OSError, ValueError):
                continue  # a torn legacy meta must not fail the load
    return meta


def _stored_dtype(dirname, name, meta):
    """Recorded save dtype of `<dirname>/<name>.npy`: the sidecar, else a
    legacy meta entry."""
    try:
        with open(os.path.join(dirname, name + ".npy.dtype")) as f:
            return f.read().strip() or None
    except OSError:
        return meta.get(name)


def _var_names(program, vars, predicate):
    if vars is None:
        vars = [v for v in program.list_vars() if predicate is None or predicate(v)]
    return [v.name if isinstance(v, Variable) else str(v) for v in vars]


def save_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              filename=None):
    """Persist selected scope variables (reference io.py save_vars). Under
    a process group every rank calls: a variable a ParallelExecutor holds
    in pieces (ZeRO-1 state, an ep table, a parameter and its moments a
    sharding rule places over fsdp / tp) is all-gathered, rank 0 writes
    whole variables, and every rank returns once the files are written;
    load_vars cuts them to the pieces of whatever mesh loads them."""
    program = main_program or framework.default_main_program()
    scope = global_scope()
    arrays = {}
    for name in _var_names(program, vars, predicate):
        if scope.find_var(name) is None:
            raise RuntimeError("variable %r has no value in scope; run startup first" % name)
        arrays[name] = gathered_state(scope, name)
    if host_index() == 0:
        _write_vars(dirname, arrays, filename)
    barrier()


def _write_vars(dirname, arrays, filename):
    os.makedirs(dirname, exist_ok=True)
    if filename is None:
        save_arrays(dirname, arrays)
        return
    combined, meta = {}, {}
    for name, val in arrays.items():
        combined[name], orig_dtype = _to_numpy(val)
        if orig_dtype:
            meta[name] = orig_dtype
    np.savez(os.path.join(dirname, filename), **combined)
    # always rewritten (even empty): a stale meta would apply old dtypes
    _atomic_write(os.path.join(dirname, "__dtypes__.json"),
                  lambda f: f.write(json.dumps(meta).encode()))


def _is_param(v):
    return isinstance(v, Parameter)


def _is_persistable(v):
    return v.persistable and v.type not in (framework.VarType.RAW, framework.VarType.READER)


def save_params(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program, predicate=_is_param, filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    """Every persistable var of the program (parameters, optimizer state,
    batch_norm's running statistics, the learning rate): a training
    checkpoint."""
    return save_vars(executor, dirname, main_program, predicate=_is_persistable,
                     filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              filename=None):
    """Load variables into the current scope, as tensors on its device (an
    unbound process scope takes the executor's). A variable the scope holds
    row-sharded takes this rank's rows of the whole value."""
    program = main_program or framework.default_main_program()
    scope = global_scope()
    if executor is not None:
        scope.bind(executor.device)
    combined = None
    if filename is not None:
        if not filename.endswith(".npz"):
            filename += ".npz"
        combined = np.load(os.path.join(dirname, filename))
        try:
            with open(os.path.join(dirname, "__dtypes__.json")) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            meta = {}  # missing or torn: bf16 vars restore as their f32 payloads
    else:
        meta = _load_dtype_meta(dirname)
    for name in _var_names(program, vars, predicate):
        if combined is not None:
            arr, stored = combined[name], meta.get(name)
        else:
            arr = np.load(os.path.join(dirname, name + ".npy"))
            stored = _stored_dtype(dirname, name, meta)
        val = _to_tensor(arr, stored, scope.device)
        if name in scope.row_shards:
            reshard_state(scope, name, val)
        else:
            scope.set_var(name, val)


def load_params(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program, predicate=_is_param, filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program, predicate=_is_persistable,
                     filename=filename)


def get_inference_program(target_vars, main_program=None):
    """The program pruned to what computes `target_vars`, in test mode."""
    program = main_program or framework.default_main_program()
    if not isinstance(target_vars, (list, tuple)):
        target_vars = [target_vars]
    return program.clone(for_test=True)._prune(target_vars)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None, params_filename=None,
                         export_for_deployment=True):
    """Prune to the targets, then save the program (JSON, with the feed and
    fetch names) and the persistables it still references."""
    program = main_program or framework.default_main_program()
    if not isinstance(target_vars, (list, tuple)):
        target_vars = [target_vars]
    pruned = get_inference_program(target_vars, program)
    os.makedirs(dirname, exist_ok=True)
    doc = pruned.to_dict()
    doc["feed_var_names"] = list(feeded_var_names)
    doc["fetch_var_names"] = [t.name if isinstance(t, Variable) else str(t) for t in target_vars]
    with open(os.path.join(dirname, model_filename or MODEL_FILENAME), "w") as f:
        json.dump(doc, f)
    needed = {v.name for v in pruned.list_vars() if v.persistable}
    save_vars(
        executor, dirname, program,
        vars=[v for v in program.list_vars() if v.persistable and v.name in needed],
        filename=params_filename,
    )
    return doc["fetch_var_names"]


def inference_model_fingerprint(dirname, model_filename=None):
    """sha256 over a saved inference model's program and its parameters'
    stored dtypes (not their values): the JAX package's serving compile-cache
    identity, equal for the same directory in both packages."""
    path = os.path.join(dirname, model_filename or MODEL_FILENAME)
    h = hashlib.sha256()
    with open(path, "rb") as f:
        raw = f.read()
    h.update(raw)
    meta = _load_dtype_meta(dirname)
    program = Program.from_dict(json.loads(raw))
    for v in sorted((v for v in program.list_vars() if v.persistable), key=lambda v: v.name):
        stored = _stored_dtype(dirname, v.name, meta)
        h.update(("%s\x00%s\n" % (v.name, stored or "")).encode())
    return h.hexdigest()


def load_inference_model(dirname, executor, model_filename=None, params_filename=None):
    """Returns (program, feed_var_names, fetch_vars), the persistables
    loaded into the current scope."""
    with open(os.path.join(dirname, model_filename or MODEL_FILENAME)) as f:
        doc = json.load(f)
    program = Program.from_dict(doc)
    load_vars(executor, dirname, program,
              vars=[v for v in program.list_vars() if v.persistable],
              filename=params_filename)
    fetch_vars = [program.global_block().var(n) for n in doc.get("fetch_var_names", [])]
    return program, doc.get("feed_var_names", []), fetch_vars
