"""Build and load the hand-written CUDA kernels of ops/csrc/.

Each source `csrc/<stem>.cu` has a plain C interface. It is compiled with
`nvcc` for sm_90a at first use, from the source in this checkout, into
paddle_tpu_torch/_build/ as a shared library and loaded with ctypes. The
library name carries a hash of the source, the headers of csrc/ and the
flags, so an edited kernel never loads a stale build. Each wrapper module
registers its source and the function that declares its ctypes signatures
at import (no I/O); `load` builds one library at its first launch, and
`build_all` starts one nvcc per registered source at once, so the kernels of
a run build in parallel. A box without a compiler imports the package.

`arrival_counters` holds the int32 counters with which a kernel's last CTA
of a group finds itself (the fused flash backward's dQ sum, the paged
kernels' merges, the layer_norm backward's column sums): one zeroed buffer
per (device, stream), which every such launch leaves at 0 again, so kernels
ordered on one stream share it. A CUDA graph's kernels keep the counters of
the stream they were captured on (made by the warmup run there), whatever
stream the graph is replayed on.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["NVCC_FLAGS", "arrival_counters", "build_all", "build_logs", "load", "register"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_HERE, "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_binders = {}  # stem -> bind(lib), declaring the library's ctypes signatures
_libs = {}  # stem -> bound ctypes library
_lock = threading.Lock()
build_logs = {}  # stem -> nvcc's output of the build this process made (ptxas -v)


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (CUDA_HOME=%r)" % CUDA_HOME)


def _so_path(stem):
    # the source, every header of csrc/ (a header a source includes changes
    # its build) and the flags
    names = [stem + ".cu"] + sorted(n for n in os.listdir(_SRC_DIR) if n.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in names:
        with open(os.path.join(_SRC_DIR, name), "rb") as f:
            digest.update(f.read())
    tag = digest.hexdigest()[:16]
    return os.path.join(_BUILD_DIR, "lib%s-%s.so" % (stem, tag))


def _compile(stems):
    """Compile the sources whose libraries are missing, one nvcc process
    each, all running at once. Raises with nvcc's output on a failure."""
    todo = [(s, _so_path(s)) for s in stems if not os.path.exists(_so_path(s))]
    if not todo:
        return
    os.makedirs(_BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for stem, so in todo:
        tmp = "%s.%d.tmp" % (so, os.getpid())
        src = os.path.join(_SRC_DIR, stem + ".cu")
        procs.append((stem, so, tmp, subprocess.Popen(
            [nvcc] + NVCC_FLAGS + ["-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for stem, so, tmp, proc in procs:
        build_logs[stem] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(stem)
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for %s:\n%s" % (
            failed, "\n".join(build_logs[s] for s in failed)))


def register(stem, bind):
    """Declare csrc/<stem>.cu and its `bind(lib)`, which sets argtypes and
    restype of every function its wrapper calls."""
    _binders[stem] = bind


def load(stem):
    """The bound library of csrc/<stem>.cu, built if needed."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            _compile([stem])
            lib = ctypes.CDLL(_so_path(stem))
            _binders[stem](lib)
            _libs[stem] = lib
        return lib


def build_all():
    """Compile every registered source in parallel, then load and bind each
    library. Returns {stem: library}."""
    with _lock:
        _compile([s for s in _binders if s not in _libs])
    return {stem: load(stem) for stem in list(_binders)}


_counters = {}  # (device, stream) -> int32 arrival counters, all 0 between launches


def arrival_counters(device, stream, n):
    """At least n int32 arrival counters on `device` for kernels launched on
    `stream`, all 0 (each launch that counts resets what it used). They are
    made outside any CUDA graph capture: a graph's kernels take the counters
    its warmup run made on the capture stream, and a capture that would have
    to make or grow them raises."""
    import torch

    key = (device, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "arrival counters for %d groups on stream %#x are made during a CUDA "
                "graph capture: run the block once on the capture stream first" % (n, stream))
        buf = _counters[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return buf
