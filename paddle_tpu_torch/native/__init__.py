"""ctypes bindings for the native host runtime (src/native.cc): RecordIO
container, bounded blocking record queue, multi-slot text data feed.

The reference keeps these in C++ (recordio/, operators/reader/
lod_tensor_blocking_queue.h, framework/data_feed.cc) because they sit on the
hot host path: file IO and parsing must overlap device compute. Same
decision here: C++ threads parse and decompress while the card runs; Python
only sees packed numpy buffers. src/native.cc is the JAX package's source,
unchanged, so both packages read and write the same files.

The shared library is built with g++ at first use (`lib()`), from the source
in this checkout, into paddle_tpu_torch/_build/ under a name that carries a
hash of the source and the command line, so an edited source never loads a
stale build. The build writes a temporary file and renames it into place:
processes that race it (pytest workers, decode workers) never dlopen a
half-written library. A failed build raises; nothing falls back to Python.
On a machine with the zlib runtime but no <zlib.h>, the build declares the
entry points it uses from src/zlib_decls/ and links libz.so.1 by its file
name (`build_log` records the command line that built the library).
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "native.cc")
_ZLIB_DECLS = os.path.join(_DIR, "src", "zlib_decls")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared"]

_lib = None
_lib_lock = threading.Lock()
build_log = {}  # "cmd": the g++ command line of this process's build, "zlib": where zlib came from


def _has_zlib_header():
    probe = subprocess.run(["g++", "-x", "c++", "-fsyntax-only", "-"],
                           input="#include <zlib.h>\n", capture_output=True, text=True)
    return probe.returncode == 0


def _zlib_args():
    """(include flags, link flags, what they name): the system's header and
    -lz, or, without the header, the declarations of src/zlib_decls/ and
    libz.so.1 by its file name (the runtime library that Python's own zlib
    module loads)."""
    if _has_zlib_header():
        return [], ["-lz"], "system <zlib.h>, -lz"
    return ["-I", _ZLIB_DECLS], ["-l:libz.so.1"], "src/zlib_decls/zlib.h, -l:libz.so.1"


def _lib_path(tag):
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(_FLAGS).encode())
    digest.update(tag.encode())
    return os.path.join(_BUILD_DIR, "libptnative-%s.so" % digest.hexdigest()[:16])


def _build(path, inc, link, where):
    # compile to a temp path and rename into place: concurrent processes
    # (pytest workers, multi-process trainers) may race the build, and a
    # half-written .so must never be dlopen-able
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (path, os.getpid())
    cmd = ["g++"] + _FLAGS + inc + ["-o", tmp, _SRC] + link + ["-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            "native runtime build failed (%s):\n%s" % (" ".join(cmd), proc.stderr)
        )
    os.replace(tmp, path)
    build_log.update(cmd=" ".join(cmd), zlib=where)


def _declare(L):
    L.rio_writer_open.restype = ctypes.c_void_p
    L.rio_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_long, ctypes.c_long]
    L.rio_writer_write.restype = ctypes.c_int
    L.rio_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long]
    L.rio_writer_close.restype = ctypes.c_int
    L.rio_writer_close.argtypes = [ctypes.c_void_p]
    L.rio_scanner_open.restype = ctypes.c_void_p
    L.rio_scanner_open.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_long]
    L.rio_scanner_next.restype = ctypes.c_long
    L.rio_scanner_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p)]
    L.rio_scanner_close.argtypes = [ctypes.c_void_p]
    L.rio_chunk_offsets.restype = ctypes.c_long
    L.rio_chunk_offsets.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
                                    ctypes.c_long]
    L.bq_create.restype = ctypes.c_void_p
    L.bq_create.argtypes = [ctypes.c_long]
    L.bq_push.restype = ctypes.c_int
    L.bq_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long]
    L.bq_pop.restype = ctypes.c_long
    L.bq_pop.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p)]
    L.bq_free.argtypes = [ctypes.c_char_p]
    L.bq_close.argtypes = [ctypes.c_void_p]
    L.bq_size.restype = ctypes.c_long
    L.bq_size.argtypes = [ctypes.c_void_p]
    L.bq_destroy.argtypes = [ctypes.c_void_p]
    L.msdf_create.restype = ctypes.c_void_p
    L.msdf_create.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    L.msdf_start.restype = ctypes.c_int
    L.msdf_start.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                             ctypes.c_int, ctypes.c_void_p]
    L.msdf_join.restype = ctypes.c_long
    L.msdf_join.argtypes = [ctypes.c_void_p]
    L.msdf_file_errors.restype = ctypes.c_long
    L.msdf_file_errors.argtypes = [ctypes.c_void_p]
    L.msdf_destroy.argtypes = [ctypes.c_void_p]
    return L


def lib():
    """The bound library, built at the first call of this checkout's source."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            inc, link, where = _zlib_args()
            path = _lib_path(" ".join(inc + link))
            if not os.path.exists(path):
                _build(path, inc, link, where)
            else:
                build_log.setdefault("zlib", where)
            _lib = _declare(ctypes.CDLL(path))
    return _lib


NO_COMPRESS = 0
ZLIB = 1


class RecordIOWriter:
    """Chunked, CRC-checked, compressed record container (reference
    recordio/writer.{h,cc})."""

    def __init__(self, path, compressor=ZLIB, max_records=1000, max_bytes=0):
        self._h = lib().rio_writer_open(
            path.encode(), compressor, max_records, max_bytes
        )
        if not self._h:
            raise IOError("cannot open %r for writing" % path)

    def write(self, data):
        if self._h is None:
            raise ValueError("writer is closed")
        if isinstance(data, str):
            data = data.encode()
        if lib().rio_writer_write(self._h, data, len(data)) != 0:
            raise IOError("recordio write failed")

    def close(self):
        if self._h:
            rc = lib().rio_writer_close(self._h)
            self._h = None
            if rc != 0:
                raise IOError("recordio flush-on-close failed")

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class RecordIOScanner:
    """Sequential record reader over a byte range [begin, end) of chunk
    starts — the sharding contract the Go master used for task dispatch
    (reference recordio/scanner.{h,cc}, go/master/service.go:69)."""

    def __init__(self, path, begin=0, end=-1):
        self._h = lib().rio_scanner_open(path.encode(), begin, end)
        if not self._h:
            raise IOError("cannot open %r" % path)

    def __iter__(self):
        out = ctypes.c_char_p()
        while True:
            if self._h is None:
                raise ValueError("scanner is closed")
            n = lib().rio_scanner_next(self._h, ctypes.byref(out))
            if n == -1:
                return
            if n == -2:
                raise IOError("corrupt recordio chunk (CRC/format mismatch)")
            yield ctypes.string_at(out, n)

    def close(self):
        if self._h:
            lib().rio_scanner_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def chunk_offsets(path):
    """Byte offsets of every chunk in the file (for range sharding)."""
    L = lib()
    n = L.rio_chunk_offsets(path.encode(), None, 0)
    if n < 0:
        raise IOError("cannot index %r (missing or corrupt)" % path)
    buf = (ctypes.c_long * n)()
    L.rio_chunk_offsets(path.encode(), buf, n)
    return list(buf)


class NativeBlockingQueue:
    """Bounded producer/consumer byte-record queue (reference
    LoDTensorBlockingQueue). Push/pop release the GIL inside the native call,
    so C++ feed threads and Python consumers overlap."""

    def __init__(self, capacity):
        self._h = lib().bq_create(capacity)

    def push(self, data):
        if isinstance(data, str):
            data = data.encode()
        return lib().bq_push(self._h, data, len(data)) == 0

    def pop(self):
        out = ctypes.c_char_p()
        n = lib().bq_pop(self._h, ctypes.byref(out))
        if n < 0:
            return None
        data = ctypes.string_at(out, n)
        lib().bq_free(out)
        return data

    def close(self):
        lib().bq_close(self._h)

    def size(self):
        return lib().bq_size(self._h)

    def __del__(self):
        try:
            if self._h:
                lib().bq_destroy(self._h)
                self._h = None
        except Exception:
            pass


INT64_SLOT = 0
FLOAT32_SLOT = 1


def unpack_sample(data):
    """Decode one packed multi-slot sample into a list of numpy arrays
    (layout documented at src/native.cc MultiSlotFeed)."""
    nslots = int(np.frombuffer(data, np.uint32, 1, 0)[0])
    pos = 4
    out = []
    for _ in range(nslots):
        t = data[pos]
        n = int(np.frombuffer(data, np.uint32, 1, pos + 1)[0])
        pos += 5
        if t == INT64_SLOT:
            out.append(np.frombuffer(data, np.int64, n, pos).copy())
            pos += 8 * n
        else:
            out.append(np.frombuffer(data, np.float32, n, pos).copy())
            pos += 4 * n
    return out


class MultiSlotDataFeed:
    """N native threads parse slot-format text files into a native queue
    (reference framework/data_feed.cc MultiSlotDataFeed + the AsyncExecutor
    file-shard work list)."""

    def __init__(self, slot_types, queue_capacity=512):
        arr = (ctypes.c_uint8 * len(slot_types))(*slot_types)
        self._h = lib().msdf_create(arr, len(slot_types))
        self.queue = NativeBlockingQueue(queue_capacity)
        self._started = False

    def start(self, files, nthreads=4):
        if self._started:
            raise RuntimeError("feed already started")
        enc = [f.encode() for f in files]
        arr = (ctypes.c_char_p * len(enc))(*enc)
        rc = lib().msdf_start(self._h, arr, len(enc), nthreads, self.queue._h)
        if rc != 0:
            raise RuntimeError("feed start failed")
        self._started = True
        # closer thread: when all workers drain the file list, close the
        # queue so consumers see EOF
        def closer():
            self.errors = lib().msdf_join(self._h)
            self.queue.close()

        self.errors = 0
        self._closer = threading.Thread(target=closer, daemon=True)
        self._closer.start()

    def __iter__(self):
        while True:
            data = self.queue.pop()
            if data is None:
                return
            yield unpack_sample(data)

    def join(self):
        if self._started:
            self._closer.join()
        return self.errors

    def file_errors(self):
        """Count of shard files that could not be opened at all."""
        return lib().msdf_file_errors(self._h) if self._h else 0

    def __del__(self):
        # order matters: close the queue (unblocks workers stuck on push),
        # join workers via the closer, only then free the native object —
        # destroying with joinable std::threads would terminate the process
        try:
            if self._started:
                self.queue.close()
                self.join()
            if self._h:
                lib().msdf_destroy(self._h)
                self._h = None
        except Exception:
            pass
