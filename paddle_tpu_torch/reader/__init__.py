"""Reader-creator decorators (reference python/paddle/reader/decorator.py:
map_readers, shuffle, chain, compose, buffered, firstn, xmap_readers, cache).

A "reader creator" is a zero-arg callable returning a generator of samples —
the same composable protocol the reference trains everything through.
"""

import itertools
import random
import threading
import queue as Queue

from . import creator  # noqa: F401 — the np_array / text_file creators

__all__ = [
    "map_readers",
    "buffered",
    "compose",
    "chain",
    "shuffle",
    "firstn",
    "xmap_readers",
    "cache",
]


def cache(reader):
    all_data = []

    def creator():
        if not all_data:
            all_data.extend(reader())
        return iter(all_data)

    return creator


def map_readers(func, *readers):
    def creator():
        rs = [r() for r in readers]
        for items in zip(*rs):
            yield func(*items)

    return creator


def shuffle(reader, buf_size):
    def creator():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            random.shuffle(buf)
            for b in buf:
                yield b

    return creator


def chain(*readers):
    def creator():
        return itertools.chain(*[r() for r in readers])

    return creator


def compose(*readers, **kwargs):
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def creator():
        rs = [r() for r in readers]
        if check_alignment:
            for items in zip(*rs):
                yield sum((make_tuple(i) for i in items), ())
        else:
            for items in itertools.zip_longest(*rs):
                yield sum((make_tuple(i) for i in items if i is not None), ())

    return creator


def buffered(reader, size):
    """Background-thread prefetch buffer (reference decorator.py buffered)."""

    class _End:
        pass

    def creator():
        q = Queue.Queue(maxsize=size)

        def fill():
            try:
                for d in reader():
                    q.put(d)
            finally:
                q.put(_End)

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is _End:
                break
            yield e

    return creator


def firstn(reader, n):
    def creator():
        for i, item in enumerate(reader()):
            if i >= n:
                break
            yield item

    return creator


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over samples with worker threads (reference
    decorator.py xmap_readers). order=True preserves input order via
    sequence-numbered samples and a reordering buffer."""

    end = object()

    def creator():
        in_q = Queue.Queue(buffer_size)
        out_q = Queue.Queue(buffer_size)

        def read_worker():
            for i, sample in enumerate(reader()):
                in_q.put((i, sample))
            for _ in range(process_num):
                in_q.put(end)

        def map_worker():
            while True:
                s = in_q.get()
                if s is end:
                    out_q.put(end)
                    break
                i, sample = s
                out_q.put((i, mapper(sample)))

        threading.Thread(target=read_worker, daemon=True).start()
        workers = [
            threading.Thread(target=map_worker, daemon=True)
            for _ in range(process_num)
        ]
        for w in workers:
            w.start()
        finished = 0
        pending = {}
        next_idx = 0
        while finished < process_num:
            s = out_q.get()
            if s is end:
                finished += 1
                continue
            i, mapped = s
            if not order:
                yield mapped
                continue
            pending[i] = mapped
            while next_idx in pending:
                yield pending.pop(next_idx)
                next_idx += 1
        if order:
            for i in sorted(pending):
                yield pending[i]

    return creator
