"""AsyncExecutor: file-sharded multi-slot training driven by the native feed.

Reference analog: framework/async_executor.{h,cc} + executor_thread_worker —
N CPU threads, each interpreting the whole program per-sample over its shard
of a file list, sharing parameters Hogwild-style; python surface
async_executor.py AsyncExecutor.run(program, data_feed, filelist, thread_num,
fetch_list).

The JAX package's redesign, on the card: per-sample per-thread
interpretation wastes the device — instead the C++ feed threads
(native.MultiSlotDataFeed) parse the file list concurrently into the native
blocking queue, the host assembles fixed-shape batches (sparse slots padded
to a bucketed length with padding_idx ids), a PyReader stages the next one
on the card while the current step runs, and ONE block consumes them at
full batch width through Executor.run. thread_num maps to parser threads.
Each bucketed width is a feed shape of its own: the executor prepares and
captures a CUDA graph for each (Executor.stats()["graphs"]), and keeps them
all.
"""

import numpy as np
import torch

from . import framework, native
from .executor import Executor, global_scope

__all__ = ["AsyncExecutor", "stream_batches"]


def _first(value):
    """The first element of a fetched value (a tensor on any device, or an
    array) as a Python float."""
    if isinstance(value, torch.Tensor):
        value = value.detach().reshape(-1)[:1].float().cpu().numpy()
    return float(np.asarray(value).reshape(-1)[0])


def _bucket(n, buckets=(1, 2, 4, 8, 16, 32, 64, 128)):
    for b in buckets:
        if n <= b:
            return b
    return ((n + 127) // 128) * 128


def _assemble_batch(batch, used):
    """Pack samples into fixed-shape arrays: dense float slots stack to
    (b, dim); sparse id slots pad to a bucketed max length with -1
    (= lookup_table padding_idx, zero vector) so the executor sees few
    feed shapes."""
    feeds = {}
    for slot_idx, slot in used:
        cols = [sample[slot_idx] for sample in batch]
        if slot.type == "float":
            dim = max(len(c) for c in cols)
            arr = np.zeros((len(cols), dim), np.float32)
            for i, c in enumerate(cols):
                arr[i, : len(c)] = c
        else:
            width = _bucket(max(len(c) for c in cols))
            arr = np.full((len(cols), width), -1, np.int64)
            for i, c in enumerate(cols):
                arr[i, : len(c)] = c
        feeds[slot.name] = arr
    return feeds


def _batches_of(samples, batch_size, used):
    """Assembled batches of `batch_size` parsed samples each (the last one
    shorter) off an iterable of samples, as the native feed yields them."""
    batch = []
    for sample in samples:
        batch.append(sample)
        if len(batch) == batch_size:
            yield _assemble_batch(batch, used)
            batch = []
    if batch:
        yield _assemble_batch(batch, used)


def stream_batches(data_feed, filelist, thread_num=1, loop=False):
    """Yield assembled feed dicts (name -> fixed-shape array) straight off
    the native multi-slot feed — the unbounded-stream source an
    online.OnlineTrainer consumes. `loop=True` restarts the file list each
    time it drains, turning a finite clickstream dump into an endless
    stream (each pass is a new feed instance, so file errors still raise
    per pass)."""
    used = data_feed.used_slots()
    if not used:
        raise ValueError("data_feed has no used slots (set_use_slots)")
    bs = data_feed.batch_size
    while True:
        feed = native.MultiSlotDataFeed(
            data_feed.native_slot_types(), queue_capacity=4 * bs
        )
        feed.start(list(filelist), nthreads=max(1, int(thread_num)))
        yield from _batches_of(feed, bs, used)
        feed.join()
        if feed.file_errors():
            raise IOError(
                "stream_batches: %d input files could not be opened"
                % feed.file_errors()
            )
        if not loop:
            return


class _FileShardDecode:
    """DataRuntime decode_fn for the async filelist: shard = one input
    file, parsed by the native feed (nthreads=1 inside the worker — the
    parallelism IS the worker pool) and assembled into fixed-shape batches.
    Deterministic per shard (single file, single parser thread), which the
    crash-replay contract requires; module-level so it pickles under
    spawn."""

    def __init__(self, files, slot_types, used, batch_size):
        self.files = list(files)
        self.slot_types = slot_types
        self.used = list(used)
        self.batch_size = int(batch_size)

    def __call__(self, shard_id):
        from . import native

        fname = self.files[shard_id]
        feed = native.MultiSlotDataFeed(
            self.slot_types, queue_capacity=4 * self.batch_size
        )
        feed.start([fname], nthreads=1)
        yield from _batches_of(feed, self.batch_size, self.used)
        feed.join()
        if feed.file_errors():
            raise IOError(
                "async feed: input file %r could not be opened" % fname
            )


class AsyncExecutor:
    def __init__(self, place=None):
        self.place = place
        self.executor = Executor(place)

    def run(
        self,
        program,
        data_feed,
        filelist,
        thread_num,
        fetch,
        debug=False,
        print_period=100,
        num_workers=None,
    ):
        """Train over `filelist` until the feed drains. `fetch` vars are
        averaged per print period (reference async_executor.py:run / the
        worker's PrintFetchVars). Returns the list of per-period means of the
        first fetch var.

        num_workers > 0 (or FLAGS_data_num_workers) rides the native data
        runtime (data/): each input file is a shard decoded by a
        worker PROCESS — parse, batch assembly, and padding all leave the
        trainer process, batches cross a shared-memory ring, and a killed
        worker's files replay without sample loss. Batches then pad
        per-file rather than globally (the last partial batch is per file).
        Default (0) keeps the in-process native feed threads."""
        if isinstance(fetch, (str, framework.Variable)):
            fetch = [fetch]
        fetch_names = [
            f.name if isinstance(f, framework.Variable) else str(f) for f in fetch
        ]
        used = data_feed.used_slots()
        if not used:
            raise ValueError("data_feed has no used slots (set_use_slots)")
        feed_vars = []
        block = program.global_block()
        for _, slot in used:
            if slot.name not in block.vars:
                raise ValueError(
                    "program has no var for used slot %r" % slot.name
                )
            feed_vars.append(block.vars[slot.name])

        bs = data_feed.batch_size
        period_vals = []
        results = []
        step = 0

        def flush(step):
            # fetches stay device-resident until here — converting per step
            # would sync the pipeline every iteration
            if not period_vals:
                return
            host = [[_first(v) for v in vals] for vals in period_vals]
            means = np.mean(np.asarray(host), axis=0)
            results.append(float(means[0]))
            if debug:
                print(
                    "step %d: %s"
                    % (
                        step,
                        ", ".join(
                            "%s=%.6f" % (n, m)
                            for n, m in zip(fetch_names, means)
                        ),
                    )
                )
            period_vals.clear()

        def consume(feeds_iter):
            nonlocal step
            for feeds in feeds_iter:
                vals = self.executor.run(
                    program,
                    feed=feeds,
                    fetch_list=fetch_names,
                    scope=global_scope(),
                    return_numpy=False,
                )
                step += 1
                period_vals.append(list(vals))
                if step % print_period == 0:
                    flush(step)

        if num_workers is None:
            from .flags import get_flags

            num_workers = int(get_flags()["data_num_workers"])
        num_workers = int(num_workers or 0)

        if num_workers > 0:
            # native data runtime path: shard = file, decoded out-of-process
            from .data import DataRuntime

            files = list(filelist)
            decode = _FileShardDecode(
                files, data_feed.native_slot_types(), used, bs
            )
            rt = DataRuntime(
                decode,
                num_shards=len(files),
                num_workers=min(num_workers, max(1, len(files))),
                shuffle=False,  # filelist order is the shard order
                name="asyncexec",
                place=self.executor.device,
            )
            rt.start()
            try:
                consume(rt())
            finally:
                rt.close()
            flush(step)
            return results

        feed = native.MultiSlotDataFeed(
            data_feed.native_slot_types(), queue_capacity=4 * bs
        )
        feed.start(list(filelist), nthreads=max(1, int(thread_num)))

        # double buffering (reference operators/reader/buffered_reader.h:48):
        # a PyReader staging thread assembles the NEXT batch and copies it
        # to the card on its copy stream while the current step runs
        from .py_reader import PyReader

        staging = PyReader([v.name for v in feed_vars], capacity=2,
                           place=self.executor.device)
        # num_workers=0 pins the in-process staging thread: `batches`
        # closes over the live native feed and cannot move to a process
        staging.decorate_tensor_provider(lambda: _batches_of(feed, bs, used), num_workers=0)
        staging.start()
        try:
            consume(staging())
        finally:
            staging.reset()
        flush(step)
        errors = feed.join()
        missing = feed.file_errors()
        if missing:
            raise IOError(
                "async feed: %d of %d input files could not be opened"
                % (missing, len(filelist))
            )
        if errors and debug:
            print("async feed: %d unparseable lines skipped" % errors)
        return results
