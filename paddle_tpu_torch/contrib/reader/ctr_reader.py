"""CTR file reader: async multi-threaded slot-file parsing into the program.

Reference analog: contrib/reader/ctr_reader.py — a `create_ctr_reader` op
whose C++ threads parse CTR slot files and push LoDTensor batches into a
blocking queue the program's read op pops. Here the same pipeline is built
from the port's pieces: the native C++ MultiSlotDataFeed parser threads
(paddle_tpu_torch/native, gzip-transparent), the AsyncExecutor's
fixed-shape batch assembly (bucketed padding, so the executor sees few feed
shapes), and a PyReader staging thread that copies the next batch to the
card while the current step runs (on the device of the executor that runs
its startup program, as layers.py_reader does). The returned reader binds its slot variables into the program;
`Executor.run` with no feed pops staged batches exactly like layers.py_reader.
"""

from ... import framework, native
from ...async_executor import _batches_of
from ...data_feed_desc import DataFeedDesc
from ...layers.io import GraphPyReader

__all__ = ["ctr_reader"]


class _CtrReader(GraphPyReader):
    """Handle with the reference reader lifecycle: start() begins the parse
    threads + staging; reset() tears down for the next pass; `vars` are the
    per-slot variables for the model to consume. The rest (the pull,
    push_back, the deferred EOF, the device) is GraphPyReader's."""

    def __init__(self, data_feed, capacity, thread_num, batch_size, file_list,
                 name):
        program = framework.default_main_program()
        self._desc = data_feed
        self._thread_num = max(1, int(thread_num))
        self._files = list(file_list)
        self._used = data_feed.used_slots()
        if not self._used:
            raise ValueError("data feed desc has no used slots (set_use_slots)")
        if batch_size:
            data_feed.batch_size = int(batch_size)
        block = program.current_block()
        slots = []
        for _, slot in self._used:
            if slot.name in block.vars:
                v = block.vars[slot.name]
            else:
                dtype = "float32" if slot.type == "float" else "int64"
                v = block.create_var(
                    name=slot.name, shape=[-1, -1], dtype=dtype,
                    is_data=True, stop_gradient=True,
                )
            slots.append(v)
        self._feed = None
        self._attach(name, slots, capacity)

    def start(self):
        self._feed = native.MultiSlotDataFeed(
            self._desc.native_slot_types(),
            queue_capacity=4 * self._desc.batch_size,
        )
        self._feed.start(self._files, nthreads=self._thread_num)
        feed, bs, used = self._feed, self._desc.batch_size, self._used
        self._impl.decorate_tensor_provider(lambda: _batches_of(feed, bs, used))
        return super().start()

    def reset(self):
        super().reset()
        if self._feed is not None:
            self._feed.join()
            self._feed = None


def ctr_reader(feed_data=None, capacity=64, thread_num=4, batch_size=32,
               file_list=(), slots=None, name=None):
    """Create the CTR reader (reference contrib ctr_reader:47 signature).
    `slots` is a DataFeedDesc (or its textproto string/path) describing the
    slot schema; `feed_data` is accepted for signature parity (the reader
    creates/binds the slot variables itself, like the reference's
    `_copy_reader_var_` plumbing)."""
    desc = slots if isinstance(slots, DataFeedDesc) else DataFeedDesc(slots)
    return _CtrReader(desc, capacity, thread_num, batch_size, file_list,
                      name or "ctr_reader")
