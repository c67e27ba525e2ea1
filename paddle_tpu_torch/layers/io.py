"""Data-layer entry points (reference python/paddle/fluid/layers/io.py:39
`data`, :633 `py_reader`, read_file, double_buffer): feed variables, and the
program readers the Executor pulls staged batches from when run() gets no
feed."""

from .. import framework, unique_name
from ..framework import VarType
from ..place import to_device

__all__ = ["data", "py_reader", "read_file", "double_buffer", "batch", "shuffle"]


def data(
    name,
    shape,
    append_batch_size=True,
    dtype="float32",
    lod_level=0,
    type=VarType.LOD_TENSOR,
    stop_gradient=True,
):
    """Declare a feed variable (reference layers/io.py:39). With
    append_batch_size the leading dim is -1 and resolved at feed time.

    A ragged field (lod_level > 0) is padded dense, (batch, time, *shape),
    with a companion `<name>@LEN` int32 length vector that the DataFeeder
    fills and the sequence layers read (the variable's `_len_name`). With
    append_batch_size=False the shape already leads with the batch dim, and
    the time dim goes after it."""
    block = framework.default_main_program().current_block()
    shape = list(shape)
    if lod_level and lod_level > 0:
        shape = [-1, -1] + shape if append_batch_size else shape[:1] + [-1] + shape[1:]
    elif append_batch_size:
        shape = [-1] + shape
    v = block.create_var(
        name=name,
        shape=shape,
        dtype=dtype,
        type=type,
        stop_gradient=stop_gradient,
        lod_level=lod_level,
        is_data=True,
    )
    if lod_level and lod_level > 0:
        lv = block.create_var(
            name=name + "@LEN", shape=[-1], dtype="int32", stop_gradient=True, is_data=True
        )
        v._len_name = lv.name
    return v


class GraphPyReader:
    """The graph-side handle returned by layers.py_reader (reference
    layers/io.py:633): owns the feed variables and the async device-prefetch
    queue; the Executor pulls staged batches from it when run() gets no feed.
    Batches are staged on the device of the executor that last ran its
    program or its startup program (executor._place_readers), as the
    reference's reader takes the place of the executor that runs its
    startup program; CUDAPlace(0) when none has yet. A pull by an executor
    on another device raises."""

    def __init__(self, capacity, shapes, dtypes, lod_levels=None, name=None,
                 use_double_buffer=True):
        program = framework.default_main_program()
        name = name or unique_name.generate("py_reader")
        lod_levels = lod_levels or [0] * len(shapes)
        slots = []
        for i, (shape, dtype, lod) in enumerate(zip(shapes, dtypes, lod_levels)):
            slots.append(program.current_block().create_var(
                name="%s_slot_%d" % (name, i),
                shape=list(shape),
                dtype=dtype,
                lod_level=lod,
                is_data=True,
                stop_gradient=True,
            ))
        self._attach(name, slots, capacity, use_double_buffer)

    def _attach(self, name, slots, capacity, use_double_buffer=True):
        """Bind the slot variables to a PyReader and register the handle
        with the main program (its pulls) and the startup program (its
        device)."""
        from ..place import CPUPlace
        from ..py_reader import PyReader

        self.name = name
        self.vars = list(slots)
        # CPUPlace until an executor gives the device (_take_place) or
        # start() takes CUDAPlace(0)
        self._impl = PyReader([v.name for v in self.vars], capacity=capacity,
                              return_device_arrays=use_double_buffer, place=CPUPlace())
        self._placed = False
        for program, attr in ((framework.default_main_program(), "_py_readers"),
                              (framework.default_startup_program(), "_startup_readers")):
            vars(program).setdefault(attr, []).append(self)

    def _take_place(self, device):
        """Stage on `device` from the next start() (executor._place_readers)."""
        self._impl.set_place(device)
        self._placed = True

    # delegate lifecycle to the async impl (num_workers: the native data
    # runtime — multiprocess decode + shm ring + device double-buffer)
    def decorate_paddle_reader(self, reader, places=None, num_workers=None,
                               num_shards=None):
        from ..data_feeder import DataFeeder

        self._impl.set_feeder(DataFeeder(self.vars))
        self._impl.decorate_paddle_reader(
            reader, num_workers=num_workers, num_shards=num_shards
        )
        self._impl._batched_tuples = False  # the DataFeeder assembles rows
        return self

    def decorate_tensor_provider(self, reader, num_workers=None,
                                 num_shards=None):
        return self._impl.decorate_tensor_provider(
            reader, num_workers=num_workers, num_shards=num_shards
        )

    def decorate_batch_generator(self, reader, places=None, num_workers=None,
                                 num_shards=None):
        return self._impl.decorate_batch_generator(
            reader, num_workers=num_workers, num_shards=num_shards
        )

    def set_device_sharding(self, sharding):
        return self._impl.set_device_sharding(sharding)

    def push_back(self, batch):
        return self._impl.push_back(batch)

    def start(self):
        if not self._placed:
            self._take_place(to_device(None))  # no executor has run its programs yet
        return self._impl.start()

    def reset(self):
        return self._impl.reset()

    def close(self):
        return self._impl.close()

    def next_batch(self):
        return self._impl.next_batch()

    @property
    def started(self):
        return self._impl._started

    @property
    def staged_on(self):
        return self._impl.staged_on

    # the executor's deferred-EOF flag (executor._pull_reader_steps) must
    # live on the impl so start()/reset() clear it with the epoch state
    @property
    def _eof_deferred(self):
        return self._impl._eof_deferred

    @_eof_deferred.setter
    def _eof_deferred(self, value):
        self._impl._eof_deferred = value


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    return GraphPyReader(capacity, shapes, dtypes, lod_levels, name,
                         use_double_buffer)


def read_file(reader):
    """Unpack a py_reader's slots into variables (reference layers/io.py
    read_file → read_op)."""
    if len(reader.vars) == 1:
        return reader.vars[0]
    return list(reader.vars)


def double_buffer(reader, place=None, name=None):
    """compat: prefetch-to-device is built into py_reader already"""
    return reader


def batch(reader, batch_size):
    """compat alias for paddle.batch on a reader creator"""
    from ..batch import batch as _batch

    return _batch(reader, batch_size)


def shuffle(reader, buffer_size):
    from .. import reader as reader_mod

    return reader_mod.shuffle(reader, buffer_size)
