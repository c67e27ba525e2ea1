"""Data-layer entry point (reference python/paddle/fluid/layers/io.py:39
`data`). The JAX package's py_reader / read_file / double_buffer pipeline
is ported with the data runtime."""

from .. import framework
from ..framework import VarType

__all__ = ["data"]


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
