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
    append_batch_size the leading dim is -1 and resolved at feed time."""
    if lod_level:
        raise NotImplementedError(
            "ragged (lod_level > 0) feeds are ported with the sequence ops"
        )
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return framework.default_main_program().current_block().create_var(
        name=name,
        shape=shape,
        dtype=dtype,
        type=type,
        stop_gradient=stop_gradient,
        lod_level=lod_level,
        is_data=True,
    )
