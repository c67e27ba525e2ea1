"""Native data runtime: multiprocess decode workers + shared-memory ring
buffer + a staged feed that copies batch k+1 to the card on a copy stream
while step k runs.

The paper's L2 AsyncExecutor/DataFeed layer, as the JAX package rebuilt it:
decode parallelism moves to processes (the GIL owns threads), the hand-off
is a shared-memory ring of batch slabs (zero pickling of payloads), and
datasets shard per host and per worker deterministically.
``PyReader.decorate_paddle_reader(..., num_workers=N)`` is the drop-in
front end; ``DataRuntime`` is the native shard-based API; ``AsyncExecutor.run``
rides the same pool for its filelist. ``cache_epoch`` remains the opt-in
fast path for datasets that fit on the card — this runtime is for the ones
that don't.
"""

from .ring import RingBuffer, SlabOverflowError, TornSlotError
from .runtime import DataRuntime
from .sharding import epoch_shard_order, host_shards, worker_shards

__all__ = [
    "DataRuntime",
    "RingBuffer",
    "SlabOverflowError",
    "TornSlotError",
    "epoch_shard_order",
    "host_shards",
    "worker_shards",
]
