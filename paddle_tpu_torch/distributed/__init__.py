"""Distributed runtime: socket RPC, the parameter-shard serving loop and the
dataset task master (the JAX package's distributed/, on torch).

Reference analog: paddle/fluid/operators/distributed/. The collective path
(data, tensor, pipeline parallelism over torch.distributed) lives in
parallel/; this package is the host-side RPC tier of the pserver transpile
mode (transpiler/distribute_transpiler.py, ops/dist_ops.py), whose pservers
run their optimizer blocks on their own device.
"""

from .rpc import RPCClient, RPCServer  # noqa: F401

from . import master  # noqa: F401
from .master import Master, MasterClient  # noqa: F401
from .rpc import CollectiveClient  # noqa: F401
