"""The port's parallelism package (the counterpart of paddle_tpu/parallel/).

The JAX package maps the reference's parallelism (SURVEY.md §2.2, §2.7) onto
one program jitted over a jax.sharding Mesh. The port runs one process per
device on torch.distributed (NCCL on the cards, gloo on the CPU) with the
collectives written out:

- data parallel (dp): the batch split over ranks, replicated parameters,
  gradients averaged in coalesced buckets (parallel_executor.py), or the
  ZeRO-1 tier (ReduceStrategy.Reduce);
- sequence / context parallel (sp): ring attention over the flash kernels
  (ring_attention.py);
- embedding parallel (ep): row-sharded tables with an all-reduce combine
  (embedding/, sharded_embedding.py);
- multi-host: init_distributed over the launcher's environment
  (multihost.py), in place of the reference's gen_nccl_id rendezvous.

fsdp and tp (the sharding rules) and pp (the pipeline) come with ROADMAP
A6b: a mesh or a ParallelExecutor that gives one of them an extent above 1
raises, naming A6b. `shard_parameter` records a layout on a parameter; the
port takes a row layout (axis, None) over ep (the EmbeddingEngine's), and a
spec naming tp or fsdp raises at the ParallelExecutor.
"""

from . import collectives
from .mesh import Mesh, MeshConfig, make_mesh
from .multihost import init_distributed
from .ring_attention import ring_attention

__all__ = [
    "Mesh",
    "MeshConfig",
    "make_mesh",
    "init_distributed",
    "ring_attention",
    "collectives",
    "shard_parameter",
]


def shard_parameter(param, spec):
    """Annotate a Parameter with a PartitionSpec-like tuple (e.g. ("ep",
    None)) that the ParallelExecutor applies instead of the default
    replication."""
    param.sharding_spec = tuple(spec)
    return param
