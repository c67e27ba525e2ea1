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
- tensor and fully sharded parallelism (tp, fsdp): declarative sharding
  rules (sharding_rules.py) place parameters and their optimizer state as
  each rank's pieces, the Megatron pair runs on pieces over tp, any other
  op gathers them (FSDP);
- pipeline parallelism (pp): the GPipe and 1F1B schedules (pipeline.py)
  over stages cut by device_guard or the balanced partition
  (partition.py), run by the ParallelExecutor's pipelined block, and the
  homogeneous stack's `gpipe`;
- multi-host: init_distributed over the launcher's environment
  (multihost.py), in place of the reference's gen_nccl_id rendezvous.

`shard_parameter` records a layout on a parameter, which the Resolver
takes under the rules (a row layout (axis, None) over ep is the
EmbeddingEngine's; one over fsdp / tp a rule's).
"""

from . import collectives, partition, pipeline, sharding_rules
from .mesh import Mesh, MeshConfig, make_mesh
from .multihost import init_distributed
from .pipeline import analytic_bubble, gpipe
from .ring_attention import ring_attention
from .sharding_rules import ShardingRules, SpecLayout, program_rules

__all__ = [
    "Mesh",
    "MeshConfig",
    "make_mesh",
    "init_distributed",
    "ring_attention",
    "collectives",
    "partition",
    "pipeline",
    "gpipe",
    "analytic_bubble",
    "shard_parameter",
    "sharding_rules",
    "ShardingRules",
    "SpecLayout",
    "program_rules",
]


def shard_parameter(param, spec):
    """Annotate a Parameter with a PartitionSpec-like tuple (e.g. (None,
    "tp") or ("ep", None)) that the ParallelExecutor applies instead of the
    default replication (the Resolver's legacy layer, under the rules)."""
    param.sharding_spec = tuple(spec)
    return param
