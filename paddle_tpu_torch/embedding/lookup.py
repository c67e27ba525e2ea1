"""Row-sharded embedding lookup (the forward gather + sum leg of the
engine; the counterpart of paddle_tpu/embedding/lookup.py).

Reference analog: the distributed lookup table (SURVEY.md §2.7.5), rows
fetched from parameter servers by RPC prefetch. Here the table is
row-sharded over a mesh axis: each rank holds rows [r*V/n, (r+1)*V/n),
gathers the ids it owns (any other id gives a zero row) and one all-reduce
over the axis sums the ranks' rows. Every id is owned by exactly one rank,
so the sum adds zeros to it: the result equals the dense lookup bit for bit.

Semantics match the dense lookup_table op: negative ids and padding_idx
rows give zeros, in the table's dtype.
"""

import torch

__all__ = ["sharded_embedding_lookup"]


def _local_lookup(table_shard, ids, index, padding_idx=None):
    """This rank's rows of the lookup: (ids.shape..., d), zeros for the ids
    another rank holds, negative ids and padding_idx."""
    rows_local = table_shard.shape[0]
    flat = ids.reshape(-1).to(torch.int64)
    local = flat - index * rows_local
    in_range = (local >= 0) & (local < rows_local) & (flat >= 0)
    if padding_idx is not None and int(padding_idx) != -1:
        in_range = in_range & (flat != int(padding_idx))
    picked = torch.index_select(table_shard, 0, local.clamp(0, rows_local - 1))
    picked = torch.where(in_range[:, None], picked,
                         torch.zeros((), dtype=picked.dtype, device=picked.device))
    return picked.reshape(tuple(ids.shape) + (table_shard.shape[1],))


def sharded_embedding_lookup(table, ids, mesh, axis_name="ep", padding_idx=None):
    """table: this rank's (rows / n, d) shard of a table row-sharded over
    `axis_name`; ids: int global ids, any shape (this rank's batch rows).
    Returns (ids.shape..., d) on every rank of the axis.

    padding_idx: already-normalized non-negative row index (or None/-1) whose
    looked-up rows are zeros, matching the dense lookup_table attr."""
    from ..parallel import collectives

    out = _local_lookup(table, ids, mesh.index(axis_name), padding_idx)
    return collectives.all_reduce(out, axis_name, mesh=mesh)
