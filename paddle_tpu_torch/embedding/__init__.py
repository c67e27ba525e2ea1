"""paddle_tpu_torch.embedding: the SelectedRows sparse-gradient structure
(selected_rows.py) that `is_sparse=True` lookup tables emit and the per-row
optimizer ops (ops/sparse_ops.py) consume.

The JAX package's row-sharded side of this package, `EmbeddingEngine`
(engine.py) and `sharded_embedding_lookup` (lookup.py, shard_map), shards a
table over a mesh axis; this package has no mesh yet, and they come with
the parallel layer.
"""

from .selected_rows import (
    ROW_SENTINEL,
    densify,
    is_selected_rows,
    mark_selected_rows,
    merge_rows,
    rows_var_name,
)

__all__ = [
    "ROW_SENTINEL",
    "densify",
    "is_selected_rows",
    "mark_selected_rows",
    "merge_rows",
    "rows_var_name",
]
