"""paddle_tpu_torch.embedding — the sparse embedding engine for
recsys-scale tables (the counterpart of paddle_tpu/embedding/).

The replacement for the reference's pserver distributed lookup table
(SURVEY.md §2.7.5): row-sharded tables over the mesh `ep` axis
(EmbeddingEngine, engine.py; the gather + all-reduce lookup, lookup.py),
SelectedRows-style sparse gradients whose cost scales with touched rows
(selected_rows.py), and per-row optimizer updates with row-sharded moments
(ops/sparse_ops.py).
"""

from .engine import EmbeddingEngine, engines_of
from .lookup import sharded_embedding_lookup
from .selected_rows import (
    ROW_SENTINEL,
    densify,
    is_selected_rows,
    mark_selected_rows,
    merge_rows,
    rows_var_name,
)

__all__ = [
    "EmbeddingEngine",
    "engines_of",
    "sharded_embedding_lookup",
    "ROW_SENTINEL",
    "densify",
    "is_selected_rows",
    "mark_selected_rows",
    "merge_rows",
    "rows_var_name",
]
