"""Back-compat shim: the row-sharded lookup lives in embedding/lookup.py
(with the EmbeddingEngine, SelectedRows gradients and the per-row
optimizer updates); import from there, or use
layers.distributed_embedding / embedding.EmbeddingEngine, in new code."""

from ..embedding.lookup import _local_lookup, sharded_embedding_lookup  # noqa: F401

__all__ = ["sharded_embedding_lookup"]
