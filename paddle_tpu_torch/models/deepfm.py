"""DeepFM CTR model (BASELINE config 4; the reference era's CTR tier:
dist_ctr.py / deep-and-wide models built on sparse lookup_table + logloss +
AUC), the torch port's copy of paddle_tpu/models/deepfm.py. The FM
second-order term uses the sum-square identity 0.5 * ((sum v)^2 - sum v^2).

Embedding routing (embedding/, ops/sparse_ops.py):
- `is_sparse=True` makes both tables' gradients SelectedRows pairs with
  per-row optimizer updates: cost O(batch * fields * dim), not
  O(num_features);
- `use_distributed=True` row-shards both tables over the mesh `axis_name`
  (layers.distributed_embedding, the EmbeddingEngine) under a
  ParallelExecutor whose mesh gives that axis an extent above 1;
- `hash_size=N` routes raw ids through the `hash` op (XXH32 mod N) so an
  unbounded id space feeds a fixed-size table, and the tables are sized by
  hash_size instead of num_features."""

from .. import layers
from ..param_attr import ParamAttr


def deepfm(
    feat_ids,
    label,
    num_features=10000,
    num_fields=10,
    embedding_size=8,
    layer_sizes=(64, 32),
    is_sparse=False,
    use_distributed=False,
    axis_name="ep",
    hash_size=None,
):
    """feat_ids: (b, num_fields, 1) int ids into a shared feature space."""
    if hash_size is not None:
        # (b*f, num_hash=1, 1) bucket ids -> back to (b, f, 1)
        flat = layers.reshape(feat_ids, [-1, 1])
        hashed = layers.hash(flat, hash_size=hash_size, num_hash=1)
        feat_ids = layers.reshape(hashed, [-1, num_fields, 1])
        num_features = hash_size

    def table(size, name):
        if use_distributed:
            return layers.distributed_embedding(
                feat_ids,
                size=size,
                param_attr=ParamAttr(name=name),
                axis_name=axis_name,
                is_sparse=is_sparse,
            )
        return layers.embedding(
            feat_ids,
            size=size,
            is_sparse=is_sparse,
            param_attr=ParamAttr(name=name),
        )

    # first-order term: per-feature scalar weights
    first_emb = table([num_features, 1], "fm_first")  # (b, f, 1)
    y_first = layers.reduce_sum(layers.reshape(first_emb, [0, num_fields]), dim=[1], keep_dim=True)

    # second-order term via sum-square trick
    emb = table([num_features, embedding_size], "fm_emb")  # (b, f, k)
    summed = layers.reduce_sum(emb, dim=[1])  # (b, k)
    sum_sq = layers.square(summed)
    sq_sum = layers.reduce_sum(layers.square(emb), dim=[1])
    y_second = layers.scale(
        layers.reduce_sum(layers.elementwise_sub(sum_sq, sq_sum), dim=[1], keep_dim=True),
        scale=0.5,
    )

    # deep tower
    deep = layers.reshape(emb, [0, num_fields * embedding_size])
    for width in layer_sizes:
        deep = layers.fc(deep, size=width, act="relu")
    y_deep = layers.fc(deep, size=1)

    logit = layers.elementwise_add(
        layers.elementwise_add(y_first, y_second), y_deep
    )
    pred = layers.sigmoid(logit)
    loss = layers.mean(
        layers.sigmoid_cross_entropy_with_logits(logit, label)
    )
    return loss, pred, logit
