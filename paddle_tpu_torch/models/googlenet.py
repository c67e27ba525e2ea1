"""GoogLeNet / Inception-v1 (reference benchmark/README.md:45-51 speed-table
model; a copy of the JAX package's models/googlenet.py on the port's
layers). Inception blocks are four parallel conv towers concatenated on
channels; the two auxiliary classifiers weigh into the training loss like
the paper (0.3 each)."""

from .. import layers

__all__ = ["googlenet"]


def _conv(x, num_filters, filter_size, stride=1, padding=0):
    return layers.conv2d(
        input=x,
        num_filters=num_filters,
        filter_size=filter_size,
        stride=stride,
        padding=padding,
        act="relu",
    )


def _inception(x, c1, c3r, c3, c5r, c5, proj):
    t1 = _conv(x, c1, 1)
    t2 = _conv(_conv(x, c3r, 1), c3, 3, padding=1)
    t3 = _conv(_conv(x, c5r, 1), c5, 5, padding=2)
    t4 = _conv(
        layers.pool2d(input=x, pool_size=3, pool_stride=1, pool_padding=1,
                      pool_type="max"),
        proj,
        1,
    )
    return layers.concat([t1, t2, t3, t4], axis=1)


def _aux_head(x, class_dim):
    pool = layers.pool2d(input=x, pool_size=5, pool_stride=3, pool_type="avg")
    conv = _conv(pool, 128, 1)
    flat = layers.reshape(conv, [0, -1])
    fc = layers.fc(input=flat, size=1024, act="relu")
    drop = layers.dropout(fc, 0.7)
    return layers.fc(input=drop, size=class_dim, act="softmax")


def googlenet(img, label, class_dim=1000, with_aux_heads=True):
    c1 = _conv(img, 64, 7, stride=2, padding=3)
    p1 = layers.pool2d(input=c1, pool_size=3, pool_stride=2, pool_type="max")
    c2 = _conv(_conv(p1, 64, 1), 192, 3, padding=1)
    p2 = layers.pool2d(input=c2, pool_size=3, pool_stride=2, pool_type="max")

    i3a = _inception(p2, 64, 96, 128, 16, 32, 32)
    i3b = _inception(i3a, 128, 128, 192, 32, 96, 64)
    p3 = layers.pool2d(input=i3b, pool_size=3, pool_stride=2, pool_type="max")

    i4a = _inception(p3, 192, 96, 208, 16, 48, 64)
    i4b = _inception(i4a, 160, 112, 224, 24, 64, 64)
    i4c = _inception(i4b, 128, 128, 256, 24, 64, 64)
    i4d = _inception(i4c, 112, 144, 288, 32, 64, 64)
    i4e = _inception(i4d, 256, 160, 320, 32, 128, 128)
    p4 = layers.pool2d(input=i4e, pool_size=3, pool_stride=2, pool_type="max")

    i5a = _inception(p4, 256, 160, 320, 32, 128, 128)
    i5b = _inception(i5a, 384, 192, 384, 48, 128, 128)
    pool = layers.pool2d(input=i5b, pool_type="avg", global_pooling=True)
    flat = layers.reshape(pool, [0, -1])
    drop = layers.dropout(flat, 0.4)
    out = layers.fc(input=drop, size=class_dim, act="softmax")

    loss = layers.mean(layers.cross_entropy(input=out, label=label))
    if with_aux_heads:
        aux1 = _aux_head(i4a, class_dim)
        aux2 = _aux_head(i4d, class_dim)
        loss1 = layers.mean(layers.cross_entropy(input=aux1, label=label))
        loss2 = layers.mean(layers.cross_entropy(input=aux2, label=label))
        loss = loss + 0.3 * loss1 + 0.3 * loss2
    acc = layers.accuracy(input=out, label=label)
    return loss, acc, out
