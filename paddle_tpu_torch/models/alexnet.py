"""AlexNet (reference benchmark/README.md:33-38 — the ms/batch speed-table
model; classic 5-conv + 3-fc topology with LRN after the first two convs;
a copy of the JAX package's models/alexnet.py on the port's layers)."""

from .. import layers

__all__ = ["alexnet"]


def alexnet(img, label, class_dim=1000, use_lrn=True):
    def conv(x, num_filters, filter_size, stride=1, padding=0, groups=1):
        return layers.conv2d(
            input=x,
            num_filters=num_filters,
            filter_size=filter_size,
            stride=stride,
            padding=padding,
            groups=groups,
            act="relu",
        )

    def maxpool(x):
        return layers.pool2d(
            input=x, pool_size=3, pool_stride=2, pool_type="max"
        )

    c1 = conv(img, 64, 11, stride=4, padding=2)
    if use_lrn:
        c1 = layers.lrn(input=c1, n=5, alpha=1e-4, beta=0.75)
    p1 = maxpool(c1)
    c2 = conv(p1, 192, 5, padding=2)
    if use_lrn:
        c2 = layers.lrn(input=c2, n=5, alpha=1e-4, beta=0.75)
    p2 = maxpool(c2)
    c3 = conv(p2, 384, 3, padding=1)
    c4 = conv(c3, 256, 3, padding=1)
    c5 = conv(c4, 256, 3, padding=1)
    p5 = maxpool(c5)
    flat = layers.reshape(p5, [0, -1])
    fc6 = layers.fc(input=layers.dropout(flat, 0.5), size=4096, act="relu")
    fc7 = layers.fc(input=layers.dropout(fc6, 0.5), size=4096, act="relu")
    out = layers.fc(input=fc7, size=class_dim, act="softmax")
    loss = layers.mean(layers.cross_entropy(input=out, label=label))
    acc = layers.accuracy(input=out, label=label)
    return loss, acc, out
