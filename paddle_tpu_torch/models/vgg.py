"""VGG-16/19 (reference benchmark/fluid/models/vgg.py conv_block structure;
VGG-19 is the configuration the reference publishes train/infer baselines
for, benchmark/IntelOptimizedPaddle.md:29-37; a copy of the JAX package's
models/vgg.py on the port's layers)."""

from .. import layers

__all__ = ["vgg16", "vgg19"]


def conv_block(input, num_filter, groups):
    conv = input
    for _ in range(groups):
        conv = layers.conv2d(
            conv, num_filters=num_filter, filter_size=3, padding=1, act="relu"
        )
    return layers.pool2d(conv, pool_size=2, pool_stride=2)


def _vgg(img, label, depths, class_num, dropout):
    conv = img
    for filters, groups in zip((64, 128, 256, 512, 512), depths):
        conv = conv_block(conv, filters, groups)
    fc1 = layers.fc(conv, size=4096, act="relu")
    if dropout:
        fc1 = layers.dropout(fc1, dropout_prob=0.5)
    fc2 = layers.fc(fc1, size=4096, act="relu")
    if dropout:
        fc2 = layers.dropout(fc2, dropout_prob=0.5)
    logits = layers.fc(fc2, size=class_num)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return loss, acc, logits


def vgg19(img, label, class_num=1000, dropout=True):
    return _vgg(img, label, (2, 2, 4, 4, 4), class_num, dropout)


def vgg16(img, label, class_num=1000, dropout=True):
    conv1 = conv_block(img, 64, 2)
    conv2 = conv_block(conv1, 128, 2)
    conv3 = conv_block(conv2, 256, 3)
    conv4 = conv_block(conv3, 512, 3)
    conv5 = conv_block(conv4, 512, 3)
    fc1 = layers.fc(conv5, size=4096, act="relu")
    if dropout:
        fc1 = layers.dropout(fc1, dropout_prob=0.5)
    fc2 = layers.fc(fc1, size=4096, act="relu")
    if dropout:
        fc2 = layers.dropout(fc2, dropout_prob=0.5)
    logits = layers.fc(fc2, size=class_num)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return loss, acc, logits
