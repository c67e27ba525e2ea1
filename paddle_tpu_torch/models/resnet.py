"""ResNet (BASELINE config 2; structural parity with reference
benchmark/fluid/models/resnet.py — conv_bn_layer / shortcut / bottleneck
blocks — written fluid-style against our layers API).

NCHW throughout; batch_norm's statistics in f32; on the card the
convolutions are cuDNN's (ops/core_ops.py conv2d)."""

from .. import layers


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1, act=None):
    conv = layers.conv2d(
        input,
        num_filters=num_filters,
        filter_size=filter_size,
        stride=stride,
        padding=(filter_size - 1) // 2,
        groups=groups,
        act=None,
        bias_attr=False,
    )
    return layers.batch_norm(conv, act=act)


def shortcut(input, ch_out, stride):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride)
    return input


def bottleneck_block(input, num_filters, stride):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu")
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride, act="relu")
    conv2 = conv_bn_layer(conv1, num_filters * 4, 1, act=None)
    short = shortcut(input, num_filters * 4, stride)
    return layers.elementwise_add(short, conv2, act="relu")


def basic_block(input, num_filters, stride):
    conv0 = conv_bn_layer(input, num_filters, 3, stride=stride, act="relu")
    conv1 = conv_bn_layer(conv0, num_filters, 3, act=None)
    short = shortcut(input, num_filters, stride)
    return layers.elementwise_add(short, conv1, act="relu")


def resnet50(img, label, class_num=1000):
    """ResNet-50 v1 for ImageNet-sized inputs (N,3,224,224)."""
    depth = [3, 4, 6, 3]
    num_filters = [64, 128, 256, 512]
    conv = conv_bn_layer(img, 64, 7, stride=2, act="relu")
    pool = layers.pool2d(conv, pool_size=3, pool_stride=2, pool_padding=1)
    for block in range(len(depth)):
        for i in range(depth[block]):
            pool = bottleneck_block(
                pool, num_filters[block], stride=2 if i == 0 and block != 0 else 1
            )
    pool = layers.pool2d(pool, pool_type="avg", global_pooling=True)
    logits = layers.fc(pool, size=class_num)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return loss, acc, logits


def resnet_cifar10(img, label, depth=32, class_num=10):
    """ResNet for CIFAR (reference benchmark/fluid/models/resnet.py
    resnet_cifar10: 6n+2 basic blocks)."""
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    conv = conv_bn_layer(img, 16, 3, act="relu")
    for filters, stride in [(16, 1), (32, 2), (64, 2)]:
        for i in range(n):
            conv = basic_block(conv, filters, stride if i == 0 else 1)
    pool = layers.pool2d(conv, pool_type="avg", global_pooling=True)
    logits = layers.fc(pool, size=class_num)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return loss, acc, logits
