"""LeNet-5 (BASELINE config 1 / reference benchmark/fluid/models/mnist.py
cnn_model structure — conv-pool ×2 + fc stack)."""

from .. import layers


def lenet5(img, label, class_num=10):
    conv1 = layers.conv2d(img, num_filters=6, filter_size=5, padding=2, act="relu")
    pool1 = layers.pool2d(conv1, pool_size=2, pool_stride=2)
    conv2 = layers.conv2d(pool1, num_filters=16, filter_size=5, act="relu")
    pool2 = layers.pool2d(conv2, pool_size=2, pool_stride=2)
    fc1 = layers.fc(pool2, size=120, act="relu")
    fc2 = layers.fc(fc1, size=84, act="relu")
    logits = layers.fc(fc2, size=class_num)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return loss, acc, logits
