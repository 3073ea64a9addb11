"""MNIST LeNet (counterpart of paddle_tpu/models/lenet.py: lenet and
build_train_net)."""
from __future__ import annotations

from .. import layers, nets


def lenet(images, num_classes: int = 10):
    """conv5x5x20-pool2 -> BN -> conv5x5x50-pool2 -> fc softmax."""
    conv_pool_1 = nets.simple_img_conv_pool(
        input=images, filter_size=5, num_filters=20,
        pool_size=2, pool_stride=2, act="relu")
    conv_pool_1 = layers.batch_norm(conv_pool_1)
    conv_pool_2 = nets.simple_img_conv_pool(
        input=conv_pool_1, filter_size=5, num_filters=50,
        pool_size=2, pool_stride=2, act="relu")
    return layers.fc(conv_pool_2, size=num_classes, act="softmax")


def build_train_net(img_shape=(1, 28, 28)):
    """Builds (feeds, avg_loss, acc, prediction) in the default program."""
    images = layers.data("img", list(img_shape), dtype="float32")
    label = layers.data("label", [1], dtype="int64")
    prediction = lenet(images)
    cost = layers.cross_entropy(input=prediction, label=label)
    avg_loss = layers.mean(cost)
    acc = layers.accuracy(input=prediction, label=label)
    return [images, label], avg_loss, acc, prediction
