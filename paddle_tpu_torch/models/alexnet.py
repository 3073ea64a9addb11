"""AlexNet (counterpart of paddle_tpu/models/alexnet.py: alexnet and
build_train_net): conv11/4 + LRN + pool, a grouped conv5, three conv3
(two grouped), two fc4096 with dropout, NCHW."""
from __future__ import annotations

from .. import layers


def alexnet(images, class_dim: int = 1000, is_test: bool = False):
    drop = 0.0 if is_test else 0.5
    x = layers.conv2d(images, num_filters=96, filter_size=11, stride=4,
                      padding=2, act="relu")
    x = layers.lrn(x, n=5, alpha=1e-4, beta=0.75)
    x = layers.pool2d(x, pool_size=3, pool_stride=2)
    x = layers.conv2d(x, num_filters=256, filter_size=5, padding=2,
                      groups=2, act="relu")
    x = layers.lrn(x, n=5, alpha=1e-4, beta=0.75)
    x = layers.pool2d(x, pool_size=3, pool_stride=2)
    x = layers.conv2d(x, num_filters=384, filter_size=3, padding=1,
                      act="relu")
    x = layers.conv2d(x, num_filters=384, filter_size=3, padding=1,
                      groups=2, act="relu")
    x = layers.conv2d(x, num_filters=256, filter_size=3, padding=1,
                      groups=2, act="relu")
    x = layers.pool2d(x, pool_size=3, pool_stride=2)
    x = layers.fc(x, size=4096, act="relu")
    x = layers.dropout(x, drop, is_test=is_test,
                       dropout_implementation="upscale_in_train")
    x = layers.fc(x, size=4096, act="relu")
    x = layers.dropout(x, drop, is_test=is_test,
                       dropout_implementation="upscale_in_train")
    return layers.fc(x, size=class_dim, act="softmax")


def build_train_net(class_dim: int = 1000, img_shape=(3, 224, 224),
                    is_test: bool = False):
    """Builds (feeds, avg_loss, acc, prediction) in the default program."""
    images = layers.data("img", list(img_shape), dtype="float32")
    label = layers.data("label", [1], dtype="int64")
    pred = alexnet(images, class_dim, is_test=is_test)
    cost = layers.cross_entropy(input=pred, label=label)
    avg_loss = layers.mean(cost)
    acc = layers.accuracy(input=pred, label=label)
    return [images, label], avg_loss, acc, pred
