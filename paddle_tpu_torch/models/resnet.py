"""ResNet family (counterpart of paddle_tpu/models/resnet.py): the
ImageNet builds of every depth in ``_DEPTH_CFG``, ``resnet_cifar10`` and
``build_train_net``, with the JAX package's layers, names and op order.
NCHW; each conv is bias-free and followed by batch norm."""
from __future__ import annotations

from .. import layers


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None, is_test=False):
    conv = layers.conv2d(input, num_filters=num_filters,
                         filter_size=filter_size, stride=stride,
                         padding=(filter_size - 1) // 2, groups=groups,
                         act=None, bias_attr=False)
    return layers.batch_norm(conv, act=act, is_test=is_test)


def shortcut(input, ch_out, stride, is_test=False):
    ch_in = int(input.shape[1])
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, is_test=is_test)
    return input


def bottleneck_block(input, num_filters, stride, is_test=False):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu", is_test=is_test)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride, act="relu",
                          is_test=is_test)
    conv2 = conv_bn_layer(conv1, num_filters * 4, 1, act=None,
                          is_test=is_test)
    short = shortcut(input, num_filters * 4, stride, is_test=is_test)
    return layers.elementwise_add(short, conv2, act="relu")


def basic_block(input, num_filters, stride, is_test=False):
    conv0 = conv_bn_layer(input, num_filters, 3, stride=stride, act="relu",
                          is_test=is_test)
    conv1 = conv_bn_layer(conv0, num_filters, 3, act=None, is_test=is_test)
    short = shortcut(input, num_filters, stride, is_test=is_test)
    return layers.elementwise_add(short, conv1, act="relu")


_DEPTH_CFG = {
    18: (basic_block, [2, 2, 2, 2]),
    34: (basic_block, [3, 4, 6, 3]),
    50: (bottleneck_block, [3, 4, 6, 3]),
    101: (bottleneck_block, [3, 4, 23, 3]),
    152: (bottleneck_block, [3, 8, 36, 3]),
}


def resnet_imagenet(input, class_dim=1000, depth=50, is_test=False):
    block_fn, counts = _DEPTH_CFG[depth]
    conv = conv_bn_layer(input, 64, 7, stride=2, act="relu", is_test=is_test)
    pool = layers.pool2d(conv, pool_size=3, pool_stride=2, pool_padding=1,
                         pool_type="max")
    num_filters = [64, 128, 256, 512]
    for stage, n in enumerate(counts):
        for i in range(n):
            stride = 2 if i == 0 and stage > 0 else 1
            pool = block_fn(pool, num_filters[stage], stride, is_test=is_test)
    pool = layers.pool2d(pool, pool_type="avg", global_pooling=True)
    return layers.fc(pool, size=class_dim, act="softmax")


def resnet_cifar10(input, class_dim=10, depth=32, is_test=False):
    """The 6n+2 layout of the reference benchmark's resnet_cifar10."""
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    conv = conv_bn_layer(input, 16, 3, act="relu", is_test=is_test)
    for stage, nf in enumerate([16, 32, 64]):
        for i in range(n):
            stride = 2 if i == 0 and stage > 0 else 1
            conv = basic_block(conv, nf, stride, is_test=is_test)
    pool = layers.pool2d(conv, pool_type="avg", global_pooling=True)
    return layers.fc(pool, size=class_dim, act="softmax")


def build_train_net(class_dim=1000, img_shape=(3, 224, 224), depth=50,
                    is_test=False):
    """Feeds ``img`` [N, *img_shape] f32 and ``label`` [N, 1] int64;
    returns ([images, label], mean cross-entropy, top-1 accuracy,
    softmax prediction)."""
    images = layers.data("img", list(img_shape), dtype="float32")
    label = layers.data("label", [1], dtype="int64")
    prediction = resnet_imagenet(images, class_dim, depth, is_test=is_test)
    cost = layers.cross_entropy(input=prediction, label=label)
    avg_loss = layers.mean(cost)
    acc = layers.accuracy(input=prediction, label=label)
    return [images, label], avg_loss, acc, prediction
