"""SE-ResNeXt 50 / 101 (counterpart of paddle_tpu/models/se_resnext.py:
conv_bn, squeeze_excite, bottleneck, se_resnext, build_train_net and
make_fake_batch): grouped 3x3 convolutions (cardinality 32) and
squeeze-excite channel gating."""
from __future__ import annotations

import numpy as np

from .. import layers


def conv_bn(x, num_filters, filter_size, stride=1, groups=1, act=None):
    conv = layers.conv2d(x, num_filters=num_filters,
                         filter_size=filter_size, stride=stride,
                         padding=(filter_size - 1) // 2, groups=groups,
                         bias_attr=False)
    return layers.batch_norm(conv, act=act)


def squeeze_excite(x, num_channels, reduction_ratio=16):
    pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
    squeeze = layers.fc(pool, size=max(1, num_channels // reduction_ratio),
                        act="relu")
    excite = layers.fc(squeeze, size=num_channels, act="sigmoid")
    # the [B, C] gate scales the [B, C, H, W] map channel by channel
    return layers.elementwise_mul(x, excite, axis=0)


def bottleneck(x, num_filters, stride, cardinality=32,
               reduction_ratio=16):
    expansion = 2          # the SE-ResNeXt bottleneck doubles the width
    conv0 = conv_bn(x, num_filters, 1, act="relu")
    conv1 = conv_bn(conv0, num_filters, 3, stride=stride,
                    groups=cardinality, act="relu")
    conv2 = conv_bn(conv1, num_filters * expansion, 1)
    scaled = squeeze_excite(conv2, num_filters * expansion,
                            reduction_ratio)
    in_c = int(x.shape[1])
    if in_c != num_filters * expansion or stride != 1:
        shortcut = conv_bn(x, num_filters * expansion, 1, stride=stride)
    else:
        shortcut = x
    return layers.relu(layers.elementwise_add(scaled, shortcut))


def se_resnext(x, class_dim=1000, depth=50, cardinality=32,
               reduction_ratio=16, stage_blocks=None):
    assert depth in (50, 101), depth
    if stage_blocks is None:
        stage_blocks = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3]}[depth]
    stage_filters = [128, 256, 512, 1024][:len(stage_blocks)]
    conv = conv_bn(x, 64, 7, stride=2, act="relu")
    conv = layers.pool2d(conv, pool_size=3, pool_stride=2, pool_padding=1,
                         pool_type="max")
    for stage, n_blocks in enumerate(stage_blocks):
        for i in range(n_blocks):
            stride = 2 if i == 0 and stage > 0 else 1
            conv = bottleneck(conv, stage_filters[stage], stride,
                              cardinality, reduction_ratio)
    pool = layers.pool2d(conv, pool_type="avg", global_pooling=True)
    drop = layers.dropout(pool, dropout_prob=0.2)
    return layers.fc(drop, size=class_dim, act="softmax")


def build_train_net(class_dim=1000, img_shape=(3, 224, 224), depth=50,
                    is_test: bool = False, stage_blocks=None):
    """Builds (feeds, avg_loss, acc, prediction) in the default program."""
    images = layers.data("img", list(img_shape), dtype="float32")
    label = layers.data("label", [1], dtype="int64")
    pred = se_resnext(images, class_dim, depth, stage_blocks=stage_blocks)
    cost = layers.cross_entropy(input=pred, label=label)
    avg_loss = layers.mean(cost)
    acc = layers.accuracy(input=pred, label=label)
    return [images, label], avg_loss, acc, pred


def make_fake_batch(batch_size, img_shape=(3, 224, 224), class_dim=1000,
                    seed=0):
    rng = np.random.RandomState(seed)
    return {"img": rng.rand(batch_size, *img_shape).astype("float32"),
            "label": rng.randint(0, class_dim,
                                 (batch_size, 1)).astype("int64")}
