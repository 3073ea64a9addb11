"""VGG (counterpart of paddle_tpu/models/vgg.py: vgg16_bn_drop and
build_train_net)."""
from __future__ import annotations

from .. import layers, nets


def vgg16_bn_drop(input, class_dim=1000):
    def conv_block(ipt, num_filter, groups, dropouts):
        return nets.img_conv_group(
            input=ipt, pool_size=2, pool_stride=2,
            conv_num_filter=[num_filter] * groups,
            conv_filter_size=3, conv_act="relu",
            conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts, pool_type="max")

    conv1 = conv_block(input, 64, 2, [0.3, 0])
    conv2 = conv_block(conv1, 128, 2, [0.4, 0])
    conv3 = conv_block(conv2, 256, 3, [0.4, 0.4, 0])
    conv4 = conv_block(conv3, 512, 3, [0.4, 0.4, 0])
    conv5 = conv_block(conv4, 512, 3, [0.4, 0.4, 0])

    drop = layers.dropout(conv5, dropout_prob=0.5)
    fc1 = layers.fc(drop, size=4096, act=None)
    bn = layers.batch_norm(fc1, act="relu")
    drop2 = layers.dropout(bn, dropout_prob=0.5)
    fc2 = layers.fc(drop2, size=4096, act=None)
    return layers.fc(fc2, size=class_dim, act="softmax")


def build_train_net(class_dim=10, img_shape=(3, 32, 32)):
    images = layers.data("img", list(img_shape), dtype="float32")
    label = layers.data("label", [1], dtype="int64")
    prediction = vgg16_bn_drop(images, class_dim)
    cost = layers.cross_entropy(input=prediction, label=label)
    avg_loss = layers.mean(cost)
    acc = layers.accuracy(input=prediction, label=label)
    return [images, label], avg_loss, acc, prediction
