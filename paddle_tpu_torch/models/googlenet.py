"""GoogLeNet, Inception v1 (counterpart of paddle_tpu/models/googlenet.py:
_inception, _aux_head, googlenet and build_train_net).  An inception
module is four towers (1x1 / 1x1 -> 3x3 / 1x1 -> 5x5 / pool -> 1x1)
concatenated on channels; training has three classifier heads, the loss
main + 0.3 * (aux1 + aux2)."""
from __future__ import annotations

from .. import layers


def _inception(x, c1, c3r, c3, c5r, c5, proj):
    t1 = layers.conv2d(x, num_filters=c1, filter_size=1, act="relu")
    t2 = layers.conv2d(x, num_filters=c3r, filter_size=1, act="relu")
    t2 = layers.conv2d(t2, num_filters=c3, filter_size=3, padding=1,
                       act="relu")
    t3 = layers.conv2d(x, num_filters=c5r, filter_size=1, act="relu")
    t3 = layers.conv2d(t3, num_filters=c5, filter_size=5, padding=2,
                       act="relu")
    t4 = layers.pool2d(x, pool_size=3, pool_stride=1, pool_padding=1)
    t4 = layers.conv2d(t4, num_filters=proj, filter_size=1, act="relu")
    return layers.concat([t1, t2, t3, t4], axis=1)


def _aux_head(x, class_dim, is_test):
    a = layers.adaptive_pool2d(x, pool_size=4, pool_type="avg")
    a = layers.conv2d(a, num_filters=128, filter_size=1, act="relu")
    a = layers.fc(a, size=1024, act="relu")
    a = layers.dropout(a, 0.7, is_test=is_test,
                       dropout_implementation="upscale_in_train")
    return layers.fc(a, size=class_dim, act="softmax")


def googlenet(images, class_dim: int = 1000, is_test: bool = False):
    """Returns (main_pred, aux1_pred, aux2_pred)."""
    x = layers.conv2d(images, num_filters=64, filter_size=7, stride=2,
                      padding=3, act="relu")
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1)
    x = layers.conv2d(x, num_filters=64, filter_size=1, act="relu")
    x = layers.conv2d(x, num_filters=192, filter_size=3, padding=1,
                      act="relu")
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1)
    x = _inception(x, 64, 96, 128, 16, 32, 32)        # 3a -> 256
    x = _inception(x, 128, 128, 192, 32, 96, 64)      # 3b -> 480
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1)
    x = _inception(x, 192, 96, 208, 16, 48, 64)       # 4a -> 512
    aux1 = _aux_head(x, class_dim, is_test)
    x = _inception(x, 160, 112, 224, 24, 64, 64)      # 4b
    x = _inception(x, 128, 128, 256, 24, 64, 64)      # 4c
    x = _inception(x, 112, 144, 288, 32, 64, 64)      # 4d
    aux2 = _aux_head(x, class_dim, is_test)
    x = _inception(x, 256, 160, 320, 32, 128, 128)    # 4e -> 832
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1)
    x = _inception(x, 256, 160, 320, 32, 128, 128)    # 5a
    x = _inception(x, 384, 192, 384, 48, 128, 128)    # 5b -> 1024
    x = layers.pool2d(x, pool_size=7, pool_stride=1, pool_type="avg",
                      global_pooling=True)
    x = layers.dropout(x, 0.4, is_test=is_test,
                       dropout_implementation="upscale_in_train")
    main = layers.fc(x, size=class_dim, act="softmax")
    return main, aux1, aux2


def build_train_net(class_dim: int = 1000, img_shape=(3, 224, 224),
                    is_test: bool = False):
    """Builds (feeds, avg_loss, acc, prediction); loss = main + 0.3 *
    (aux1 + aux2)."""
    images = layers.data("img", list(img_shape), dtype="float32")
    label = layers.data("label", [1], dtype="int64")
    main, aux1, aux2 = googlenet(images, class_dim, is_test=is_test)
    cost = layers.mean(layers.cross_entropy(main, label))
    cost1 = layers.mean(layers.cross_entropy(aux1, label))
    cost2 = layers.mean(layers.cross_entropy(aux2, label))
    avg_loss = layers.elementwise_add(
        cost, layers.scale(layers.elementwise_add(cost1, cost2),
                           scale=0.3))
    acc = layers.accuracy(input=main, label=label)
    return [images, label], avg_loss, acc, main
