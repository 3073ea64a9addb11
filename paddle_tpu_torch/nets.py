"""Composed network helpers (counterpart of paddle_tpu/nets.py:
simple_img_conv_pool :9, img_conv_group :23 and sequence_conv_pool
:81)."""
from __future__ import annotations

from . import layers


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1,
                         conv_padding=0, conv_dilation=1, conv_groups=1,
                         param_attr=None, bias_attr=None, act=None):
    conv_out = layers.conv2d(input, num_filters, filter_size,
                             stride=conv_stride, padding=conv_padding,
                             dilation=conv_dilation, groups=conv_groups,
                             param_attr=param_attr, bias_attr=bias_attr,
                             act=act)
    return layers.pool2d(conv_out, pool_size, pool_type, pool_stride,
                         pool_padding, global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act="relu",
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max"):
    """Convs (each with batch norm and dropout where asked), then one
    pool."""
    tmp = input
    if isinstance(conv_with_batchnorm, bool):
        conv_with_batchnorm = [conv_with_batchnorm] * len(conv_num_filter)
    if isinstance(conv_batchnorm_drop_rate, (int, float)):
        conv_batchnorm_drop_rate = ([conv_batchnorm_drop_rate]
                                    * len(conv_num_filter))
    for i, nf in enumerate(conv_num_filter):
        local_act = None if conv_with_batchnorm[i] else conv_act
        tmp = layers.conv2d(tmp, nf, conv_filter_size,
                            padding=conv_padding, act=local_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(tmp, act=conv_act)
            if conv_batchnorm_drop_rate[i] > 0:
                tmp = layers.dropout(tmp, conv_batchnorm_drop_rate[i])
    return layers.pool2d(tmp, pool_size, pool_type, pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, act="sigmoid",
                       pool_type="max", mask=None):
    """A context convolution over time, then a pool over it."""
    conv_out = layers.sequence_conv(input, num_filters=num_filters,
                                    filter_size=filter_size, act=act)
    return layers.sequence_pool(conv_out, pool_type, mask=mask)
