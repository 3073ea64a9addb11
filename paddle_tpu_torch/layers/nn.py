"""NN layer functions — the user-facing model-building API.

Counterpart of paddle_tpu/layers/nn.py (all of its public layers but
sequence_mask, moe and pipeline_boundary): data :21, fc :34 (over
several inputs too), embedding :63, sparse_embedding :93 (the
hash-bucketed table of the sparse plane), conv2d :114, conv2d_transpose
:138, pool2d :163, adaptive_pool2d :178, batch_norm :187, layer_norm
:223, group_norm :248, dropout :271, softmax :284, log_softmax :292,
cross_entropy :300, softmax_with_cross_entropy :310, square_error_cost
:323, mean :331, the reductions :352-356, reshape :359, transpose :367,
split :375, stack :389, unstack :396, squeeze :405, unsqueeze :413,
flatten :421, expand :428, slice :436, gather :445, scatter :453,
matmul :462, mul :471, topk :480, accuracy :489, auc :503 (its
histograms persistable, written back by the op), one_hot :524, clip
:532, clip_by_norm :540, scale :548, the elementwise layers :557-574
(with their ``act``), the unary layers (``_unary_layer`` :577 over
:587-596's list), pow :599, prelu :606, maxout :623, lrn :631, pad
:641, pad2d :650, image_resize :659 with resize_bilinear and
resize_nearest, l2_normalize :688, cos_sim :697,
sigmoid_cross_entropy_with_logits :707, smooth_l1 :717, huber_loss
:731, label_smooth :741 (composed of ``scale`` ops, as JAX's is),
uniform_random_batch_size_like :750, gaussian_random :764,
uniform_random :773, the comparison and logical layers
(``_binary_compare_layer`` :782; a ``cond=`` var is written in place,
as a ``While`` condition must be), logical_not :803, increment :810,
fused_multihead_attention :820, fused_mha :877, fused_attention_qkv
:948, where :960 and fused_lm_head_loss :968.  Each function creates
params via LayerHelper (initializers go to the startup program) and
appends ops to the main program, with the same names, attrs and op order
as the JAX package, so both builds serialize alike.
"""
from __future__ import annotations

import copy
import math
from typing import List, Sequence, Union

from ..core.enforce import check_arg
from ..framework.initializer import ConstantInitializer, NormalInitializer
from ..framework.layer_helper import LayerHelper, ParamAttr
from ..framework.program import Variable

__all__ = ["data", "fc", "embedding", "sparse_embedding", "conv2d",
           "conv2d_transpose", "pool2d", "adaptive_pool2d", "batch_norm",
           "layer_norm", "group_norm",
           "dropout", "softmax", "log_softmax", "cross_entropy",
           "softmax_with_cross_entropy", "square_error_cost", "mean",
           "reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
           "reduce_prod", "reshape", "transpose", "split", "stack",
           "unstack", "squeeze", "unsqueeze", "flatten", "expand", "slice",
           "gather", "scatter", "matmul", "mul", "topk", "accuracy", "auc",
           "one_hot", "clip", "clip_by_norm", "scale", "elementwise_add",
           "elementwise_sub", "elementwise_mul", "elementwise_div",
           "elementwise_max", "elementwise_min", "elementwise_pow",
           "pow", "prelu", "maxout", "lrn", "pad", "pad2d",
           "image_resize", "resize_bilinear", "resize_nearest",
           "l2_normalize", "cos_sim", "sigmoid_cross_entropy_with_logits",
           "smooth_l1", "huber_loss", "label_smooth",
           "uniform_random_batch_size_like", "gaussian_random",
           "uniform_random", "less_than", "less_equal", "greater_than",
           "greater_equal", "equal", "not_equal", "logical_and",
           "logical_or", "logical_xor", "logical_not", "increment",
           "fused_mha", "fused_attention_qkv", "fused_multihead_attention",
           "where", "fused_lm_head_loss", "sequence_mask"]


def data(name: str, shape: Sequence[int], dtype="float32",
         append_batch_size: bool = True, lod_level: int = 0) -> Variable:
    """Input placeholder (ref layers/io.py data)."""
    helper = LayerHelper("data", name=name)
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return helper.block.create_var(name=name, shape=shape, dtype=dtype,
                                   is_data=True, stop_gradient=True,
                                   lod_level=lod_level)


def fc(input: Union[Variable, List[Variable]], size: int, num_flatten_dims=1,
       param_attr=None, bias_attr=None, act=None, name=None) -> Variable:
    """Fully-connected: out = act(sum_i(X_i W_i) + b).  Several inputs
    take a weight each (``param_attr`` may be a list, one per input), and
    their products add through one ``sum`` op."""
    helper = LayerHelper("fc", name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    mul_results = []
    for i, x in enumerate(inputs):
        in_features = math.prod(int(d) for d in x.shape[num_flatten_dims:])
        w = helper.create_parameter(
            param_attr if not isinstance(param_attr, (list, tuple))
            else param_attr[i],
            shape=[in_features, size], dtype=x.dtype)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op("mul", {"X": [x], "Y": [w]}, {"Out": [out]},
                         {"x_num_col_dims": num_flatten_dims,
                          "y_num_col_dims": 1})
        mul_results.append(out)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(inputs[0].dtype)
        helper.append_op("sum", {"X": mul_results}, {"Out": [pre_bias]}, {})
    bias = helper.create_parameter(bias_attr, shape=[size],
                                   dtype=pre_bias.dtype, is_bias=True)
    pre_act = helper.append_bias_op(pre_bias, bias,
                                    dim_start=num_flatten_dims)
    return helper.append_activation(pre_act, act)


def embedding(input: Variable, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32", name=None) -> Variable:
    helper = LayerHelper("embedding", name=name)
    w = helper.create_parameter(
        param_attr, shape=list(size), dtype=dtype,
        default_initializer=NormalInitializer(0.0,
                                              1.0 / math.sqrt(size[1])))
    out = helper.create_variable_for_type_inference(dtype)
    if padding_idx is None:
        pad_attr = -1  # kNoPadding sentinel (ref lookup_table_op.h)
    else:
        pad_attr = int(padding_idx) if padding_idx >= 0 else (
            int(size[0]) + int(padding_idx))
    helper.append_op("lookup_table", {"W": [w], "Ids": [input]},
                     {"Out": [out]}, {"padding_idx": pad_attr,
                                      "is_sparse": bool(is_sparse)})
    return out


def sparse_embedding(input: Variable, size, hash_bucket=True,
                     param_attr=None, dtype="float32",
                     name=None) -> Variable:
    """The sparse plane's table lookup: like :func:`embedding`, but with
    ``hash_bucket`` (the CTR default) raw ids of any magnitude fold into
    the ``size[0]`` buckets by the plane's avalanche hash, so the table
    is sized by budget, not by the id space."""
    helper = LayerHelper("sparse_embedding", name=name)
    w = helper.create_parameter(
        param_attr, shape=list(size), dtype=dtype,
        default_initializer=NormalInitializer(0.0,
                                              1.0 / math.sqrt(size[1])))
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("sparse_embedding_lookup",
                     {"W": [w], "Ids": [input]}, {"Out": [out]},
                     {"hash_bucket": bool(hash_bucket)})
    return out


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [int(v), int(v)]


def conv2d(input: Variable, num_filters: int, filter_size, stride=1,
           padding=0, dilation=1, groups=1, param_attr=None, bias_attr=None,
           act=None, name=None) -> Variable:
    """NCHW input, OIHW filter drawn from N(0, 2 / fan_in); the bias (none
    with ``bias_attr=False``) is an elementwise_add over dims from 1."""
    helper = LayerHelper("conv2d", name=name)
    c_in = int(input.shape[1])
    fs = filter_size if isinstance(filter_size, (list, tuple)) else (
        filter_size, filter_size)
    w_shape = [num_filters, c_in // groups, fs[0], fs[1]]
    fan_in = (c_in // groups) * fs[0] * fs[1]
    w = helper.create_parameter(
        param_attr, shape=w_shape, dtype=input.dtype,
        default_initializer=NormalInitializer(0.0, math.sqrt(2.0 / fan_in)))
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("conv2d", {"Input": [input], "Filter": [w]},
                     {"Output": [out]},
                     {"strides": _pair(stride), "paddings": _pair(padding),
                      "dilations": _pair(dilation), "groups": groups})
    bias = helper.create_parameter(bias_attr, shape=[num_filters],
                                   dtype=input.dtype, is_bias=True)
    pre_act = helper.append_bias_op(out, bias, dim_start=1)
    return helper.append_activation(pre_act, act)


def conv2d_transpose(input, num_filters, filter_size, stride=1, padding=0,
                     dilation=1, groups=1, param_attr=None, bias_attr=None,
                     act=None, name=None) -> Variable:
    """NCHW input, IOHW filter [C_in, num_filters // groups, kh, kw]
    (Xavier, the helper's default); the bias as conv2d's."""
    helper = LayerHelper("conv2d_transpose", name=name)
    c_in = int(input.shape[1])
    fs = filter_size if isinstance(filter_size, (list, tuple)) else (
        filter_size, filter_size)
    w = helper.create_parameter(
        param_attr, shape=[c_in, num_filters // groups, fs[0], fs[1]],
        dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("conv2d_transpose", {"Input": [input], "Filter": [w]},
                     {"Output": [out]},
                     {"strides": _pair(stride), "paddings": _pair(padding),
                      "dilations": _pair(dilation), "groups": groups})
    bias = helper.create_parameter(bias_attr, shape=[num_filters],
                                   dtype=input.dtype, is_bias=True)
    pre_act = helper.append_bias_op(out, bias, dim_start=1)
    return helper.append_activation(pre_act, act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, name=None) -> Variable:
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("pool2d", {"X": [input]}, {"Out": [out]},
                     {"ksize": _pair(pool_size),
                      "pooling_type": "avg" if pool_type == "avg" else "max",
                      "strides": _pair(pool_stride),
                      "paddings": _pair(pool_padding),
                      "global_pooling": global_pooling,
                      "ceil_mode": ceil_mode, "exclusive": exclusive})
    return out


def adaptive_pool2d(input, pool_size, pool_type="max", name=None):
    """A pool2d whose windows tile the map into pool_size cells: stride
    h // oh, window h - (oh - 1) * stride (and likewise along w)."""
    h, w = int(input.shape[2]), int(input.shape[3])
    oh, ow = (pool_size if isinstance(pool_size, (list, tuple))
              else (pool_size, pool_size))
    stride = [h // oh, w // ow]
    ksize = [h - (oh - 1) * stride[0], w - (ow - 1) * stride[1]]
    return pool2d(input, ksize, pool_type, stride, 0, name=name)


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               moving_mean_name=None, moving_variance_name=None,
               use_global_stats=False, name=None) -> Variable:
    """Scale (1) and bias (0) are trainable params; the moving mean (0)
    and variance (1) are params with ``trainable=False``, which the op
    writes back in place (MeanOut / VarianceOut); SavedMean and
    SavedVariance are stop-gradient temporaries."""
    helper = LayerHelper("batch_norm", name=name)
    c = int(input.shape[1 if data_layout == "NCHW" else -1])
    scale = helper.create_parameter(
        param_attr, shape=[c], dtype="float32",
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(bias_attr, shape=[c], dtype="float32",
                                   is_bias=True)
    mean = helper.create_parameter(
        ParamAttr(name=moving_mean_name, trainable=False,
                  initializer=ConstantInitializer(0.0)),
        shape=[c], dtype="float32")
    variance = helper.create_parameter(
        ParamAttr(name=moving_variance_name, trainable=False,
                  initializer=ConstantInitializer(1.0)),
        shape=[c], dtype="float32")
    saved_mean = helper.create_variable_for_type_inference(
        "float32", stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        "float32", stop_gradient=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "batch_norm",
        {"X": [input], "Scale": [scale], "Bias": [bias],
         "Mean": [mean], "Variance": [variance]},
        {"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
         "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        {"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
         "data_layout": data_layout, "use_global_stats": use_global_stats})
    return helper.append_activation(out, act)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None) -> Variable:
    helper = LayerHelper("layer_norm", name=name)
    norm_shape = [math.prod(int(d) for d in input.shape[begin_norm_axis:])]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(
            param_attr, shape=norm_shape, dtype="float32",
            default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(bias_attr, shape=norm_shape,
                                    dtype="float32", is_bias=True)
        inputs["Bias"] = [b]
    out = helper.create_variable_for_type_inference(input.dtype)
    mean = helper.create_variable_for_type_inference("float32", True)
    var = helper.create_variable_for_type_inference("float32", True)
    helper.append_op("layer_norm", inputs,
                     {"Y": [out], "Mean": [mean], "Variance": [var]},
                     {"begin_norm_axis": begin_norm_axis,
                      "epsilon": epsilon})
    return helper.append_activation(out, act)


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, name=None) -> Variable:
    """Scale (1) and bias (0) of [C], f32; Mean and Variance [N, groups]
    are stop-gradient temporaries.  ``param_attr`` / ``bias_attr`` False
    leave the op without Scale / Bias."""
    helper = LayerHelper("group_norm", name=name)
    c = int(input.shape[1])
    inputs = {"X": [input]}
    if param_attr is not False:
        s = helper.create_parameter(
            param_attr, shape=[c], dtype="float32",
            default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [s]
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, shape=[c], dtype="float32",
                                    is_bias=True)
        inputs["Bias"] = [b]
    out = helper.create_variable_for_type_inference(input.dtype)
    mean = helper.create_variable_for_type_inference("float32", True)
    var = helper.create_variable_for_type_inference("float32", True)
    helper.append_op("group_norm", inputs,
                     {"Y": [out], "Mean": [mean], "Variance": [var]},
                     {"groups": groups, "epsilon": epsilon})
    return helper.append_activation(out, act)


def dropout(x, dropout_prob, is_test=False, seed=None,
            dropout_implementation="downgrade_in_infer", name=None):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference("uint8", True)
    helper.append_op("dropout", {"X": [x]},
                     {"Out": [out], "Mask": [mask]},
                     {"dropout_prob": dropout_prob, "is_test": is_test,
                      "seed": seed or 0,
                      "dropout_implementation": dropout_implementation})
    return out


def softmax(input, axis=-1, name=None):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("softmax", {"X": [input]}, {"Out": [out]},
                     {"axis": axis})
    return out


def log_softmax(input, axis=-1, name=None):
    helper = LayerHelper("log_softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("log_softmax", {"X": [input]}, {"Out": [out]},
                     {"axis": axis})
    return out


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("cross_entropy",
                     {"X": [input], "Label": [label]}, {"Y": [out]},
                     {"soft_label": soft_label,
                      "ignore_index": ignore_index})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100):
    helper = LayerHelper("softmax_with_cross_entropy")
    loss = helper.create_variable_for_type_inference(logits.dtype)
    sm = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op("softmax_with_cross_entropy",
                     {"Logits": [logits], "Label": [label]},
                     {"Loss": [loss], "Softmax": [sm]},
                     {"soft_label": soft_label,
                      "ignore_index": ignore_index})
    return loss


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("square_error_cost",
                     {"X": [input], "Label": [label]}, {"Out": [out]}, {})
    return out


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mean", {"X": [x]}, {"Out": [out]}, {})
    return out


def _reduce_layer(op_name):
    def f(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_name, name=name)
        out = helper.create_variable_for_type_inference(input.dtype)
        attrs = {"keep_dim": keep_dim,
                 "reduce_all": dim is None,
                 "dim": [0] if dim is None else (
                     dim if isinstance(dim, (list, tuple)) else [dim])}
        helper.append_op(op_name, {"X": [input]}, {"Out": [out]}, attrs)
        return out
    f.__name__ = op_name
    return f


reduce_sum = _reduce_layer("reduce_sum")
reduce_mean = _reduce_layer("reduce_mean")
reduce_max = _reduce_layer("reduce_max")
reduce_min = _reduce_layer("reduce_min")
reduce_prod = _reduce_layer("reduce_prod")


def reshape(x, shape, name=None):
    helper = LayerHelper("reshape", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("reshape", {"X": [x]}, {"Out": [out]},
                     {"shape": list(shape)})
    return out


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("transpose", {"X": [x]}, {"Out": [out]},
                     {"axis": list(perm)})
    return out


def split(input, num_or_sections, dim=0, name=None):
    helper = LayerHelper("split", name=name)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "sections": [], "axis": dim}
    else:
        n = len(num_or_sections)
        attrs = {"num": 0, "sections": list(num_or_sections), "axis": dim}
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(n)]
    helper.append_op("split", {"X": [input]}, {"Out": outs}, attrs)
    return outs


def stack(x: Sequence[Variable], axis=0):
    helper = LayerHelper("stack")
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op("stack", {"X": list(x)}, {"Y": [out]}, {"axis": axis})
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    n = num if num is not None else int(x.shape[axis])
    outs = [helper.create_variable_for_type_inference(x.dtype)
            for _ in range(n)]
    helper.append_op("unstack", {"X": [x]}, {"Y": outs}, {"axis": axis})
    return outs


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("squeeze", {"X": [input]}, {"Out": [out]},
                     {"axes": list(axes)})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("unsqueeze", {"X": [input]}, {"Out": [out]},
                     {"axes": list(axes)})
    return out


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("flatten", {"X": [x]}, {"Out": [out]}, {"axis": axis})
    return out


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("expand", {"X": [x]}, {"Out": [out]},
                     {"expand_times": list(expand_times)})
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("slice", {"Input": [input]}, {"Out": [out]},
                     {"axes": list(axes), "starts": list(starts),
                      "ends": list(ends)})
    return out


def gather(input, index, axis=0):
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("gather", {"X": [input], "Index": [index]},
                     {"Out": [out]}, {"axis": axis})
    return out


def scatter(input, index, updates, overwrite=True):
    helper = LayerHelper("scatter")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("scatter",
                     {"X": [input], "Ids": [index], "Updates": [updates]},
                     {"Out": [out]}, {"overwrite": overwrite})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("matmul", {"X": [x], "Y": [y]}, {"Out": [out]},
                     {"transpose_X": transpose_x, "transpose_Y": transpose_y,
                      "alpha": alpha})
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mul", {"X": [x], "Y": [y]}, {"Out": [out]},
                     {"x_num_col_dims": x_num_col_dims,
                      "y_num_col_dims": y_num_col_dims})
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    vals = helper.create_variable_for_type_inference(input.dtype)
    ids = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("top_k", {"X": [input]},
                     {"Out": [vals], "Indices": [ids]}, {"k": int(k)})
    return vals, ids


def accuracy(input, label, k=1, name=None):
    """top_k, then the accuracy op (ref layers/metric_op.py)."""
    vals, ids = topk(input, k)
    helper = LayerHelper("accuracy", name=name)
    acc = helper.create_variable_for_type_inference("float32", True)
    correct = helper.create_variable_for_type_inference("int32", True)
    total = helper.create_variable_for_type_inference("int32", True)
    helper.append_op("accuracy",
                     {"Out": [vals], "Indices": [ids], "Label": [label]},
                     {"Accuracy": [acc], "Correct": [correct],
                      "Total": [total]}, {})
    return acc


def auc(input, label, num_thresholds=4095, name=None):
    """ref layers/metric_op.py auc: the streaming AUC, its histograms
    persistable [num_thresholds + 1] f32 vars that the op reads and
    writes back.  Returns (AUC, [stat_pos, stat_neg])."""
    helper = LayerHelper("auc", name=name)
    stats = [helper.create_parameter(
        ParamAttr(name=helper.name(stat), trainable=False,
                  initializer=ConstantInitializer(0.0)),
        shape=[num_thresholds + 1], dtype="float32")
        for stat in ("stat_pos", "stat_neg")]
    auc_out = helper.create_variable_for_type_inference("float32", True)
    helper.append_op("auc",
                     {"Predict": [input], "Label": [label],
                      "StatPos": [stats[0]], "StatNeg": [stats[1]]},
                     {"AUC": [auc_out], "StatPosOut": [stats[0]],
                      "StatNegOut": [stats[1]]},
                     {"num_thresholds": num_thresholds})
    return auc_out, stats


def one_hot(input, depth):
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op("one_hot", {"X": [input]}, {"Out": [out]},
                     {"depth": int(depth)})
    return out


def clip(x, min, max, name=None):  # noqa: A002 - the reference's names
    helper = LayerHelper("clip", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("clip", {"X": [x]}, {"Out": [out]},
                     {"min": float(min), "max": float(max)})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("clip_by_norm", {"X": [x]}, {"Out": [out]},
                     {"max_norm": float(max_norm)})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, name=None):
    helper = LayerHelper("scale", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("scale", {"X": [x]}, {"Out": [out]},
                     {"scale": float(scale), "bias": float(bias),
                      "bias_after_scale": bias_after_scale})
    return out


def elementwise_op_layer(op_name):
    def f(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_name, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(op_name, {"X": [x], "Y": [y]}, {"Out": [out]},
                         {"axis": axis})
        return helper.append_activation(out, act)
    f.__name__ = op_name
    return f


elementwise_add = elementwise_op_layer("elementwise_add")
elementwise_sub = elementwise_op_layer("elementwise_sub")
elementwise_mul = elementwise_op_layer("elementwise_mul")
elementwise_div = elementwise_op_layer("elementwise_div")
elementwise_max = elementwise_op_layer("elementwise_max")
elementwise_min = elementwise_op_layer("elementwise_min")
elementwise_pow = elementwise_op_layer("elementwise_pow")


def _unary_layer(op_name):
    def f(x, name=None, **attrs):
        helper = LayerHelper(op_name, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(op_name, {"X": [x]}, {"Out": [out]}, attrs)
        return out
    f.__name__ = op_name
    return f


# the activations and unary math as layers (the reference generates
# layers/ops.py from its OpProtos; JAX's list, layers/nn.py:587-596)
UNARY_LAYERS = ("relu", "sigmoid", "logsigmoid", "tanh", "tanh_shrink",
                "exp", "sqrt", "rsqrt", "abs", "ceil", "floor", "cos", "sin",
                "round", "reciprocal", "log", "square", "softplus",
                "softsign", "elu", "relu6", "stanh", "hard_shrink",
                "softshrink", "hard_sigmoid", "swish", "hard_swish", "mish",
                "thresholded_relu", "erf", "selu", "sign", "gelu",
                "leaky_relu", "brelu", "soft_relu")
for _name in UNARY_LAYERS:
    globals()[_name] = _unary_layer(_name)
del _name
__all__ += list(UNARY_LAYERS)


def pow(x, factor=1.0, name=None):  # noqa: A001 - the reference's name
    helper = LayerHelper("pow", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("pow", {"X": [x]}, {"Out": [out]}, {"factor": factor})
    return out


def prelu(x, mode="all", param_attr=None, name=None):
    """x where x > 0, else alpha * x, with one alpha (``all``), one a
    channel or one an element of a sample, initialized to 0.25."""
    helper = LayerHelper("prelu", name=name)
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [int(x.shape[1])]
    else:
        alpha_shape = [math.prod(int(d) for d in x.shape[1:])]
    alpha = helper.create_parameter(
        param_attr, shape=alpha_shape, dtype=x.dtype,
        default_initializer=ConstantInitializer(0.25))
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("prelu", {"X": [x], "Alpha": [alpha]}, {"Out": [out]},
                     {"mode": mode})
    return out


def maxout(x, groups, name=None):
    helper = LayerHelper("maxout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("maxout", {"X": [x]}, {"Out": [out]},
                     {"groups": groups})
    return out


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    helper = LayerHelper("lrn", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    mid = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op("lrn", {"X": [input]},
                     {"Out": [out], "MidOut": [mid]},
                     {"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("pad", {"X": [x]}, {"Out": [out]},
                     {"paddings": list(paddings),
                      "pad_value": float(pad_value)})
    return out


def pad2d(input, paddings, mode="constant", pad_value=0.0, name=None):
    helper = LayerHelper("pad2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("pad2d", {"X": [input]}, {"Out": [out]},
                     {"paddings": list(paddings), "mode": mode,
                      "pad_value": float(pad_value)})
    return out


def image_resize(input, out_shape=None, scale=None, resample="BILINEAR",
                 align_corners=True, name=None):
    """An ``interpolate`` op: bilinear or nearest, to ``out_shape`` (h,
    w) or by ``scale``."""
    helper = LayerHelper("interpolate", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    method = "bilinear" if resample.upper() == "BILINEAR" else "nearest"
    attrs = {"interp_method": method, "align_corners": align_corners}
    if out_shape is not None:
        attrs["out_h"], attrs["out_w"] = int(out_shape[0]), int(out_shape[1])
    if scale is not None:
        attrs["scale"] = scale
    helper.append_op("interpolate", {"X": [input]}, {"Out": [out]}, attrs)
    return out


resize_bilinear = image_resize


def resize_nearest(input, out_shape=None, scale=None, name=None):
    return image_resize(input, out_shape, scale, "NEAREST", name=name)


def sequence_mask(x, maxlen, dtype="int64"):
    """[B, maxlen] 1 where a step is below the row's length in x (a
    static ``maxlen``)."""
    helper = LayerHelper("sequence_mask")
    out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op("sequence_mask", {"X": [x]}, {"Y": [out]},
                     {"maxlen": int(maxlen), "out_dtype": str(dtype)})
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("norm", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    norm = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("norm", {"X": [x]}, {"Out": [out], "Norm": [norm]},
                     {"axis": axis, "epsilon": epsilon})
    return out


def cos_sim(x, y):
    helper = LayerHelper("cos_sim")
    out = helper.create_variable_for_type_inference(x.dtype)
    xn = helper.create_variable_for_type_inference(x.dtype, True)
    yn = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op("cos_sim", {"X": [x], "Y": [y]},
                     {"Out": [out], "XNorm": [xn], "YNorm": [yn]}, {})
    return out


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      normalize=False, name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("sigmoid_cross_entropy_with_logits",
                     {"X": [x], "Label": [label]}, {"Out": [out]},
                     {"ignore_index": ignore_index, "normalize": normalize})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=1.0):
    helper = LayerHelper("smooth_l1_loss")
    loss = helper.create_variable_for_type_inference(x.dtype)
    diff = helper.create_variable_for_type_inference(x.dtype, True)
    inputs = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight]
    helper.append_op("smooth_l1_loss", inputs,
                     {"Out": [loss], "Diff": [diff]}, {"sigma": sigma})
    return loss


def huber_loss(input, label, delta):
    helper = LayerHelper("huber_loss")
    out = helper.create_variable_for_type_inference(input.dtype)
    residual = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op("huber_loss", {"X": [input], "Y": [label]},
                     {"Out": [out], "Residual": [residual]},
                     {"delta": float(delta)})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """(1 - eps) * label + eps * prior, composed of ``scale`` ops (and an
    ``elementwise_add`` with a prior) as the JAX layer composes it; the
    ``label_smooth`` op itself is ops/misc_ops.py's."""
    smoothed = scale(label, 1.0 - epsilon)
    k = int(label.shape[-1])
    if prior_dist is not None:
        return elementwise_add(smoothed, scale(prior_dist, epsilon))
    return scale(smoothed, 1.0, bias=epsilon / k)


def uniform_random_batch_size_like(input, shape, dtype="float32", min=-1.0,
                                   max=1.0, input_dim_idx=0,
                                   output_dim_idx=0, seed=0):
    helper = LayerHelper("uniform_random_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("uniform_random_batch_size_like", {"Input": [input]},
                     {"Out": [out]},
                     {"shape": list(shape), "dtype": str(dtype),
                      "min": float(min), "max": float(max), "seed": seed,
                      "input_dim_idx": input_dim_idx,
                      "output_dim_idx": output_dim_idx})
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("gaussian_random", {}, {"Out": [out]},
                     {"shape": list(shape), "dtype": str(dtype),
                      "mean": mean, "std": std, "seed": seed})
    return out


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("uniform_random", {}, {"Out": [out]},
                     {"shape": list(shape), "dtype": str(dtype),
                      "min": float(min), "max": float(max), "seed": seed})
    return out


def _binary_compare_layer(op_name, out_dtype="bool"):
    def f(x, y, cond=None, name=None):
        helper = LayerHelper(op_name, name=name)
        out = (cond if cond is not None
               else helper.create_variable_for_type_inference(out_dtype))
        helper.append_op(op_name, {"X": [x], "Y": [y]}, {"Out": [out]}, {})
        return out
    f.__name__ = op_name
    return f


less_than = _binary_compare_layer("less_than")
less_equal = _binary_compare_layer("less_equal")
greater_than = _binary_compare_layer("greater_than")
greater_equal = _binary_compare_layer("greater_equal")
equal = _binary_compare_layer("equal")
not_equal = _binary_compare_layer("not_equal")
logical_and = _binary_compare_layer("logical_and")
logical_or = _binary_compare_layer("logical_or")
logical_xor = _binary_compare_layer("logical_xor")


def logical_not(x, out=None, name=None):
    helper = LayerHelper("logical_not", name=name)
    out = (out if out is not None
           else helper.create_variable_for_type_inference("bool"))
    helper.append_op("logical_not", {"X": [x]}, {"Out": [out]}, {})
    return out


def increment(x, value=1.0, in_place=True, name=None):
    """x + value, written into x itself by default (an ``increment``
    op)."""
    helper = LayerHelper("increment", name=name)
    out = x if in_place else helper.create_variable_for_type_inference(
        x.dtype)
    helper.append_op("increment", {"X": [x]}, {"Out": [out]},
                     {"step": float(value)})
    return out


def _suffixed_param_attr(param_attr, suffix):
    """A shared named param_attr would alias all of a layer's projections
    to one parameter; derive a unique name per projection instead."""
    a = ParamAttr._to_attr(param_attr)
    if a is not None and a.name:
        a = copy.copy(a)
        a.name = f"{a.name}.{suffix}"
    return a


def fused_mha(x, n_head, causal=False, kv=None, size=None, out_size=None,
              param_attr=None, name=None):
    """Projection-fused multi-head attention: ONE op owning Wq/Wk/Wv
    [D, E] and Wo [E, out_size], lowered through the head-major flash
    kernel (ops/attention_ops.py).  x: [B, T, D]; kv: optional [B, Tk, Dk]
    for cross-attention (causal must be False).  E = size or D; returns
    [B, T, out_size or D]."""
    helper = LayerHelper("fused_mha", name=name)
    D = int(x.shape[-1])
    E = int(size or D)
    check_arg(E % n_head == 0,
              f"fused_mha: model width {E} is not divisible by "
              f"n_head={n_head}")
    d_out = int(out_size or D)
    src = kv if kv is not None else x
    Dk = int(src.shape[-1])

    def attr(sfx):
        return _suffixed_param_attr(param_attr, sfx)

    wq = helper.create_parameter(attr("q"), shape=[D, E], dtype=x.dtype)
    wk = helper.create_parameter(attr("k"), shape=[Dk, E], dtype=x.dtype)
    wv = helper.create_parameter(attr("v"), shape=[Dk, E], dtype=x.dtype)
    wo = helper.create_parameter(attr("o"), shape=[E, d_out],
                                 dtype=x.dtype)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": [x], "Wq": [wq], "Wk": [wk], "Wv": [wv], "Wo": [wo]}
    if kv is not None:
        inputs["XKV"] = [kv]
    helper.append_op("fused_mha", inputs, {"Out": [out]},
                     {"n_head": n_head, "causal": causal})
    return out


def fused_attention_qkv(q, k, v, n_head, causal=False, name=None):
    """Flash attention on pre-projected q/k/v [B, T, n_head*d] (the
    projections live in the caller): one ``fused_attention`` op, lowered
    through the flash kernel (ops/attention_ops.py).  No attention-prob
    dropout on this path."""
    helper = LayerHelper("fused_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    helper.append_op("fused_attention", {"Q": [q], "K": [k], "V": [v]},
                     {"Out": [out]}, {"n_head": n_head, "causal": causal})
    return out


def fused_multihead_attention(queries, keys, values, n_head, causal=False,
                              param_attr=None, name=None):
    """Projected multi-head attention (JAX layers/nn.py:820-857):
    queries/keys/values [B, T, D] -> [B, T, D] through three ``matmul``
    projections, ONE ``fused_attention`` op (the flash kernel on the card)
    and the output ``matmul``, under JAX's parameter names.  The
    projections are plain matmul ops, so FLAGS_quantize_dtype reaches
    them."""
    helper = LayerHelper("fused_attention", name=name)
    d_model = int(queries.shape[-1])
    projs = []
    for x, sfx in zip((queries, keys, values), ("q", "k", "v")):
        w = helper.create_parameter(_suffixed_param_attr(param_attr, sfx),
                                    shape=[d_model, d_model],
                                    dtype=queries.dtype)
        out = helper.create_variable_for_type_inference(queries.dtype)
        helper.append_op("matmul", {"X": [x], "Y": [w]}, {"Out": [out]}, {})
        projs.append(out)
    att = helper.create_variable_for_type_inference(queries.dtype)
    helper.append_op("fused_attention",
                     {"Q": [projs[0]], "K": [projs[1]], "V": [projs[2]]},
                     {"Out": [att]}, {"n_head": n_head, "causal": causal})
    wo = helper.create_parameter(_suffixed_param_attr(param_attr, "o"),
                                 shape=[d_model, d_model],
                                 dtype=queries.dtype)
    out = helper.create_variable_for_type_inference(queries.dtype)
    helper.append_op("matmul", {"X": [att], "Y": [wo]}, {"Out": [out]}, {})
    return out


def fused_lm_head_loss(x, vocab_size, label, param_attr=None,
                       chunk_size=4096, unroll=False, name=None):
    """LM head + mean softmax-CE in ONE op that owns the [D, V] head
    weight: replaces fc -> softmax_with_cross_entropy -> mean without
    materializing [N, V] logits (ops/attention_ops.py)."""
    helper = LayerHelper("fused_lm_head_loss", name=name)
    d = int(x.shape[-1])
    w = helper.create_parameter(param_attr, shape=[d, vocab_size],
                                dtype=x.dtype)
    loss = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("fused_lm_head_loss",
                     {"X": [x], "W": [w], "Label": [label]},
                     {"Loss": [loss]}, {"chunk_size": chunk_size,
                                        "unroll": unroll})
    return loss


def where(condition, x, y):
    helper = LayerHelper("where")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("where", {"Condition": [condition], "X": [x],
                               "Y": [y]}, {"Out": [out]}, {})
    return out
