"""Sequence-family and remaining layer wrappers (counterpart of
paddle_tpu/layers/sequence.py, all of it but detection's affine_grid
:527, roi_pool :460, roi_align :475 and psroi_pool :489): sequence_conv
:41, sequence_context :63, sequence_pool :76, sequence_first_step :86,
sequence_last_step :90, sequence_softmax :94, sequence_concat :101,
sequence_slice :106, sequence_expand :112, sequence_expand_as :117,
sequence_pad :122, sequence_unpad :137, sequence_reshape :142,
sequence_enumerate :147, sequence_scatter :153, sequence_reverse :159,
lod_reset :167, linear_chain_crf :178, crf_decoding :200, chunk_eval
:242, warpctc :263, ctc_greedy_decoder :275, edit_distance :287 (with
``ignored_tokens`` as sequence_erase ops), nce :312, hsigmoid :335,
sampling_id :354,
beam_search :362, beam_search_decode :384, the vision extras conv3d
:399, conv3d_transpose :419, pool3d :437 and adaptive_pool3d :448,
im2sequence :502, grid_sampler :514, affine_channel :533,
space_to_depth :554, crop :559, pad_constant_like :565,
image_resize_short :570, random_crop :582, bpr_loss :589, rank_loss
:594, margin_rank_loss :600, log_loss :611, dice_loss :618 (composed of
element and reduce ops, as JAX's is), mean_iou :642, multiplex :657,
row_conv :662, bilinear_tensor_product :675, add_position_encoding
:690, similarity_focus :695, hash :701, merge_selected_rows :707,
get_tensor_from_selected_rows :717, shape :723, sum :727,
gaussian_random_batch_size_like :732, autoincreased_step_counter :739,
lstm :762 (the cudnn_lstm op), dynamic_lstmp :796 and scale_sub_region
:818.

The reference's sequence layers read LoD tensors; here, as in the JAX
package, a sequence is a padded [B, T, ...] tensor with an optional
[B, T] mask.  Each function appends the JAX package's op with its slots
and attrs, so both builds serialize alike.
"""
from __future__ import annotations

import warnings
from typing import List, Union

from ..framework.initializer import ConstantInitializer
from ..framework.layer_helper import LayerHelper, ParamAttr
from ..framework.program import Variable

__all__ = ["sequence_conv", "sequence_context", "sequence_pool",
           "sequence_first_step", "sequence_last_step", "sequence_softmax",
           "sequence_concat", "sequence_slice", "sequence_expand",
           "sequence_expand_as", "sequence_pad", "sequence_unpad",
           "sequence_reshape", "sequence_enumerate", "sequence_scatter",
           "sequence_reverse", "lod_reset", "chunk_eval", "warpctc",
           "ctc_greedy_decoder", "nce", "hsigmoid", "im2sequence",
           "grid_sampler", "affine_channel", "random_crop", "row_conv",
           "add_position_encoding", "similarity_focus", "hash",
           "merge_selected_rows", "get_tensor_from_selected_rows", "lstm",
           "dynamic_lstmp", "scale_sub_region",
           "linear_chain_crf", "crf_decoding",
           "beam_search", "beam_search_decode", "conv3d",
           "conv3d_transpose", "pool3d", "adaptive_pool3d", "sum",
           "autoincreased_step_counter", "edit_distance", "sampling_id",
           "space_to_depth", "crop", "pad_constant_like",
           "image_resize_short", "bpr_loss", "rank_loss",
           "margin_rank_loss", "log_loss", "dice_loss", "mean_iou",
           "multiplex", "bilinear_tensor_product", "shape",
           "gaussian_random_batch_size_like"]


def _simple(op_type, ins, attrs, dtype, out_slot="Out", name=None):
    """Append one op; return its output."""
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(op_type, ins, {out_slot: [out]}, attrs)
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  name=None):
    """A context-window convolution over the time axis of [B, T, D]."""
    helper = LayerHelper("sequence_conv", name=name)
    d = int(input.shape[-1])
    w = helper.create_parameter(param_attr,
                                shape=[filter_size * d, num_filters],
                                dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("sequence_conv", {"X": [input], "Filter": [w]},
                     {"Out": [out]},
                     {"contextLength": filter_size,
                      "contextStride": filter_stride,
                      "contextStart": -(filter_size // 2)})
    bias = helper.create_parameter(bias_attr, shape=[num_filters],
                                   dtype=input.dtype, is_bias=True)
    out = helper.append_bias_op(out, bias, dim_start=2)
    return helper.append_activation(out, act)


def sequence_context(input, context_length, context_start=None,
                     name=None):
    """The sliding-window concat over time: [B, T, D] -> [B, T,
    context_length * D], zeros past the edges (v2's context_projection
    without weights)."""
    attrs = {"context_length": int(context_length)}
    if context_start is not None:
        attrs["context_start"] = int(context_start)
    return _simple("sequence_context", {"X": [input]}, attrs,
                   input.dtype, name=name)


def sequence_pool(input, pool_type, mask=None, is_test=False, name=None):
    """SUM, AVERAGE, MAX, SQRT, LAST or FIRST over the time axis of [B,
    T, D], with an optional [B, T] mask."""
    ins = {"X": [input]}
    if mask is not None:
        ins["Mask"] = [mask]
    return _simple("sequence_pool", ins, {"pooltype": pool_type.upper()},
                   input.dtype, name=name)


def sequence_first_step(input, mask=None):
    return sequence_pool(input, "FIRST", mask=mask)


def sequence_last_step(input, mask=None):
    return sequence_pool(input, "LAST", mask=mask)


def sequence_softmax(input, mask=None, name=None):
    ins = {"X": [input]}
    if mask is not None:
        ins["Mask"] = [mask]
    return _simple("sequence_softmax", ins, {}, input.dtype, name=name)


def sequence_concat(input: List[Variable], name=None):
    return _simple("sequence_concat", {"X": list(input)}, {},
                   input[0].dtype, name=name)


def sequence_slice(input, offset, length, name=None):
    return _simple("sequence_slice", {"X": [input]},
                   {"offset": int(offset), "length": int(length)},
                   input.dtype, name=name)


def sequence_expand(x, y, ref_level=-1, name=None):
    return _simple("sequence_expand", {"X": [x], "Y": [y]},
                   {"ref_level": ref_level}, x.dtype, name=name)


def sequence_expand_as(x, y, name=None):
    return _simple("sequence_expand_as", {"X": [x], "Y": [y]}, {},
                   x.dtype, name=name)


def sequence_pad(x, pad_value=0.0, maxlen=None, length=None, name=None):
    """(padded, length), as the reference returns them."""
    ins = {"X": [x]}
    if length is not None:
        ins["Length"] = [length]
    helper = LayerHelper("sequence_pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out_len = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("sequence_pad", ins,
                     {"Out": [out], "Length": [out_len]},
                     {"padded_length": int(maxlen or -1),
                      "pad_value": pad_value})
    return out, out_len


def sequence_unpad(x, length, name=None):
    return _simple("sequence_unpad", {"X": [x], "Length": [length]}, {},
                   x.dtype, name=name)


def sequence_reshape(input, new_dim, name=None):
    return _simple("sequence_reshape", {"X": [input]},
                   {"new_dim": int(new_dim)}, input.dtype, name=name)


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    return _simple("sequence_enumerate", {"X": [input]},
                   {"win_size": int(win_size), "pad_value": int(pad_value)},
                   input.dtype, name=name)


def sequence_scatter(input, index, updates, name=None):
    return _simple("sequence_scatter",
                   {"X": [input], "Ids": [index], "Updates": [updates]},
                   {}, input.dtype, name=name)


def sequence_reverse(x, length=None, name=None):
    ins = {"X": [x]}
    if length is not None:
        ins["Length"] = [length]
    return _simple("sequence_reverse", ins, {}, x.dtype, out_slot="Y",
                   name=name)


def lod_reset(x, y=None, target_lod=None, name=None):
    ins = {"X": [x]}
    if y is not None:
        ins["Y"] = [y]
    return _simple("lod_reset", ins,
                   {"target_lod": list(target_lod or [])}, x.dtype,
                   name=name)


def linear_chain_crf(input, label, mask=None, param_attr=None, name=None):
    """Emission [B, T, N] and label [B, T] -> LogLikelihood [B, 1]; owns
    the Transition parameter [N+2, N] (the start and stop rows first)."""
    helper = LayerHelper("linear_chain_crf", name=name)
    n_tags = int(input.shape[-1])
    trans = helper.create_parameter(param_attr, shape=[n_tags + 2, n_tags],
                                    dtype=input.dtype)
    ll = helper.create_variable_for_type_inference(input.dtype)
    alpha = helper.create_variable_for_type_inference(input.dtype, True)
    em_exps = helper.create_variable_for_type_inference(input.dtype, True)
    tr_exps = helper.create_variable_for_type_inference(input.dtype, True)
    ins = {"Emission": [input], "Transition": [trans], "Label": [label]}
    if mask is not None:
        ins["Mask"] = [mask]
    helper.append_op("linear_chain_crf", ins,
                     {"LogLikelihood": [ll], "Alpha": [alpha],
                      "EmissionExps": [em_exps],
                      "TransitionExps": [tr_exps]}, {})
    return ll


def crf_decoding(input, param_attr, label=None, mask=None, name=None):
    """Viterbi decode with the Transition parameter that linear_chain_crf
    made, found by the name in `param_attr`.  A program without a var of
    that name (a standalone decode program) creates the parameter here,
    and its trained value arrives through the scope; a program that also
    holds a linear_chain_crf warns, since a misspelt name would decode
    with untrained transitions.  The check runs when this layer is built,
    so build the CRF cost first."""
    helper = LayerHelper("crf_decoding", name=name)
    attr = ParamAttr._to_attr(param_attr)
    block = helper.main_program.global_block()
    if attr.name and block.has_var(attr.name):
        trans = block.var(attr.name)
    else:
        if attr.name and any(op.type == "linear_chain_crf"
                             for op in block.ops):
            warnings.warn(
                f"crf_decoding: no variable named {attr.name!r} in a "
                f"program that contains linear_chain_crf; creating a fresh "
                f"Transition parameter.  Pass the same param name as the "
                f"CRF layer, or the decode uses untrained transitions.",
                stacklevel=2)
        n_tags = int(input.shape[-1])
        trans = helper.create_parameter(
            attr, shape=[n_tags + 2, n_tags], dtype=input.dtype)
    out = helper.create_variable_for_type_inference("int64")
    ins = {"Emission": [input], "Transition": [trans]}
    if label is not None:
        ins["Label"] = [label]
    if mask is not None:
        ins["Mask"] = [mask]
    helper.append_op("crf_decoding", ins, {"ViterbiPath": [out]}, {})
    return out


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, mask=None, name=None):
    """(precision, recall, F1, inferred chunks, label chunks, correct
    chunks), each declared float32 as JAX's layer declares them."""
    helper = LayerHelper("chunk_eval", name=name)
    outs, vars_ = {}, []
    for n in ("Precision", "Recall", "F1-Score", "NumInferChunks",
              "NumLabelChunks", "NumCorrectChunks"):
        v = helper.create_variable_for_type_inference("float32", True)
        outs[n] = [v]
        vars_.append(v)
    ins = {"Inference": [input], "Label": [label]}
    if mask is not None:
        ins["Mask"] = [mask]
    helper.append_op("chunk_eval", ins, outs,
                     {"chunk_scheme": chunk_scheme,
                      "num_chunk_types": num_chunk_types,
                      "excluded_chunk_types": excluded_chunk_types or []})
    return tuple(vars_)


def warpctc(input, label, blank=0, norm_by_times=False,
            input_length=None, label_length=None, name=None):
    """The CTC loss [B, 1] of logits [B, T, C] against labels [B, S]."""
    ins = {"Logits": [input], "Label": [label]}
    if input_length is not None:
        ins["LogitsLength"] = [input_length]
    if label_length is not None:
        ins["LabelLength"] = [label_length]
    return _simple("warpctc", ins,
                   {"blank": blank, "norm_by_times": norm_by_times},
                   input.dtype, out_slot="Loss", name=name)


def ctc_greedy_decoder(input, blank, name=None):
    """The greedy CTC decode: arg_max over the classes, then ctc_align's
    collapse of repeats and blanks."""
    helper = LayerHelper("ctc_greedy_decoder", name=name)
    am = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("arg_max", {"X": [input]}, {"Out": [am]},
                     {"axis": -1})
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op("ctc_align", {"Input": [am]}, {"Output": [out]},
                     {"blank": blank})
    return out


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=10, name=None):
    """Noise-contrastive estimation's cost [B, 1]; owns Weight [N, D] and
    Bias [N]."""
    helper = LayerHelper("nce", name=name)
    d = int(input.shape[-1])
    w = helper.create_parameter(param_attr,
                                shape=[num_total_classes, d],
                                dtype=input.dtype)
    b = helper.create_parameter(bias_attr, shape=[num_total_classes],
                                dtype=input.dtype, is_bias=True)
    cost = helper.create_variable_for_type_inference(input.dtype)
    s_logits = helper.create_variable_for_type_inference(input.dtype, True)
    s_labels = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("nce",
                     {"Input": [input], "Label": [label], "Weight": [w],
                      "Bias": [b]},
                     {"Cost": [cost], "SampleLogits": [s_logits],
                      "SampleLabels": [s_labels]},
                     {"num_total_classes": num_total_classes,
                      "num_neg_samples": num_neg_samples})
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None):
    """The hierarchical sigmoid's cost [B, 1]; owns W [num_classes - 1,
    D] and its Bias."""
    helper = LayerHelper("hsigmoid", name=name)
    d = int(input.shape[-1])
    w = helper.create_parameter(param_attr, shape=[num_classes - 1, d],
                                dtype=input.dtype)
    b = helper.create_parameter(bias_attr, shape=[num_classes - 1],
                                dtype=input.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    pre_out = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op("hierarchical_sigmoid",
                     {"X": [input], "Label": [label], "W": [w],
                      "Bias": [b]},
                     {"Out": [out], "PreOut": [pre_out]},
                     {"num_classes": num_classes})
    return out


def beam_search(pre_ids, pre_scores, log_probs, beam_size, end_id,
                state=None, name=None):
    """One dense expansion step (ops/beam_search_ops.py): returns (ids,
    scores, parents), with the reordered state last where `state` is
    given."""
    helper = LayerHelper("beam_search", name=name)
    ids = helper.create_variable_for_type_inference("int64")
    scores = helper.create_variable_for_type_inference(log_probs.dtype)
    parents = helper.create_variable_for_type_inference("int64", True)
    ins = {"PreIds": [pre_ids], "PreScores": [pre_scores],
           "LogProbs": [log_probs]}
    outs = {"Ids": [ids], "Scores": [scores], "Parents": [parents]}
    if state is not None:
        ins["State"] = [state]
        st = helper.create_variable_for_type_inference(state.dtype, True)
        outs["StateOut"] = [st]
    helper.append_op("beam_search", ins, outs,
                     {"beam_size": beam_size, "end_id": end_id})
    if state is not None:
        return ids, scores, parents, outs["StateOut"][0]
    return ids, scores, parents


def beam_search_decode(ids, parents, scores, beam_size=None, end_id=1,
                       name=None):
    """The hypotheses [B, K, T] and their scores [B, K] from the stacked
    per-step ids and parents [T, B, K]."""
    helper = LayerHelper("beam_search_decode", name=name)
    s_ids = helper.create_variable_for_type_inference("int64")
    s_scores = helper.create_variable_for_type_inference("float32")
    helper.append_op("beam_search_decode",
                     {"Ids": [ids], "Parents": [parents],
                      "Scores": [scores]},
                     {"SentenceIds": [s_ids], "SentenceScores": [s_scores]},
                     {"end_id": end_id})
    return s_ids, s_scores


def conv3d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=1, param_attr=None, bias_attr=None,
           act=None, name=None):
    """NCDHW input, OIDHW filter (Xavier, the helper's default); the
    bias an elementwise_add over dims from 1."""
    helper = LayerHelper("conv3d", name=name)
    k = (filter_size if isinstance(filter_size, (list, tuple))
         else (filter_size,) * 3)
    cin = int(input.shape[1])
    w = helper.create_parameter(
        param_attr, shape=[num_filters, cin // groups, *k],
        dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("conv3d", {"Input": [input], "Filter": [w]},
                     {"Output": [out]},
                     {"strides": stride, "paddings": padding,
                      "dilations": dilation, "groups": groups})
    bias = helper.create_parameter(bias_attr, shape=[num_filters],
                                   dtype=input.dtype, is_bias=True)
    out = helper.append_bias_op(out, bias, dim_start=1)
    return helper.append_activation(out, act)


def conv3d_transpose(input, num_filters, filter_size, stride=1, padding=0,
                     param_attr=None, bias_attr=None, act=None, name=None):
    """NCDHW input, IODHW filter [C_in, num_filters, kd, kh, kw]."""
    helper = LayerHelper("conv3d_transpose", name=name)
    k = (filter_size if isinstance(filter_size, (list, tuple))
         else (filter_size,) * 3)
    cin = int(input.shape[1])
    w = helper.create_parameter(param_attr,
                                shape=[cin, num_filters, *k],
                                dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("conv3d_transpose",
                     {"Input": [input], "Filter": [w]}, {"Output": [out]},
                     {"strides": stride, "paddings": padding})
    bias = helper.create_parameter(bias_attr, shape=[num_filters],
                                   dtype=input.dtype, is_bias=True)
    out = helper.append_bias_op(out, bias, dim_start=1)
    return helper.append_activation(out, act)


def pool3d(input, pool_size=2, pool_type="max", pool_stride=None,
           pool_padding=0, global_pooling=False, exclusive=True,
           name=None):
    return _simple("pool3d", {"X": [input]},
                   {"ksize": pool_size, "pooling_type": pool_type,
                    "strides": pool_stride or pool_size,
                    "paddings": pool_padding, "exclusive": exclusive,
                    "global_pooling": global_pooling},
                   input.dtype, name=name)


def adaptive_pool3d(input, pool_size, pool_type="max", name=None):
    """A pool3d whose windows tile the volume into pool_size cells, as
    layers.adaptive_pool2d tiles a map."""
    d, h, w = (int(input.shape[2]), int(input.shape[3]),
               int(input.shape[4]))
    od, oh, ow = (pool_size if isinstance(pool_size, (list, tuple))
                  else (pool_size,) * 3)
    stride = [d // od, h // oh, w // ow]
    ksize = [d - (od - 1) * stride[0], h - (oh - 1) * stride[1],
             w - (ow - 1) * stride[2]]
    return pool3d(input, ksize, pool_type, stride, 0, name=name)


def sum(x: Union[Variable, List[Variable]], name=None):  # noqa: A001
    """The elementwise sum of a list of vars (the ``sum`` op)."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    return _simple("sum", {"X": list(xs)}, {}, xs[0].dtype, name=name)


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """A persistable int64 counter that an ``increment_loop_counter`` op
    advances by `step` every run; its startup value is begin - step, so
    the first run reads `begin`."""
    helper = LayerHelper("autoincreased_step_counter")
    name = counter_name or "@step_counter@"
    block = helper.main_program.global_block()
    if block.has_var(name):
        return block.var(name)
    ctr = block.create_var(name=name, shape=[1], dtype="int64",
                           persistable=True, stop_gradient=True)
    sb = helper.startup_program.global_block()
    if not sb.has_var(name):
        sb.create_var(name=name, shape=[1], dtype="int64", persistable=True)
        sb.append_op("fill_constant", outputs={"Out": [name]},
                     attrs={"shape": [1], "dtype": "int64",
                            "value": int(begin) - int(step)})
    block.append_op("increment_loop_counter", {"X": [name]},
                    {"Out": [name]}, {"step": int(step)})
    return ctr


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  name=None):
    """(the Levenshtein distance of each row of ``input`` to ``label``'s,
    the number of rows); ``ignored_tokens`` are erased (set to the pad
    0) from both first."""
    helper = LayerHelper("edit_distance", name=name)
    if ignored_tokens:
        erased = []
        for v in (input, label):
            out = helper.create_variable_for_type_inference(v.dtype)
            helper.append_op("sequence_erase", {"X": [v]}, {"Out": [out]},
                             {"tokens": list(ignored_tokens)})
            erased.append(out)
        input, label = erased
    out = helper.create_variable_for_type_inference("float32")
    seq_num = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("edit_distance",
                     {"Hyps": [input], "Refs": [label]},
                     {"Out": [out], "SequenceNum": [seq_num]},
                     {"normalized": normalized})
    return out, seq_num


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="int64", name=None):  # noqa: A002
    return _simple("sampling_id", {"X": [x]},
                   {"min": min, "max": max, "seed": seed, "dtype": dtype},
                   dtype, name=name)


def im2sequence(input, filter_size=1, stride=1, padding=0,
                per_example=False, name=None):
    """Patches as rows: [N * oh * ow, C * kh * kw], or [N, oh * ow, C *
    kh * kw] with ``per_example``."""
    pads = (list(padding) if isinstance(padding, (list, tuple))
            else [padding] * 4)
    return _simple("im2sequence", {"X": [input]},
                   {"kernels": filter_size, "strides": stride,
                    "paddings": pads, "per_example": bool(per_example)},
                   input.dtype, name=name)


def grid_sampler(x, grid, name=None):
    return _simple("grid_sampler", {"X": [x], "Grid": [grid]}, {},
                   x.dtype, out_slot="Output", name=name)


def affine_channel(x, scale=None, bias=None, param_attr=None,
                   bias_attr=None, data_layout="NCHW", name=None):
    """scale * x + bias per channel; owns the two parameters (ones and
    zeros) where they are not passed."""
    helper = LayerHelper("affine_channel", name=name)
    c = int(x.shape[1 if data_layout == "NCHW" else -1])
    if scale is None:
        scale = helper.create_parameter(
            param_attr, shape=[c], dtype=x.dtype,
            default_initializer=ConstantInitializer(1.0))
    if bias is None:
        bias = helper.create_parameter(bias_attr, shape=[c],
                                       dtype=x.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("affine_channel",
                     {"X": [x], "Scale": [scale], "Bias": [bias]},
                     {"Out": [out]}, {"data_layout": data_layout})
    return out


def random_crop(x, shape, seed=None, name=None):
    return _simple("random_crop", {"X": [x]}, {"shape": list(shape)},
                   x.dtype, name=name)


def row_conv(input, future_context_size, param_attr=None, act=None,
             name=None):
    """The lookahead row convolution; owns Filter [future + 1, D]."""
    helper = LayerHelper("row_conv", name=name)
    d = int(input.shape[-1])
    w = helper.create_parameter(param_attr,
                                shape=[future_context_size + 1, d],
                                dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("row_conv", {"X": [input], "Filter": [w]},
                     {"Out": [out]}, {})
    return helper.append_activation(out, act)


def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    return _simple("add_position_encoding", {"X": [input]},
                   {"alpha": alpha, "beta": beta}, input.dtype, name=name)


def similarity_focus(input, axis, indexes, name=None):
    return _simple("similarity_focus", {"X": [input]},
                   {"axis": axis, "indexes": list(indexes)}, input.dtype,
                   name=name)


def hash(input, hash_size, num_hash=1, name=None):  # noqa: A001
    return _simple("hash", {"X": [input]},
                   {"mod_by": hash_size, "num_hash": num_hash}, "int64",
                   name=name)


def merge_selected_rows(ids, values, name=None):
    """(unique ids, their summed rows) of an (Ids, Values) pair."""
    helper = LayerHelper("merge_selected_rows", name=name)
    out_ids = helper.create_variable_for_type_inference("int64")
    out = helper.create_variable_for_type_inference(values.dtype)
    helper.append_op("merge_selected_rows",
                     {"Ids": [ids], "Values": [values]},
                     {"OutIds": [out_ids], "Out": [out]}, {})
    return out_ids, out


def get_tensor_from_selected_rows(ids, values, height, name=None):
    return _simple("get_tensor_from_selected_rows",
                   {"Ids": [ids], "Values": [values]},
                   {"height": height}, values.dtype, name=name)


def scale_sub_region(x, indices, value=1.0, name=None):
    """``value`` times each instance's CHW box of [B, C, H, W]; indices
    [B, 6], 1-based and inclusive (C0, C1, H0, H1, W0, W1)."""
    return _simple("scale_sub_region", {"X": [x], "Indices": [indices]},
                   {"value": float(value)}, x.dtype, name=name)


def space_to_depth(x, blocksize, name=None):
    return _simple("space_to_depth", {"X": [x]},
                   {"blocksize": blocksize}, x.dtype, name=name)


def crop(x, shape=None, offsets=None, name=None):
    return _simple("crop", {"X": [x]},
                   {"shape": list(shape or []),
                    "offsets": list(offsets or [])}, x.dtype, name=name)


def pad_constant_like(x, y, pad_value=0.0, name=None):
    return _simple("pad_constant_like", {"X": [x], "Y": [y]},
                   {"pad_value": pad_value}, y.dtype, name=name)


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    """ref layers/nn.py image_resize_short: resized so that the short side
    is out_short_len (the shape computed at build time)."""
    from .nn import image_resize
    h, w = int(input.shape[2]), int(input.shape[3])
    scale = out_short_len / min(h, w)
    return image_resize(input, out_shape=[int(round(h * scale)),
                                          int(round(w * scale))],
                        resample=resample)


def bpr_loss(input, label, name=None):
    return _simple("bpr_loss", {"X": [input], "Label": [label]}, {},
                   input.dtype, out_slot="Y", name=name)


def rank_loss(label, left, right, name=None):
    return _simple("rank_loss",
                   {"Label": [label], "Left": [left], "Right": [right]},
                   {}, left.dtype, name=name)


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    helper = LayerHelper("margin_rank_loss", name=name)
    out = helper.create_variable_for_type_inference(left.dtype)
    act = helper.create_variable_for_type_inference(left.dtype, True)
    helper.append_op("margin_rank_loss",
                     {"Label": [label], "X1": [left], "X2": [right]},
                     {"Out": [out], "Activated": [act]},
                     {"margin": margin})
    return out


def log_loss(input, label, epsilon=1e-4, name=None):
    return _simple("log_loss",
                   {"Predicted": [input], "Labels": [label]},
                   {"epsilon": epsilon}, input.dtype, out_slot="Loss",
                   name=name)


def dice_loss(input, label, epsilon=1e-5, name=None):
    """ref layers/nn.py dice_loss: 1 - (2 |input * label| + eps) /
    (|input| + |label| + eps) over the non-batch dims, averaged over the
    batch, composed of element and reduce ops."""
    helper = LayerHelper("dice_loss", name=name)
    red_dims = list(range(1, len(input.shape)))

    def app(op, ins, attrs=None):
        o = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op(op, ins, {"Out": [o]}, attrs or {})
        return o

    labf = app("cast", {"X": [label]}, {"out_dtype": "float32"})
    inter = app("elementwise_mul", {"X": [input], "Y": [labf]})
    inter = app("reduce_sum", {"X": [inter]}, {"dim": red_dims})
    s_in = app("reduce_sum", {"X": [input]}, {"dim": red_dims})
    s_lb = app("reduce_sum", {"X": [labf]}, {"dim": red_dims})
    union = app("elementwise_add", {"X": [s_in], "Y": [s_lb]})
    num = app("scale", {"X": [inter]}, {"scale": 2.0, "bias": epsilon})
    den = app("scale", {"X": [union]}, {"scale": 1.0, "bias": epsilon})
    dice = app("elementwise_div", {"X": [num], "Y": [den]})
    loss = app("scale", {"X": [dice]}, {"scale": -1.0, "bias": 1.0})
    return app("reduce_mean", {"X": [loss]}, {"dim": [0]})


def mean_iou(input, label, num_classes, name=None):
    """(mean IoU, per-class wrong counts, per-class correct counts)."""
    helper = LayerHelper("mean_iou", name=name)
    miou = helper.create_variable_for_type_inference("float32")
    wrong = helper.create_variable_for_type_inference("int64", True)
    correct = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("mean_iou",
                     {"Predictions": [input], "Labels": [label]},
                     {"OutMeanIou": [miou], "OutWrong": [wrong],
                      "OutCorrect": [correct]},
                     {"num_classes": num_classes})
    return miou, wrong, correct


def multiplex(inputs: List[Variable], index, name=None):
    return _simple("multiplex", {"X": list(inputs), "Ids": [index]}, {},
                   inputs[0].dtype, name=name)


def bilinear_tensor_product(x, y, size, param_attr=None, bias_attr=None,
                            act=None, name=None):
    """out[:, o] = x W[o] y^T + b[o], with W [size, dx, dy] and b [size]
    parameters."""
    helper = LayerHelper("bilinear_tensor_product", name=name)
    dx, dy = int(x.shape[-1]), int(y.shape[-1])
    w = helper.create_parameter(param_attr, shape=[size, dx, dy],
                                dtype=x.dtype)
    b = helper.create_parameter(bias_attr, shape=[size], dtype=x.dtype,
                                is_bias=True)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("bilinear_tensor_product",
                     {"X": [x], "Y": [y], "Weight": [w], "Bias": [b]},
                     {"Out": [out]}, {})
    return helper.append_activation(out, act)


def shape(input, name=None):
    return _simple("shape", {"Input": [input]}, {}, "int32", name=name)


def gaussian_random_batch_size_like(input, shape, mean=0.0, std=1.0,
                                    dtype="float32", name=None):
    return _simple("gaussian_random_batch_size_like", {"Input": [input]},
                   {"shape": list(shape), "mean": mean, "std": std,
                    "dtype": dtype}, dtype, name=name)


def lstm(input, init_h=None, init_c=None, max_len=None, hidden_size=None,
         num_layers=1, dropout_prob=0.0, is_bidirec=False,
         param_attr=None, name=None):
    """The cudnn_lstm op's multi-layer LSTM: (out, last_h, last_c), its
    weights one flat parameter; init_h and init_c optional [num_layers *
    ndir, B, H].  ``dropout_prob`` and ``max_len`` are accepted as JAX's
    layer accepts them (no dropout between the layers)."""
    if hidden_size is None:
        raise ValueError("layers.lstm: hidden_size is required")
    helper = LayerHelper("lstm", name=name)
    ndir = 2 if is_bidirec else 1
    n, din = 0, int(input.shape[-1])
    for _ in range(num_layers):
        n += ndir * (din * 4 * hidden_size + hidden_size * 4 * hidden_size
                     + 4 * hidden_size)
        din = hidden_size * ndir
    w = helper.create_parameter(param_attr, shape=[n], dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    last_h = helper.create_variable_for_type_inference(input.dtype, True)
    last_c = helper.create_variable_for_type_inference(input.dtype, True)
    ins = {"Input": [input], "W": [w]}
    if init_h is not None:
        ins["InitH"] = [init_h]
    if init_c is not None:
        ins["InitC"] = [init_c]
    helper.append_op("cudnn_lstm", ins,
                     {"Out": [out], "LastH": [last_h], "LastC": [last_c]},
                     {"hidden_size": hidden_size, "num_layers": num_layers,
                      "is_bidirec": is_bidirec})
    return out, last_h, last_c


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  name=None):
    """The projected LSTM (the lstmp op) over input [B, T, size] already
    projected: (projection, the per-step cells), as the reference
    returns them."""
    helper = LayerHelper("dynamic_lstmp", name=name)
    hidden = size // 4
    w = helper.create_parameter(param_attr,
                                shape=[proj_size, 4 * hidden],
                                dtype=input.dtype)
    pw = helper.create_parameter(None, shape=[hidden, proj_size],
                                 dtype=input.dtype)
    proj = helper.create_variable_for_type_inference(input.dtype)
    cell = helper.create_variable_for_type_inference(input.dtype)
    last_h = helper.create_variable_for_type_inference(input.dtype, True)
    last_c = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op("lstmp",
                     {"Input": [input], "Weight": [w], "ProjWeight": [pw]},
                     {"Projection": [proj], "Cell": [cell],
                      "LastH": [last_h], "LastC": [last_c]}, {})
    return proj, cell
