"""Sequence-family layers (counterpart of paddle_tpu/layers/sequence.py,
the part the machine-translation and book models call): sequence_conv
:41, sequence_pool :76, sequence_first_step :86, sequence_last_step
:90, linear_chain_crf :178, crf_decoding :200, beam_search :362,
beam_search_decode :384 and sum :727.

The reference's sequence layers read LoD tensors; here, as in the JAX
package, a sequence is a padded [B, T, ...] tensor with an optional
[B, T] mask.  Each function appends the JAX package's op with its slots
and attrs, so both builds serialize alike.
"""
from __future__ import annotations

import warnings
from typing import List, Union

from ..framework.layer_helper import LayerHelper, ParamAttr
from ..framework.program import Variable

__all__ = ["sequence_conv", "sequence_pool", "sequence_first_step",
           "sequence_last_step", "linear_chain_crf", "crf_decoding",
           "beam_search", "beam_search_decode", "sum"]


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


def sum(x: Union[Variable, List[Variable]], name=None):  # noqa: A001
    """The elementwise sum of a list of vars (the ``sum`` op)."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    return _simple("sum", {"X": list(xs)}, {}, xs[0].dtype, name=name)
