"""RNN layers (counterpart of paddle_tpu/layers/rnn.py: dynamic_lstm :13,
lstm_layer :53, dynamic_gru :66, gru_unit :96 and lstm_unit :117), with
the JAX package's op types, slots, attrs and parameter shapes, so both
builds serialize alike.  Weights take the LayerHelper's default,
XavierInitializer; the gate bias is an elementwise_add over dims from 2
(a sequence) or 1 (one step)."""
from __future__ import annotations

from ..framework.layer_helper import LayerHelper

__all__ = ["dynamic_lstm", "lstm_layer", "dynamic_gru", "gru_unit",
           "lstm_unit"]


def dynamic_lstm(input, size, h_0=None, c_0=None, mask=None,
                 param_attr=None, bias_attr=None, use_peepholes=False,
                 is_reverse=False, gate_activation="sigmoid",
                 cell_activation="tanh", candidate_activation="tanh",
                 name=None):
    """input: [B, T, 4H] pre-projected (the x -> 4H projection is a
    preceding fc); size = 4H.  Returns (hidden [B, T, H], the last cell
    [B, H]).  A padded batch passes `mask` [B, T]."""
    helper = LayerHelper("dynamic_lstm", name=name)
    H = size // 4
    w = helper.create_parameter(param_attr, shape=[H, 4 * H],
                                dtype=input.dtype)
    bias = helper.create_parameter(bias_attr, shape=[4 * H],
                                   dtype=input.dtype, is_bias=True)
    x = helper.append_bias_op(input, bias, dim_start=2)
    inputs = {"Input": [x], "Weight": [w]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    if mask is not None:
        inputs["Mask"] = [mask]
    hidden = helper.create_variable_for_type_inference(input.dtype)
    last_h = helper.create_variable_for_type_inference(input.dtype)
    last_c = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("lstm", inputs,
                     {"Hidden": [hidden], "LastH": [last_h],
                      "LastC": [last_c]},
                     {"gate_activation": gate_activation,
                      "cell_activation": cell_activation,
                      "candidate_activation": candidate_activation,
                      "is_reverse": is_reverse})
    return hidden, last_c


def lstm_layer(input, hidden_size, h_0=None, c_0=None, mask=None,
               param_attr=None, bias_attr=None, is_reverse=False,
               name=None):
    """The x-projection fc (no bias) and dynamic_lstm."""
    from . import nn
    proj = nn.fc(input, size=4 * hidden_size, num_flatten_dims=2,
                 param_attr=param_attr, bias_attr=False)
    return dynamic_lstm(proj, 4 * hidden_size, h_0=h_0, c_0=c_0, mask=mask,
                        bias_attr=bias_attr, is_reverse=is_reverse,
                        name=name)


def dynamic_gru(input, size, h_0=None, mask=None, param_attr=None,
                bias_attr=None, is_reverse=False,
                gate_activation="sigmoid", candidate_activation="tanh",
                name=None):
    """input: [B, T, 3H] pre-projected; size = H.  Returns hidden
    [B, T, H]."""
    helper = LayerHelper("dynamic_gru", name=name)
    H = size
    w = helper.create_parameter(param_attr, shape=[H, 3 * H],
                                dtype=input.dtype)
    bias = helper.create_parameter(bias_attr, shape=[3 * H],
                                   dtype=input.dtype, is_bias=True)
    x = helper.append_bias_op(input, bias, dim_start=2)
    inputs = {"Input": [x], "Weight": [w]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if mask is not None:
        inputs["Mask"] = [mask]
    hidden = helper.create_variable_for_type_inference(input.dtype)
    last_h = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("gru", inputs,
                     {"Hidden": [hidden], "LastH": [last_h]},
                     {"gate_activation": gate_activation,
                      "activation": candidate_activation,
                      "is_reverse": is_reverse})
    return hidden


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid", name=None):
    """One GRU step: input [B, 3H] pre-projected, hidden [B, H]; size =
    3H.  Returns (new hidden, gate, reset hidden prev)."""
    helper = LayerHelper("gru_unit", name=name)
    H = size // 3
    w = helper.create_parameter(param_attr, shape=[H, 3 * H],
                                dtype=input.dtype)
    bias = helper.create_parameter(bias_attr, shape=[3 * H],
                                   dtype=input.dtype, is_bias=True)
    x = helper.append_bias_op(input, bias, dim_start=1)
    out = helper.create_variable_for_type_inference(input.dtype)
    gate = helper.create_variable_for_type_inference(input.dtype)
    reset = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("gru_unit",
                     {"Input": [x], "HiddenPrev": [hidden], "Weight": [w]},
                     {"Hidden": [out], "Gate": [gate],
                      "ResetHiddenPrev": [reset]},
                     {"activation": activation,
                      "gate_activation": gate_activation})
    return out, gate, reset


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step: concat(x, h) -> fc 4H -> the lstm_unit op.  Returns
    (hidden, cell)."""
    from . import nn, tensor
    helper = LayerHelper("lstm_unit", name=name)
    H = int(cell_t_prev.shape[-1])
    cat = tensor.concat([x_t, hidden_t_prev], axis=1)
    fc_out = nn.fc(cat, size=4 * H, param_attr=param_attr,
                   bias_attr=bias_attr)
    c = helper.create_variable_for_type_inference(x_t.dtype)
    h = helper.create_variable_for_type_inference(x_t.dtype)
    helper.append_op("lstm_unit",
                     {"X": [fc_out], "C_prev": [cell_t_prev]},
                     {"C": [c], "H": [h]}, {"forget_bias": forget_bias})
    return h, c
