"""Recurrent ops (counterpart of paddle_tpu/ops/rnn_ops.py: lstm :33,
gru :97, lstm_unit :148 and gru_unit :161).

The JAX package runs the recurrence as one ``lax.scan`` over time; here
it is a Python loop over T in eager torch that takes the scan's steps in
its order (backwards with ``is_reverse``), and ``Hidden`` / ``Cell`` are
``torch.stack`` of the per-step states (writing into a preallocated slab
in place would break autograd).  Sequences are dense [B, T, ...] with an
optional mask [B, T] (1 = token): a masked step carries the previous
state through as ``m * new + (1 - m) * old``.  Gate order is i, f, c, o
for the LSTM and u, r, c for the GRU.

Dtypes follow the JAX lowering, not an AMP helper (JAX's lowering calls
none): the recurrent product is taken in the promoted dtype of h and W
(bf16 h against an f32 weight under AMP: f32) and cast to the gates'
dtype, as ``jnp.matmul(h, w, preferred_element_type=f32).astype(x.dtype)``
gives it; the mask is cast to the gates' dtype.  ``torch.nn.LSTM`` and
cuDNN's RNN are not this function (their weight layout, masking and bf16
rounding points differ).
"""
from __future__ import annotations

import torch

from ..framework.registry import register_op, single_input

_ACT = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
        "identity": lambda x: x}


def _recurrent(h, w, dtype):
    """h @ w in the promoted dtype of the two, cast to `dtype`."""
    p = torch.promote_types(h.dtype, w.dtype)
    return torch.matmul(h.to(p), w.to(p)).to(dtype)


def _blend(m, new, old):
    return new if m is None else m * new + (1 - m) * old


def _steps(x, mask, reverse):
    """(x[:, t], mask[:, t, None] in x's dtype or None) for each t in the
    scan's order."""
    T = x.shape[1]
    m = None if mask is None else mask.to(x.dtype)[..., None]
    order = range(T - 1, -1, -1) if reverse else range(T)
    for t in order:
        yield x[:, t], None if m is None else m[:, t]


def _in_time_order(states, reverse):
    return torch.stack(states[::-1] if reverse else states, dim=1)


@register_op("lstm")
def _lstm(ctx, ins, attrs):
    """Input [B, T, 4H] (pre-projected x @ Wx + b), Weight [H, 4H]
    recurrent, optional H0 / C0 [B, H] and Mask [B, T].  Outputs Hidden
    and Cell [B, T, H], LastH and LastC [B, H]."""
    x = single_input(ins, "Input")
    w = single_input(ins, "Weight")
    B, _, H4 = x.shape
    H = H4 // 4
    gate_act = _ACT[attrs.get("gate_activation", "sigmoid")]
    cell_act = _ACT[attrs.get("cell_activation", "tanh")]
    cand_act = _ACT[attrs.get("candidate_activation", "tanh")]
    reverse = bool(attrs.get("is_reverse", False))
    zeros = lambda: torch.zeros((B, H), dtype=x.dtype,  # noqa: E731
                                device=x.device)
    h = ins["H0"][0] if ins.get("H0") else zeros()
    c = ins["C0"][0] if ins.get("C0") else zeros()
    mask = ins["Mask"][0] if ins.get("Mask") else None
    hs, cs = [], []
    for xt, m in _steps(x, mask, reverse):
        gates = xt + _recurrent(h, w, x.dtype)
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        i, f, o = gate_act(i), gate_act(f), gate_act(o)
        c_new = f * c + i * cand_act(g)
        h_new = o * cell_act(c_new)
        h, c = _blend(m, h_new, h), _blend(m, c_new, c)
        hs.append(h)
        cs.append(c)
    return {"Hidden": [_in_time_order(hs, reverse)],
            "Cell": [_in_time_order(cs, reverse)],
            "LastH": [h], "LastC": [c]}


def _gru_step(xt, h, w, gate_act, cand_act):
    """One GRU step: u, r from the first 2H columns, the candidate from
    the reset state's product with the last H."""
    H = h.shape[-1]
    ur = gate_act(xt[:, :2 * H] + _recurrent(h, w[:, :2 * H], xt.dtype))
    u, r = ur[:, :H], ur[:, H:]
    c = cand_act(xt[:, 2 * H:] + _recurrent(r * h, w[:, 2 * H:], xt.dtype))
    return u * h + (1 - u) * c, u, r


@register_op("gru")
def _gru(ctx, ins, attrs):
    """Input [B, T, 3H] pre-projected, Weight [H, 3H] (u | r | c blocks),
    optional H0 [B, H] and Mask [B, T].  Outputs Hidden [B, T, H] and
    LastH [B, H]."""
    x = single_input(ins, "Input")
    w = single_input(ins, "Weight")
    B, _, H3 = x.shape
    gate_act = _ACT[attrs.get("gate_activation", "sigmoid")]
    cand_act = _ACT[attrs.get("activation", "tanh")]
    reverse = bool(attrs.get("is_reverse", False))
    h = (ins["H0"][0] if ins.get("H0") else
         torch.zeros((B, H3 // 3), dtype=x.dtype, device=x.device))
    mask = ins["Mask"][0] if ins.get("Mask") else None
    hs = []
    for xt, m in _steps(x, mask, reverse):
        h_new, _, _ = _gru_step(xt, h, w, gate_act, cand_act)
        h = _blend(m, h_new, h)
        hs.append(h)
    return {"Hidden": [_in_time_order(hs, reverse)], "LastH": [h]}


@register_op("lstm_unit")
def _lstm_unit(ctx, ins, attrs):
    """One step (ref lstm_unit_op.cc): X [B, 4H] pre-activation, C_prev
    [B, H]; sigmoid gates, tanh candidate and cell."""
    x = single_input(ins, "X")
    c_prev = single_input(ins, "C_prev")
    forget_bias = float(attrs.get("forget_bias", 0.0))
    i, f, g, o = torch.chunk(x, 4, dim=-1)
    c = torch.sigmoid(f + forget_bias) * c_prev + torch.sigmoid(
        i) * torch.tanh(g)
    return {"C": [c], "H": [torch.sigmoid(o) * torch.tanh(c)]}


@register_op("gru_unit")
def _gru_unit(ctx, ins, attrs):
    """One step (ref gru_unit_op.cc): Input [B, 3H] pre-projected,
    HiddenPrev [B, H], Weight [H, 3H].  Outputs Hidden, Gate (u | r) and
    ResetHiddenPrev (r * h)."""
    x = single_input(ins, "Input")
    h = single_input(ins, "HiddenPrev")
    w = single_input(ins, "Weight")
    h_new, u, r = _gru_step(x, h, w,
                            _ACT[attrs.get("gate_activation", "sigmoid")],
                            _ACT[attrs.get("activation", "tanh")])
    return {"Hidden": [h_new], "Gate": [torch.cat([u, r], -1)],
            "ResetHiddenPrev": [r * h]}
