"""Miscellaneous ops (counterpart of paddle_tpu/ops/misc_ops.py:
sequence_conv :60 with ``_context_columns`` :32, pool3d :308,
conv3d_transpose :321 and label_smooth :435)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..framework.registry import register_op, single_input
from .nn_ops import _pair, _pool_nd


def _context_columns(x, ctx_len, ctx_start):
    """[B, T, D] -> [B, T, ctx_len * D]: step t's row concatenates x at
    steps t + ctx_start ... t + ctx_start + ctx_len - 1, zeros beyond the
    ends (the reference's ContextProjection, sequence_conv_op.cc's
    im2col)."""
    B, T, D = x.shape
    steps = torch.arange(T, device=x.device)
    cols = []
    for k in range(ctx_len):
        off = ctx_start + k
        shifted = torch.roll(x, -off, dims=1)
        valid = ((steps + off >= 0) & (steps + off < T))[None, :, None]
        cols.append(torch.where(valid, shifted, 0.0))
    return torch.cat(cols, dim=-1)


@register_op("sequence_conv")
def _sequence_conv(ctx, ins, attrs):
    """Context-window convolution over time (ref sequence_conv_op.cc): X
    [B, T, D], Filter [ctx_len * D, M], zero-padded context; the product
    in X's dtype, as the JAX lowering casts the filter to it."""
    x = single_input(ins, "X")
    w = single_input(ins, "Filter")
    ctx_len = int(attrs.get("contextLength", attrs.get("context_length", 3)))
    ctx_start = int(attrs.get("contextStart",
                              attrs.get("context_start", -(ctx_len // 2))))
    col = _context_columns(x, ctx_len, ctx_start)
    out = torch.matmul(col, w.to(col.dtype))
    return {"Out": [out.to(x.dtype)]}


@register_op("pool3d")
def _pool3d(ctx, ins, attrs):
    """ref pool_op.cc 3-D: NCDHW max / avg on the shared ``_pool_nd``
    (global_pooling, ceil_mode, exclusive avg); ksize 2 and strides =
    ksize where the attrs leave them out."""
    attrs = dict(attrs)
    if "ksize" not in attrs and not attrs.get("global_pooling", False):
        attrs["ksize"] = 2
    if "strides" not in attrs:
        attrs["strides"] = attrs.get("ksize", 2)
    return {"Out": [_pool_nd(single_input(ins, "X"), attrs, 3)]}


@register_op("conv3d_transpose")
def _conv3d_transpose(ctx, ins, attrs):
    """ref conv_transpose_op.cc 3-D: IODHW filter [C_in, C_out, kd, kh,
    kw], strides and paddings, no groups or dilations (JAX's lowering
    takes none); F.conv_transpose3d computes JAX's gradient-of-conv
    function.  JAX's lowering makes no AMP casts: the operands must
    share a dtype, and Output takes Input's."""
    x = single_input(ins, "Input")
    w = single_input(ins, "Filter")
    out = F.conv_transpose3d(x, w, None, _pair(attrs.get("strides", 1), 3),
                             _pair(attrs.get("paddings", 0), 3))
    return {"Output": [out.to(x.dtype)]}


@register_op("label_smooth")
def _label_smooth(ctx, ins, attrs):
    """ref label_smooth_op.cc: (1 - eps) * x + eps * prior, the prior
    ``PriorDist`` where it is given, else uniform over the last dim."""
    x = single_input(ins, "X")
    eps = float(attrs.get("epsilon", 0.1))
    prior = ins["PriorDist"][0] if ins.get("PriorDist") else (
        1.0 / x.shape[-1])
    return {"Out": [(1.0 - eps) * x + eps * prior]}
