"""NN ops (counterpart of paddle_tpu/ops/nn_ops.py: layer_norm :261,
softmax :349, dropout :362 and lookup_table :384)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..framework.registry import register_op, single_input
from ..kernels.layer_norm import layer_norm_train as _layer_norm_rows
from .creation import op_generator


@register_op("layer_norm")
def _layer_norm(ctx, ins, attrs):
    """ref layer_norm_op.cc: normalise over dims >= begin_norm_axis.
    A single trailing axis with affine params goes through the row kernel
    (kernels/layer_norm.py: the CUDA kernel on the card, its plain version
    on the CPU; differentiable, with the JAX fused path's analytic VJP);
    like the JAX fused path it reports Variance = 1/rstd^2 - eps."""
    x = single_input(ins)
    eps = float(attrs.get("epsilon", 1e-5))
    axis = int(attrs.get("begin_norm_axis", 1))
    if axis == x.ndim - 1 and ins.get("Scale") and ins.get("Bias"):
        D = x.shape[-1]
        y, mean, rstd = _layer_norm_rows(
            x.reshape(-1, D).contiguous(), ins["Scale"][0].reshape(D),
            ins["Bias"][0].reshape(D), eps)
        lead = x.shape[:-1]
        var = 1.0 / torch.square(rstd) - eps
        return {"Y": [y.reshape(x.shape)], "Mean": [mean.reshape(lead)],
                "Variance": [var.reshape(lead)]}
    dims = tuple(range(axis, x.ndim))
    xf = x.float()
    mean = torch.mean(xf, dim=dims, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=dims, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    norm_shape = x.shape[axis:]
    if ins.get("Scale"):
        y = y * ins["Scale"][0].reshape(norm_shape)
    if ins.get("Bias"):
        y = y + ins["Bias"][0].reshape(norm_shape)
    return {"Y": [y.to(x.dtype)],
            "Mean": [mean.reshape(x.shape[:axis])],
            "Variance": [var.reshape(x.shape[:axis])]}


@register_op("softmax")
def _softmax(ctx, ins, attrs):
    x = single_input(ins)
    return {"Out": [torch.softmax(x, dim=int(attrs.get("axis", -1)))]}


@register_op("dropout")
def _dropout(ctx, ins, attrs):
    """ref dropout_op.cc: implementations downgrade_in_infer (the
    default: scale by 1 - p at test time) and upscale_in_train (scale
    the kept entries by 1 / (1 - p) in training).  The keep draw is
    uniform < 1 - p from the op's generator on the op's device (a
    nonzero ``seed`` attr seeds its own); Philox draws other bits than
    JAX's threefry, so only the distribution is JAX's.  Mask is uint8."""
    x = single_input(ins)
    p = float(attrs.get("dropout_prob", 0.5))
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False):
        out = x * (1.0 - p) if impl == "downgrade_in_infer" else x
        return {"Out": [out], "Mask": [torch.ones_like(x, dtype=torch.uint8)]}
    u = torch.rand(x.shape, generator=op_generator(ctx, attrs),
                   device=ctx.device)
    keep = u < 1.0 - p
    if impl == "upscale_in_train":
        out = torch.where(keep, x / max(1.0 - p, 1e-8), 0.0)
    else:
        out = torch.where(keep, x, 0.0)
    return {"Out": [out.to(x.dtype)], "Mask": [keep.to(torch.uint8)]}


@register_op("lookup_table")
def _lookup_table(ctx, ins, attrs):
    """Embedding lookup (ref lookup_table_op.cc).  An ids trailing dim of
    1 is squeezed; padding_idx rows produce zeros."""
    w = single_input(ins, "W")
    ids = single_input(ins, "Ids")
    padding_idx = int(attrs.get("padding_idx", -1))
    if ids.ndim >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    ids = ids.long()
    out = F.embedding(ids, w)
    if padding_idx != -1:
        out = torch.where((ids == padding_idx)[..., None],
                          torch.zeros((), dtype=out.dtype, device=out.device),
                          out)
    return {"Out": [out]}
