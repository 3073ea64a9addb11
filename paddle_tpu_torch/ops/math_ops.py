"""Matmul-family and misc math ops.

Counterpart of paddle_tpu/ops/math_ops.py: the AMP helpers :28-77
(amp_inputs, amp_result, amp_matmul), mul :91 (fc's flattening
matmul), matmul :105 (the unfused attention's batched products), scale
:142, sum :152 (fc over several inputs, the regularizers), mean :158,
clip :168 (JAX's 0.5 gradient at a bound) and clip_by_norm :174
(gradient clipping), increment :197 (gradient accumulation's counter),
squared_l2_norm :209 (the global norm), cos_sim :238 (the recommender's
score), and the dense plane's dot :136, minus :163, cumsum :182 (with
``exclusive`` as ``out - x``, JAX's form, not a shifted sum), isfinite
:203, squared_l2_distance :215, l1_norm :223, norm :228 and
bilinear_tensor_product :247.  A plain matrix product outside any
kernel goes to torch.matmul, as the JAX package leaves it to XLA; f32
products run in full f32 (TF32 stays off unless the caller enables it).
Under FLAGS_amp_bf16 the operands are cast to bf16 and a 2-byte product
returns its 2-byte result directly.  It accumulates in f32 only when the
caller turns off torch.backends.cuda.matmul.
allow_bf16_reduced_precision_reduction (on by PyTorch's default, it lets
cuBLAS add split-K partial sums in bf16), as chip_smoke.py does.
Under FLAGS_quantize_dtype (JAX :71-75) a product of floating operands
leaves the bf16 plane: int8 or fp8 operands with dynamic scales and a
straight-through backward (quantize_ops.low_precision_matmul), for mul,
matmul and bmm (:130) alike.
"""
from __future__ import annotations

import math
from functools import reduce

import torch

from ..core import flags
from ..framework.registry import register_op, single_input
from . import _grad_rules
from ._grad_rules import clip


def amp_inputs(*xs):
    """Under FLAGS_amp_bf16, the f32 operands of a matmul-style op cast to
    bf16 (the params stay f32 master copies; autograd's cast carries the
    gradient back to f32); others pass unchanged."""
    if flags.get_flag("amp_bf16"):
        xs = tuple(x.to(torch.bfloat16) if x.dtype == torch.float32 else x
                   for x in xs)
    return xs


def amp_result(out, orig_dtype):
    """A matmul-style op's output dtype: under AMP an f32-origin result
    stays bf16, so the activation plane (and every residual autograd
    saves) is bf16; otherwise the origin dtype."""
    if flags.get_flag("amp_bf16") and orig_dtype == torch.float32:
        return out.to(torch.bfloat16)
    return out.to(orig_dtype)


def amp_matmul(x, y, orig_dtype=None):
    """torch.matmul with the AMP dtype policy: when the (amp-cast) operands
    are 2-byte, the product's 2-byte result directly (bf16 for an f32
    origin); f32 operands keep f32 accumulation and amp_result decides the
    output plane.  Under FLAGS_quantize_dtype, floating operands take the
    low-precision product instead."""
    orig = x.dtype if orig_dtype is None else orig_dtype
    qd = flags.get_flag("quantize_dtype")
    if qd and x.is_floating_point() and y.is_floating_point():
        from .quantize_ops import low_precision_matmul
        return low_precision_matmul(x, y, str(qd), orig)
    x, y = amp_inputs(x, y)
    if x.dtype.itemsize == 2:
        out = torch.matmul(x, y)            # 2-byte in -> 2-byte out
        want = torch.bfloat16 if orig == torch.float32 else orig
        return out if out.dtype == want else out.to(want)
    return amp_result(torch.matmul(x, y), orig)


def _flatten2(x, num_col_dims):
    lead = math.prod(x.shape[:num_col_dims]) if num_col_dims else 1
    return x.reshape(lead, -1)


@register_op("mul")
def _mul(ctx, ins, attrs):
    """fc's matmul: flatten X to 2-D by x_num_col_dims, Y by y_num_col_dims
    (ref operators/mul_op.cc)."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = int(attrs.get("x_num_col_dims", 1))
    yn = int(attrs.get("y_num_col_dims", 1))
    out = amp_matmul(_flatten2(x, xn), _flatten2(y, yn), x.dtype)
    out_shape = tuple(x.shape[:xn]) + tuple(y.shape[yn:])
    return {"Out": [out.reshape(out_shape)]}


@register_op("matmul")
def _matmul(ctx, ins, attrs):
    """Batched matmul with transpose flags + alpha (ref matmul_op.cc).  A
    1-D X is a row and a 1-D Y a column, squeezed out of the result."""
    x, y = ins["X"][0], ins["Y"][0]
    tx = bool(attrs.get("transpose_X", False))
    ty = bool(attrs.get("transpose_Y", False))
    alpha = float(attrs.get("alpha", 1.0))
    squeeze_out = []
    if x.ndim == 1:
        x, squeeze_out = x[None, :], [-2]
    if y.ndim == 1:
        y = y[:, None]
        squeeze_out = squeeze_out + [-1]
    if tx:
        x = torch.transpose(x, -1, -2)
    if ty:
        y = torch.transpose(y, -1, -2)
    out = amp_matmul(x, y)
    for ax in squeeze_out:
        out = torch.squeeze(out, ax)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": [out]}


@register_op("bmm")
def _bmm(ctx, ins, attrs):
    return {"Out": [amp_matmul(ins["X"][0], ins["Y"][0])]}


@register_op("scale")
def _scale(ctx, ins, attrs):
    x = single_input(ins)
    scale = attrs.get("scale", 1.0)
    bias = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return {"Out": [x * scale + bias]}
    return {"Out": [(x + bias) * scale]}


@register_op("sum")
def _sum(ctx, ins, attrs):
    """N-ary elementwise add (ref sum_op.cc), left to right as JAX's
    ``reduce(jnp.add)``."""
    return {"Out": [reduce(torch.add, ins["X"])]}


@register_op("mean")
def _mean(ctx, ins, attrs):
    return {"Out": [torch.mean(single_input(ins))]}


@register_op("clip")
def _clip(ctx, ins, attrs):
    """jnp.clip: the gradient at an element on a bound is 0.5, not
    torch.clamp's 1 (_grad_rules.clip)."""
    return {"Out": [clip(single_input(ins), attrs.get("min"),
                         attrs.get("max"))]}


@register_op("clip_by_norm")
def _clip_by_norm(ctx, ins, attrs):
    """x scaled to L2 norm max_norm where its norm exceeds it."""
    x = single_input(ins)
    max_norm = float(attrs["max_norm"])
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return {"Out": [torch.where(norm > max_norm, x * (max_norm / norm), x)]}


@register_op("squared_l2_norm")
def _squared_l2_norm(ctx, ins, attrs):
    return {"Out": [torch.sum(torch.square(single_input(ins))).reshape(())]}


@register_op("cos_sim")
def _cos_sim(ctx, ins, attrs):
    """Row-wise cosine of X and Y over the last dim, with their norms
    (XNorm, YNorm) and JAX's 1e-12 added to the norms' product."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), dim=-1, keepdim=True))
    out = torch.sum(x * y, dim=-1, keepdim=True) / (xn * yn + 1e-12)
    return {"Out": [out], "XNorm": [xn], "YNorm": [yn]}


@register_op("increment")
def _increment(ctx, ins, attrs):
    return {"Out": [single_input(ins) + attrs.get("step", 1.0)]}


@register_op("dot")
def _dot(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    return {"Out": [torch.sum(x * y, dim=-1, keepdim=True)]}


@register_op("minus")
def _minus(ctx, ins, attrs):
    return {"Out": [ins["X"][0] - ins["Y"][0]]}


@register_op("cumsum")
def _cumsum(ctx, ins, attrs):
    x = single_input(ins)
    axis = int(attrs.get("axis", -1))
    if attrs.get("flatten", False):
        x, axis = x.reshape(-1), 0
    if attrs.get("reverse", False):
        out = torch.flip(torch.cumsum(torch.flip(x, [axis]), dim=axis),
                         [axis])
    else:
        out = torch.cumsum(x, dim=axis)
    if attrs.get("exclusive", False):
        out = out - x
    return {"Out": [out]}


@register_op("isfinite")
def _isfinite(ctx, ins, attrs):
    """One 0-d bool: every entry finite."""
    return {"Out": [torch.all(torch.isfinite(single_input(ins)))]}


@register_op("squared_l2_distance")
def _squared_l2_distance(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    sub = x - y
    return {"Out": [torch.sum(torch.square(sub),
                              dim=tuple(range(1, sub.ndim)))],
            "sub_result": [sub]}


@register_op("l1_norm")
def _l1_norm(ctx, ins, attrs):
    return {"Out": [torch.sum(_grad_rules.abs(single_input(ins)))
                    .reshape(())]}


@register_op("norm")
def _norm(ctx, ins, attrs):
    """x over sqrt(sum(x^2, axis) + epsilon) (ref operators/norm_op.cc)."""
    x = single_input(ins)
    axis = int(attrs.get("axis", 1))
    eps = float(attrs.get("epsilon", 1e-10))
    norm = torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True)
                      + eps)
    return {"Out": [x / norm], "Norm": [norm]}


@register_op("bilinear_tensor_product")
def _bilinear_tensor_product(ctx, ins, attrs):
    """out[b, o] = x[b] W[o] y[b]^T (+ Bias[o]), JAX's einsum
    "bi,oij,bj->bo"."""
    x, y, w = ins["X"][0], ins["Y"][0], ins["Weight"][0]
    out = torch.einsum("bi,oij,bj->bo", x, w, y)
    if ins.get("Bias"):
        out = out + ins["Bias"][0]
    return {"Out": [out]}
