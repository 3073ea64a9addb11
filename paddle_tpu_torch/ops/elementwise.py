"""Elementwise binary ops with the reference's axis-broadcast semantics.

Counterpart of paddle_tpu/ops/elementwise.py: the ``_binary`` family
(:33-60) for elementwise_add, _sub, _mul, _div, _min, _max, _pow, _mod
and _floordiv, the six comparisons (``_compare``, :63-77; bool out, no
gradient; ModelAverage's apply program asks greater_equal whether
anything was accumulated, a ``While`` loop less_than whether to go on)
and the four logical ops (:81-100).  ``elementwise_mod`` is
``torch.remainder`` and ``elementwise_floordiv`` ``torch.floor_divide``,
which like ``jnp.mod`` and ``jnp.floor_divide`` round toward minus
infinity (``torch.fmod`` takes the dividend's sign); gradient
accumulation wraps its f32 counter with the mod.  The
global-norm clip divides by a max with _div and _max.  Reference broadcast rule:
Y's dims align with X starting at `axis` (axis == -1 -> trailing
alignment), then NumPy-style broadcast.  ``fc``'s bias add relies on it
with ``axis=num_flatten_dims``.
"""
from __future__ import annotations

import torch

from ..core import flags
from ..framework.registry import register_op


def _align(x, y, axis):
    """Reshape the lower-rank operand so its dims line up with the other's
    starting at `axis` (paddle_tpu/ops/elementwise.py:20)."""
    if x.ndim == y.ndim:
        return x, y
    if y.ndim > x.ndim:  # allow either operand to be the smaller one
        y_al, x_al = _align(y, x, axis)
        return x_al, y_al
    axis = int(axis)
    if axis == -1:
        axis = x.ndim - y.ndim
    new_shape = (1,) * axis + tuple(y.shape) + (1,) * (x.ndim - axis - y.ndim)
    return x, y.reshape(new_shape)


def _binary(name, fn):
    @register_op(name)
    def _lower(ctx, ins, attrs, _fn=fn):
        x, y = _align(ins["X"][0], ins["Y"][0], attrs.get("axis", -1))
        # AMP (paddle_tpu/ops/elementwise.py:38-48): a bf16 activation
        # meeting an f32 operand (a bias or a residual's master copy)
        # computes in bf16; type promotion would lift the activation plane
        # back to f32 and hand the bf16 kernels downstream f32
        if flags.get_flag("amp_bf16") and {x.dtype, y.dtype} == {
                torch.bfloat16, torch.float32}:
            x, y = x.to(torch.bfloat16), y.to(torch.bfloat16)
        return {"Out": [_fn(x, y)]}
    return _lower


_binary("elementwise_add", torch.add)
_binary("elementwise_sub", torch.sub)
_binary("elementwise_mul", torch.mul)
_binary("elementwise_div", torch.div)
_binary("elementwise_min", torch.minimum)
_binary("elementwise_max", torch.maximum)
_binary("elementwise_pow", torch.pow)
_binary("elementwise_mod", torch.remainder)
_binary("elementwise_floordiv", torch.floor_divide)


def _compare(name, fn):
    @register_op(name)
    def _lower(ctx, ins, attrs, _fn=fn):
        x, y = _align(ins["X"][0], ins["Y"][0], attrs.get("axis", -1))
        return {"Out": [_fn(x, y)]}
    return _lower


_compare("equal", torch.eq)
_compare("not_equal", torch.ne)
_compare("less_than", torch.lt)
_compare("less_equal", torch.le)
_compare("greater_than", torch.gt)
_compare("greater_equal", torch.ge)


def _logical(name, fn, arity=2):
    @register_op(name)
    def _lower(ctx, ins, attrs, _fn=fn):
        args = [ins["X"][0]] + ([ins["Y"][0]] if arity == 2 else [])
        return {"Out": [_fn(*args)]}
    return _lower


_logical("logical_and", torch.logical_and)
_logical("logical_or", torch.logical_or)
_logical("logical_xor", torch.logical_xor)
_logical("logical_not", torch.logical_not, arity=1)
