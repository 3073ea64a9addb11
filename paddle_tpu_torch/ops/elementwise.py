"""Elementwise binary ops with the reference's axis-broadcast semantics.

Counterpart of paddle_tpu/ops/elementwise.py: the ``_binary`` family
(:33-60) for elementwise_add, _sub, _mul, _div, _max and _mod, and the
comparisons equal, greater_than and greater_equal (``_compare``,
:63-77; bool out, no gradient; ModelAverage's apply program asks
greater_equal whether anything was accumulated).  ``elementwise_mod`` is ``torch.remainder``, which like
``jnp.mod`` takes the divisor's sign (``torch.fmod`` takes the
dividend's); gradient accumulation wraps its f32 counter with it.  The
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
_binary("elementwise_max", torch.maximum)
_binary("elementwise_mod", torch.remainder)


def _compare(name, fn):
    @register_op(name)
    def _lower(ctx, ins, attrs, _fn=fn):
        x, y = _align(ins["X"][0], ins["Y"][0], attrs.get("axis", -1))
        return {"Out": [_fn(x, y)]}
    return _lower


_compare("equal", torch.eq)
_compare("greater_than", torch.gt)
_compare("greater_equal", torch.ge)
