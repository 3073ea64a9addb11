"""JAX's gradients at kinks and ties, for lowerings whose torch twin
differentiates them otherwise.

``clip`` is ``jnp.clip``'s ``minimum(maximum(x, lo), hi)``: lax.max and
lax.min give half the cotangent to each side of a tie, so an element
sitting exactly on a bound gets 0.5, where ``torch.clamp`` gives 1.  The
``clip`` op, the activations built on jnp.clip (``brelu``, ``relu6``,
``hard_sigmoid``, ``hard_swish``, ``soft_relu``) and the fake-quant ops
take it from here.

``abs`` is lax.abs, whose gradient is ``select(x >= 0, g, -g)``: 1 at 0,
where ``torch.abs`` gives 0.  The ``abs`` op, ``l1_norm`` and the stable
``log1p(exp(-|x|))`` of sigmoid_cross_entropy_with_logits take it.

``div`` is a division by a Python number that gives JAX's quotient on
every device: CUDA turns a division by a host scalar into a
multiplication by its reciprocal, which can differ in the last bit.  The
fake-quant ops, the resize ops' scales and the normalized
``edit_distance`` take it.
"""
from __future__ import annotations

import math

import torch


class _Clip(torch.autograd.Function):
    """clip(x, lo, hi) as JAX's ``min(max(x, lo), hi)`` differentiates
    it: 1 inside, 0 outside, and 0.5 at a bound (lax.max and lax.min give
    half the cotangent to each side of a tie; torch.clamp gives 1)."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        lo, hi = ctx.bounds
        inside = ((x > lo) & (x < hi)).to(g.dtype)
        tie = ((x == lo) | (x == hi)).to(g.dtype)
        return g * (inside + 0.5 * tie), None, None


def clip(x, lo=-math.inf, hi=math.inf):
    """jnp.clip(x, lo, hi) with JAX's gradient; None for an open side."""
    lo = -math.inf if lo is None else float(lo)
    hi = math.inf if hi is None else float(hi)
    return _Clip.apply(x, lo, hi)


class _Abs(torch.autograd.Function):
    """|x| with lax.abs's gradient: g where x >= 0 (0 and -0 included),
    -g elsewhere."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def abs(x):  # noqa: A001 - the op's name
    """jnp.abs(x) with JAX's gradient."""
    return _Abs.apply(x)


def div(a, c):
    """a / c for a Python number c, as a true division on every device
    (a device scalar divisor, where CUDA would multiply a by 1 / c)."""
    return a / a.new_full((), c)
