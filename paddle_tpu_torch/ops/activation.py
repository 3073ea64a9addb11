"""Pointwise activations and unary math (counterpart of
paddle_tpu/ops/activation.py: the unary functors :28-81, prelu :83 and
maxout :96).

Each lowering spells JAX's formula, so the values and the gradients at
the kinks are JAX's: the jnp.clip family (brelu, relu6, hard_sigmoid,
hard_swish, soft_relu) takes ``_grad_rules.clip``, 0.5 at a bound;
abs takes lax.abs's 1 at 0 (``_grad_rules.abs``); leaky_relu is
``where(x >= 0, x, alpha * x)``, 1 at 0 (F.leaky_relu gives
alpha); softplus is jnp.logaddexp(x, 0), 0.5 at 0; maxout's max over the
group splits a tie evenly, as ``torch.amax`` does (``torch.max(dim)``
would not).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..framework.registry import register_op, single_input
from . import _grad_rules
from ._grad_rules import clip


def _unary(name, fn):
    @register_op(name)
    def _lower(ctx, ins, attrs, _fn=fn):
        return {"Out": [_fn(single_input(ins), attrs)]}
    return _lower


def _softplus(x):
    """jax.nn.softplus: jnp.logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _where0(cond, x):
    """jnp.where(cond, x, 0.0)."""
    return torch.where(cond, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def _elu(x, alpha):
    """jax.nn.elu: expm1 of the negative side only, so the gradient of
    the side not taken is never inf * 0."""
    pos = x > 0
    return torch.where(pos, x, alpha * torch.expm1(_where0(~pos, x)))


_unary("relu", lambda x, a: torch.relu(x))
_unary("sigmoid", lambda x, a: torch.sigmoid(x))
_unary("logsigmoid", lambda x, a: -_softplus(-x))
_unary("tanh", lambda x, a: torch.tanh(x))
_unary("tanh_shrink", lambda x, a: x - torch.tanh(x))
_unary("exp", lambda x, a: torch.exp(x))
_unary("sqrt", lambda x, a: torch.sqrt(x))
_unary("rsqrt", lambda x, a: torch.rsqrt(x))
_unary("abs", lambda x, a: _grad_rules.abs(x))
_unary("ceil", lambda x, a: torch.ceil(x))
_unary("floor", lambda x, a: torch.floor(x))
_unary("cos", lambda x, a: torch.cos(x))
_unary("sin", lambda x, a: torch.sin(x))
# half to even, as jnp.round
_unary("round", lambda x, a: torch.round(x))
_unary("reciprocal", lambda x, a: 1.0 / x)
_unary("log", lambda x, a: torch.log(x))
_unary("square", lambda x, a: torch.square(x))
_unary("softplus", lambda x, a: _softplus(x))
_unary("softsign", lambda x, a: x / (torch.abs(x) + 1))
_unary("brelu", lambda x, a: clip(x, a.get("t_min", 0.0),
                                  a.get("t_max", 24.0)))
_unary("leaky_relu", lambda x, a: torch.where(x >= 0, x,
                                              a.get("alpha", 0.02) * x))
_unary("soft_relu", lambda x, a: torch.log1p(torch.exp(clip(
    x, -a.get("threshold", 40.0), a.get("threshold", 40.0)))))
_unary("elu", lambda x, a: _elu(x, a.get("alpha", 1.0)))
_unary("relu6", lambda x, a: clip(x, 0.0, a.get("threshold", 6.0)))
_unary("pow", lambda x, a: torch.pow(x, a.get("factor", 1.0)))
_unary("stanh", lambda x, a: a.get("scale_b", 1.7159) * torch.tanh(
    a.get("scale_a", 2.0 / 3.0) * x))
_unary("hard_shrink", lambda x, a: _where0(
    torch.abs(x) > a.get("threshold", 0.5), x))
_unary("softshrink", lambda x, a: torch.sign(x) * torch.relu(
    torch.abs(x) - a.get("lambda", 0.5)))
_unary("hard_sigmoid", lambda x, a: clip(
    a.get("slope", 0.2) * x + a.get("offset", 0.5), 0.0, 1.0))
_unary("swish", lambda x, a: x * torch.sigmoid(a.get("beta", 1.0) * x))
_unary("hard_swish", lambda x, a: x * clip(
    x + a.get("offset", 3.0), 0.0, a.get("threshold", 6.0))
    / a.get("scale", 6.0))
_unary("mish", lambda x, a: x * torch.tanh(_softplus(x)))
_unary("thresholded_relu", lambda x, a: _where0(
    x > a.get("threshold", 1.0), x))
# erf by default, as jax.nn.gelu(approximate=False) computes it; the
# ``approximate`` attr takes the tanh form
_unary("gelu", lambda x, a: F.gelu(
    x, approximate="tanh" if a.get("approximate", False) else "none"))
_unary("erf", lambda x, a: torch.erf(x))
_unary("selu", lambda x, a: a.get("scale", 1.0507009873554805) * torch.where(
    x > 0, x, a.get("alpha", 1.6732632423543772) * (torch.exp(x) - 1)))
_unary("sign", lambda x, a: torch.sign(x))


@register_op("prelu")
def _prelu(ctx, ins, attrs):
    """ref operators/prelu_op.cc: one alpha (``all``), one a channel
    (dim 1) or one an element of a sample."""
    x = single_input(ins)
    alpha = single_input(ins, "Alpha")
    mode = attrs.get("mode", "all")
    if mode == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (x.ndim - 2))
    elif mode == "element":
        alpha = alpha.reshape((1,) + tuple(x.shape[1:]))
    return {"Out": [torch.where(x > 0, x, alpha * x)]}


@register_op("maxout")
def _maxout(ctx, ins, attrs):
    """ref operators/maxout_op.cc: NCHW, the max over each group of
    ``groups`` consecutive channels."""
    x = single_input(ins)
    groups = int(attrs["groups"])
    n, c = x.shape[0], x.shape[1]
    x = x.reshape((n, c // groups, groups) + tuple(x.shape[2:]))
    return {"Out": [torch.amax(x, dim=2)]}
