"""Pointwise activations and unary math (counterpart of
paddle_tpu/ops/activation.py: relu :28, sigmoid :29, tanh :31, sqrt
:34, square :44, gelu :74 and sign :80; the global-norm clip and the L1
regularizer use sqrt and sign, BERT's heads gelu and tanh, DeepFM's FM
term square and its click probability sigmoid)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..framework.registry import register_op, single_input


def _unary(name, fn):
    @register_op(name)
    def _lower(ctx, ins, attrs, _fn=fn):
        return {"Out": [_fn(single_input(ins), attrs)]}
    return _lower


_unary("relu", lambda x, a: torch.relu(x))
_unary("sigmoid", lambda x, a: torch.sigmoid(x))
_unary("tanh", lambda x, a: torch.tanh(x))
_unary("sqrt", lambda x, a: torch.sqrt(x))
_unary("sign", lambda x, a: torch.sign(x))
_unary("square", lambda x, a: torch.square(x))
# erf by default, as jax.nn.gelu(approximate=False) computes it; the
# ``approximate`` attr takes the tanh form
_unary("gelu", lambda x, a: F.gelu(
    x, approximate="tanh" if a.get("approximate", False) else "none"))
