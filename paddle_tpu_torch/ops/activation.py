"""Pointwise activations and unary math (counterpart of
paddle_tpu/ops/activation.py: relu :28, sqrt :34 and sign :80; the
global-norm clip and the L1 regularizer use the last two)."""
from __future__ import annotations

import torch

from ..framework.registry import register_op, single_input


def _unary(name, fn):
    @register_op(name)
    def _lower(ctx, ins, attrs, _fn=fn):
        return {"Out": [_fn(single_input(ins))]}
    return _lower


_unary("relu", torch.relu)
_unary("sqrt", torch.sqrt)
_unary("sign", torch.sign)
