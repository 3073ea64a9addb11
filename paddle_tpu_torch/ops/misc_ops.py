"""Miscellaneous ops (counterpart of paddle_tpu/ops/misc_ops.py:
label_smooth :435)."""
from __future__ import annotations

from ..framework.registry import register_op, single_input


@register_op("label_smooth")
def _label_smooth(ctx, ins, attrs):
    """ref label_smooth_op.cc: (1 - eps) * x + eps * prior, the prior
    ``PriorDist`` where it is given, else uniform over the last dim."""
    x = single_input(ins, "X")
    eps = float(attrs.get("epsilon", 0.1))
    prior = ins["PriorDist"][0] if ins.get("PriorDist") else (
        1.0 / x.shape[-1])
    return {"Out": [(1.0 - eps) * x + eps * prior]}
