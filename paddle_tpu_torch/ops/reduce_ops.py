"""Reductions (counterpart of paddle_tpu/ops/reduce_ops.py: top_k
:67)."""
from __future__ import annotations

import torch

from ..framework.registry import register_op, single_input


@register_op("top_k")
def _top_k(ctx, ins, attrs):
    """The k largest entries of the last dim and their int64 indices, in
    lax.top_k's order: descending, and among equal values the lower index
    first.  torch.topk promises no order among equal values on CUDA, so
    this is a stable descending sort cut to k."""
    x = single_input(ins)
    k = int(attrs["k"])
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return {"Out": [vals[..., :k]], "Indices": [idx[..., :k]]}
