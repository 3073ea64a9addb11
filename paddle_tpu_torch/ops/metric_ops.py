"""In-graph metric ops (counterpart of paddle_tpu/ops/metric_ops.py:
accuracy :17)."""
from __future__ import annotations

import torch

from ..framework.registry import register_op, single_input


@register_op("accuracy")
def _accuracy(ctx, ins, attrs):
    """Inputs follow the reference: Out (top-k values), Indices (top-k
    ids), Label.  Accuracy (f32) is the share of rows whose label is among
    their indices; Correct and Total are int32 scalars, as the layer
    declares them."""
    idx = single_input(ins, "Indices")
    label = single_input(ins, "Label")
    if label.ndim >= 2 and label.shape[-1] == 1:
        label = label.squeeze(-1)
    hit = torch.any(idx == label[..., None].to(idx.dtype), dim=-1)
    correct = torch.sum(hit, dtype=torch.int32)
    total = torch.full((), hit.numel(), dtype=torch.int32, device=hit.device)
    acc = correct.float() / total.float()
    return {"Accuracy": [acc], "Correct": [correct], "Total": [total]}
