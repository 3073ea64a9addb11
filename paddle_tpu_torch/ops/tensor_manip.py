"""Shape manipulation ops (counterpart of paddle_tpu/ops/tensor_manip.py:
reshape :20, transpose :38, split :56 and unsqueeze :108)."""
from __future__ import annotations

import numpy as np
import torch

from ..framework.registry import register_op, single_input


@register_op("reshape")
def _reshape(ctx, ins, attrs):
    x = single_input(ins)
    # ref reshape semantics: 0 means copy input dim at that position
    shape = [x.shape[i] if s == 0 else s
             for i, s in enumerate(attrs["shape"])]
    return {"Out": [x.reshape(shape)]}


@register_op("transpose")
def _transpose(ctx, ins, attrs):
    return {"Out": [torch.permute(single_input(ins), list(attrs["axis"]))]}


@register_op("split")
def _split(ctx, ins, attrs):
    """By ``sections`` (cut at the running sums of all but the last
    section, which takes the rest, as the JAX lowering cuts) or into
    ``num`` equal parts, which must divide the axis."""
    x = single_input(ins)
    axis = int(attrs.get("axis", 0))
    sections = list(attrs.get("sections", []) or [])
    if sections:
        cuts = np.cumsum(sections[:-1]).tolist()
        return {"Out": list(torch.tensor_split(x, cuts, dim=axis))}
    num = int(attrs.get("num", 0))
    if num <= 0 or x.shape[axis] % num:
        raise ValueError(f"split: axis {axis} of size {x.shape[axis]} "
                         f"does not divide into {num} equal parts")
    return {"Out": list(torch.tensor_split(x, num, dim=axis))}


@register_op("unsqueeze")
def _unsqueeze(ctx, ins, attrs):
    x = single_input(ins)
    for ax in sorted(attrs["axes"]):
        x = torch.unsqueeze(x, ax)
    return {"Out": [x]}
