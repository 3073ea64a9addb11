"""Shape manipulation ops (counterpart of paddle_tpu/ops/tensor_manip.py:
reshape :20, transpose :38, concat :51, split :56, squeeze :88, unsqueeze :108,
expand :148, slice :170 and gather :198)."""
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


@register_op("concat")
def _concat(ctx, ins, attrs):
    """The X list joined along ``axis``; mixed dtypes promote (torch.cat's
    rule and jnp.concatenate's agree on float widths and int to float)."""
    return {"Out": [torch.cat(list(ins["X"]), dim=int(attrs.get("axis", 0)))]}


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


@register_op("squeeze")
def _squeeze(ctx, ins, attrs):
    """Only the listed axes of size 1 go (a listed axis of another size
    stays); with no axes, every axis of size 1 goes."""
    x = single_input(ins)
    axes = attrs.get("axes", [])
    if axes:
        for ax in sorted((a % x.ndim for a in axes), reverse=True):
            if x.shape[ax] == 1:
                x = torch.squeeze(x, ax)
    else:
        x = torch.squeeze(x)
    return {"Out": [x]}


@register_op("unsqueeze")
def _unsqueeze(ctx, ins, attrs):
    x = single_input(ins)
    for ax in sorted(attrs["axes"]):
        x = torch.unsqueeze(x, ax)
    return {"Out": [x]}


@register_op("expand")
def _expand(ctx, ins, attrs):
    """ref expand_op.cc: each dim tiled by its ``expand_times`` entry
    (np.tile's rule, as jnp.tile's)."""
    x = single_input(ins)
    return {"Out": [torch.tile(x, tuple(int(t) for t in
                                        attrs["expand_times"]))]}


@register_op("slice")
def _slice(ctx, ins, attrs):
    """ref slice_op.cc: static [start, end) per listed axis, a negative
    bound counted from the end, both clamped to the axis; then the
    ``decrease_axis`` dims squeezed."""
    x = single_input(ins, "Input")
    idx = [slice(None)] * x.ndim
    for ax, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x.shape[ax]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[ax] = slice(s, e)
    out = x[tuple(idx)]
    for ax in sorted(attrs.get("decrease_axis", []), reverse=True):
        out = torch.squeeze(out, ax)
    return {"Out": [out]}


@register_op("gather")
def _gather(ctx, ins, attrs):
    """The rows of X at Index ([N] or [N, 1]) along ``axis``.  Indices
    must lie in [0, X.shape[axis]): where jnp.take fills the row of an
    index outside it, the port raises (index_select's bounds check: an
    IndexError on the CPU, a device-side assert on the card).  The
    backward is index_select's scatter-add, atomic on the card, so its
    sums over repeated indices may differ in their last bits run to
    run."""
    x = single_input(ins)
    idx = single_input(ins, "Index")
    if idx.ndim == 2 and idx.shape[-1] == 1:
        idx = idx.squeeze(-1)
    return {"Out": [torch.index_select(x, int(attrs.get("axis", 0)),
                                       idx.long())]}
