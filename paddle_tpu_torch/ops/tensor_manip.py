"""Shape, layout and indexing ops (counterpart of
paddle_tpu/ops/tensor_manip.py :20-361: reshape, transpose, concat,
split, squeeze, unsqueeze, expand, slice and gather, and the dense
plane's reshape2, transpose2, stack, unstack, unbind, squeeze2,
unsqueeze2, flatten, flatten2, flatten_contiguous_range, expand_as,
tile, strided_slice, gather_nd, scatter, scatter_nd_add, pad, pad2d,
pad_constant_like, crop, reverse, flip, roll, multiplex, where,
where_index, space_to_depth, pixel_shuffle, is_empty and shard_index).

The ``*2`` ops' XShape, where_index and shard_index are int64 (the port's
integer width; JAX's 32-bit plane gives int32).  Indices must lie in
range: where jnp's gathers clamp an index outside it, torch raises (a
device-side assert on the card)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

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


def _xshape(x):
    """The ``*2`` ops' XShape: X's shape as an int64 vector."""
    return torch.tensor(tuple(x.shape), dtype=torch.int64, device=x.device)


@register_op("reshape2")
def _reshape2(ctx, ins, attrs):
    x = single_input(ins)
    return {"Out": _reshape(ctx, ins, attrs)["Out"], "XShape": [_xshape(x)]}


@register_op("transpose2")
def _transpose2(ctx, ins, attrs):
    x = single_input(ins)
    return {"Out": _transpose(ctx, ins, attrs)["Out"],
            "XShape": [_xshape(x)]}


@register_op("squeeze2")
def _squeeze2(ctx, ins, attrs):
    x = single_input(ins)
    return {"Out": _squeeze(ctx, ins, attrs)["Out"], "XShape": [_xshape(x)]}


@register_op("unsqueeze2")
def _unsqueeze2(ctx, ins, attrs):
    x = single_input(ins)
    return {"Out": _unsqueeze(ctx, ins, attrs)["Out"],
            "XShape": [_xshape(x)]}


@register_op("stack")
def _stack(ctx, ins, attrs):
    return {"Y": [torch.stack(list(ins["X"]), dim=int(attrs.get("axis", 0)))]}


@register_op("unstack")
def _unstack(ctx, ins, attrs):
    return {"Y": list(torch.unbind(single_input(ins),
                                   dim=int(attrs.get("axis", 0))))}


@register_op("unbind")
def _unbind(ctx, ins, attrs):
    return _unstack(ctx, ins, attrs)


@register_op("flatten")
def _flatten(ctx, ins, attrs):
    """[prod(dims before axis), prod(the rest)]."""
    x = single_input(ins)
    axis = int(attrs.get("axis", 1))
    lead = int(np.prod(x.shape[:axis])) if axis else 1
    return {"Out": [x.reshape(lead, -1)]}


@register_op("flatten2")
def _flatten2(ctx, ins, attrs):
    x = single_input(ins)
    return {"Out": _flatten(ctx, ins, attrs)["Out"], "XShape": [_xshape(x)]}


@register_op("flatten_contiguous_range")
def _flatten_contiguous_range(ctx, ins, attrs):
    x = single_input(ins)
    start = int(attrs.get("start_axis", 1)) % x.ndim
    stop = int(attrs.get("stop_axis", -1)) % x.ndim
    return {"Out": [torch.flatten(x, start, stop)]}


@register_op("expand_as")
def _expand_as(ctx, ins, attrs):
    x = single_input(ins)
    target = single_input(ins, "target_tensor" if "target_tensor" in ins
                          else "Y")
    return {"Out": [torch.broadcast_to(x, tuple(target.shape))]}


@register_op("tile")
def _tile(ctx, ins, attrs):
    return {"Out": [torch.tile(single_input(ins),
                               tuple(int(t) for t in attrs["repeat_times"]))]}


@register_op("strided_slice")
def _strided_slice(ctx, ins, attrs):
    """Python's x[start:end:stride] on each listed axis, a negative stride
    included (torch slices take none: that axis is an index_select)."""
    x = single_input(ins, "Input")
    idx = [slice(None)] * x.ndim
    picks = []
    for ax, s, e, st in zip(attrs["axes"], attrs["starts"], attrs["ends"],
                            attrs["strides"]):
        r = range(x.shape[ax])[slice(s, e, st)]
        if st > 0:
            idx[ax] = slice(r.start, r.start + len(r) * r.step, r.step)
        else:
            picks.append((ax, r))
    out = x[tuple(idx)]
    for ax, r in picks:
        out = torch.index_select(out, ax, torch.arange(
            r.start, r.stop, r.step, device=x.device))
    return {"Out": [out]}


def _nd_index(idx):
    """The trailing dim of an [..., k] index as k index tensors."""
    return tuple(torch.unbind(idx.long(), dim=-1))


@register_op("gather_nd")
def _gather_nd(ctx, ins, attrs):
    x = single_input(ins)
    return {"Out": [x[_nd_index(single_input(ins, "Index"))]]}


@register_op("scatter")
def _scatter(ctx, ins, attrs):
    """ref scatter_op.cc: the rows of X at Ids overwritten by Updates
    (``overwrite``, the default) or added to.  Where an id repeats, the
    overwrite keeps its last update, as XLA's in-order scatter does, and
    only that update gets a gradient: each row takes the update at the
    largest position naming it (an amax of positions, so no winner is
    left to the card's scheduling), and the rows nothing names keep X.
    The add is ``index_add``: atomic on the card, so repeated ids sum in
    an order that may differ from the CPU's in the last bits."""
    x = single_input(ins)
    ids = single_input(ins, "Ids")
    upd = single_input(ins, "Updates")
    if ids.ndim == 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    ids = ids.long()
    if not attrs.get("overwrite", True):
        return {"Out": [torch.index_add(x, 0, ids, upd.to(x.dtype))]}
    pos = torch.arange(ids.shape[0], device=ids.device)
    last = torch.full((x.shape[0],), -1, dtype=torch.int64, device=x.device)
    last = last.scatter_reduce(0, ids, pos, reduce="amax")
    hit = (last >= 0).reshape((-1,) + (1,) * (x.ndim - 1))
    taken = torch.index_select(upd, 0, last.clamp(min=0)).to(x.dtype)
    return {"Out": [torch.where(hit, taken, x)]}


@register_op("scatter_nd_add")
def _scatter_nd_add(ctx, ins, attrs):
    """X with Updates added at the [..., k] Index (repeats accumulate;
    atomic on the card)."""
    x = single_input(ins)
    idx = single_input(ins, "Index")
    upd = single_input(ins, "Updates")
    return {"Out": [torch.index_put(x, _nd_index(idx), upd.to(x.dtype),
                                    accumulate=True)]}


def _pad_pairs(pads):
    """[(lo, hi)] per dim, first dim first, as F.pad's flat list (last dim
    first)."""
    return [p for lo_hi in reversed(pads) for p in lo_hi]


@register_op("pad")
def _pad(ctx, ins, attrs):
    """``paddings`` is [d0_lo, d0_hi, d1_lo, d1_hi, ...]."""
    x = single_input(ins)
    p = attrs["paddings"]
    pads = [(p[2 * i], p[2 * i + 1]) for i in range(x.ndim)]
    return {"Out": [F.pad(x, _pad_pairs(pads),
                          value=float(attrs.get("pad_value", 0.0)))]}


@register_op("pad2d")
def _pad2d(ctx, ins, attrs):
    """NCHW spatial pad (ref pad2d_op.cc): ``constant``, ``reflect``
    (jnp.pad's reflect, the edge not repeated) or ``edge``."""
    x = single_input(ins)
    t, b, l, r = attrs["paddings"]
    mode = attrs.get("mode", "constant")
    if mode == "constant":
        return {"Out": [F.pad(x, (l, r, t, b),
                              value=float(attrs.get("pad_value", 0.0)))]}
    tmode = {"reflect": "reflect", "edge": "replicate"}[mode]
    return {"Out": [F.pad(x, (l, r, t, b), mode=tmode)]}


@register_op("pad_constant_like")
def _pad_constant_like(ctx, ins, attrs):
    """Y padded at the end of each dim to X's shape."""
    x, y = ins["X"][0], ins["Y"][0]
    pads = [(0, xs - ys) for xs, ys in zip(x.shape, y.shape)]
    return {"Out": [F.pad(y, _pad_pairs(pads),
                          value=float(attrs.get("pad_value", 0.0)))]}


@register_op("crop")
def _crop(ctx, ins, attrs):
    """``shape`` from ``offsets``; -1 in shape keeps the rest of the dim
    (the batch-dim idiom, ref crop_op.cc)."""
    x = single_input(ins)
    idx = tuple(slice(o, None if s == -1 else o + s)
                for o, s in zip(attrs["offsets"], attrs["shape"]))
    return {"Out": [x[idx]]}


@register_op("reverse")
def _reverse(ctx, ins, attrs):
    return {"Out": [torch.flip(single_input(ins), list(attrs["axis"]))]}


@register_op("flip")
def _flip(ctx, ins, attrs):
    return _reverse(ctx, ins, attrs)


@register_op("roll")
def _roll(ctx, ins, attrs):
    return {"Out": [torch.roll(single_input(ins), list(attrs["shifts"]),
                               dims=list(attrs.get("axis", [0])))]}


@register_op("multiplex")
def _multiplex(ctx, ins, attrs):
    """Row i of the Ids[i]-th candidate (ref multiplex_op.cc)."""
    ids = single_input(ins, "Ids").reshape(-1).long()
    stacked = torch.stack(list(ins["X"]), dim=0)        # (K, N, ...)
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return {"Out": [stacked[ids, rows]]}


@register_op("where")
def _where(ctx, ins, attrs):
    c = single_input(ins, "Condition")
    return {"Out": [torch.where(c.bool(), ins["X"][0], ins["Y"][0])]}


@register_op("where_index")
def _where_index(ctx, ins, attrs):
    """The coordinates of Condition's true entries in row-major order, as
    jnp.nonzero(size=numel, fill_value=-1) gives them: numel rows, the
    rows past the count of true entries -1 (a static shape, unlike
    torch.nonzero).  A stable sort puts the true entries first."""
    c = single_input(ins, "Condition")
    flat = c.reshape(-1).bool()
    n = flat.shape[0]
    order = torch.sort((~flat).to(torch.uint8), stable=True).indices
    coords, rest = [], order
    for size in reversed(tuple(c.shape)):
        coords.append(torch.remainder(rest, size))
        rest = torch.div(rest, size, rounding_mode="floor")
    coords = torch.stack(coords[::-1], dim=-1)
    valid = torch.arange(n, device=c.device) < flat.sum()
    return {"Out": [torch.where(valid[:, None], coords,
                                torch.full((), -1, dtype=torch.int64,
                                           device=c.device))]}


@register_op("space_to_depth")
def _space_to_depth(ctx, ins, attrs):
    x = single_input(ins)                               # NCHW
    bs = int(attrs["blocksize"])
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // bs, bs, w // bs, bs).permute(0, 3, 5, 1, 2, 4)
    return {"Out": [x.reshape(n, c * bs * bs, h // bs, w // bs)]}


@register_op("pixel_shuffle")
def _pixel_shuffle(ctx, ins, attrs):
    x = single_input(ins)                               # NCHW
    r = int(attrs["upscale_factor"])
    n, c, h, w = x.shape
    x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return {"Out": [x.reshape(n, c // (r * r), h * r, w * r)]}


@register_op("is_empty")
def _is_empty(ctx, ins, attrs):
    x = single_input(ins)
    return {"Out": [torch.tensor(x.numel() == 0, device=x.device)]}


@register_op("shard_index")
def _shard_index(ctx, ins, attrs):
    """Global ids to this shard's local ids, ``ignore_value`` for ids of
    other shards (ref shard_index_op.cc)."""
    x = single_input(ins)
    nshards = int(attrs["nshards"])
    size = (int(attrs["index_num"]) + nshards - 1) // nshards
    in_shard = torch.div(x, size, rounding_mode="floor") == int(
        attrs["shard_id"])
    return {"Out": [torch.where(in_shard, torch.remainder(x, size),
                                torch.full((), int(attrs.get(
                                    "ignore_value", -1)), dtype=x.dtype,
                                    device=x.device))]}
