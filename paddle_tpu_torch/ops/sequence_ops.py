"""Sequence ops over dense padded batches (counterpart of
paddle_tpu/ops/sequence_ops.py: ``_mask`` :24, sequence_mask :36,
sequence_pool :50, sequence_softmax :79, sequence_expand :89,
sequence_reverse :99, sequence_concat :115, sequence_slice :120,
sequence_pad :128, sequence_unpad :145, sequence_enumerate :153,
sequence_erase :166 (which layers.edit_distance's ``ignored_tokens``
appends), sequence_expand_as :175, sequence_reshape :183,
sequence_scatter :191, lod_reset :201, row_conv :207 and
add_position_encoding :221).

The reference's LoD-ragged batches are dense [B, T, ...] tensors with an
optional [B, T] 0/1 Mask or a [B] Length, as in the JAX package; padding
is masked out of every pool.
"""
from __future__ import annotations

import torch

from ..core.dtypes import to_torch_dtype
from ..framework.registry import register_op, single_input
from ._grad_rules import div


def wrap_or_drop(idx, n):
    """An index into a dim of n as ``.at[idx]`` takes it in an update:
    a negative index wraps once (idx + n); what is still outside [0, n)
    is dropped.  Returns (an index safe to use, the mask of those kept);
    the caller zeroes the dropped entries' updates."""
    idx = torch.where(idx < 0, idx + n, idx)
    keep = (idx >= 0) & (idx < n)
    return torch.where(keep, idx, torch.zeros_like(idx)), keep


def _expand_time(x, t):
    """x [B, ...] repeated along a new axis 1 of length t."""
    return x.unsqueeze(1).repeat((1, t) + (1,) * (x.ndim - 1))


def _mask(x, ins, time_axis=1):
    """The [B, T] float mask from an optional Mask or Length input (all
    ones without either)."""
    if ins.get("Mask"):
        return ins["Mask"][0].reshape(x.shape[:2]).float()
    if not ins.get("Length"):
        return torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
    length = ins["Length"][0].reshape(-1)
    t = torch.arange(x.shape[time_axis], device=x.device)
    return (t[None, :] < length[:, None]).float()


@register_op("sequence_pool")
def _sequence_pool(ctx, ins, attrs):
    """AVERAGE, SUM, SQRT, MAX, LAST or FIRST over the time axis of [B, T,
    ...] with the padding masked out (ref sequence_pool_op.cc).  The
    count divides at least by 1; MAX gives the dtype's lowest value to a
    row with no token; LAST takes the entry at the mask's sum less one
    (at least 0); FIRST takes step 0.  The mask is f32, so a bf16 X
    computes in f32, as jnp promotes it."""
    x = single_input(ins)
    ptype = attrs.get("pooltype", "AVERAGE").upper()
    m = _mask(x, ins)
    m_exp = m.reshape(m.shape + (1,) * (x.ndim - 2))
    cnt = torch.clamp(m.sum(dim=1), min=1.0).reshape(
        (-1,) + (1,) * (x.ndim - 2))
    if ptype == "AVERAGE":
        out = (x * m_exp).sum(dim=1) / cnt
    elif ptype == "SUM":
        out = (x * m_exp).sum(dim=1)
    elif ptype == "SQRT":
        out = (x * m_exp).sum(dim=1) / torch.sqrt(cnt)
    elif ptype == "MAX":
        low = torch.finfo(x.dtype).min
        out = torch.where(m_exp > 0, x, low).amax(dim=1)
    elif ptype == "LAST":
        idx = torch.clamp(m.sum(dim=1).to(torch.int32) - 1, min=0).long()
        idx = idx.reshape((-1, 1) + (1,) * (x.ndim - 2)).expand(
            (x.shape[0], 1) + tuple(x.shape[2:]))
        out = torch.gather(x, 1, idx).squeeze(1)
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise ValueError(f"unknown pooltype {ptype}")
    return {"Out": [out]}


@register_op("sequence_erase")
def _sequence_erase(ctx, ins, attrs):
    """The listed tokens replaced by the pad 0 (the dense analogue of the
    reference's erase, JAX's jnp.isin)."""
    x = single_input(ins)
    tokens = torch.as_tensor(list(attrs["tokens"]), dtype=x.dtype,
                             device=x.device)
    hit = torch.any(x[..., None] == tokens, dim=-1)
    return {"Out": [torch.where(hit, torch.zeros((), dtype=x.dtype,
                                                 device=x.device), x)]}


@register_op("sequence_mask")
def _sequence_mask(ctx, ins, attrs):
    """Y [B, maxlen]: 1 where the step is below X's length; the static
    ``maxlen`` attr is required (a shape cannot come from a value).
    ``out_dtype`` defaults to int64."""
    length = single_input(ins)
    maxlen = int(attrs.get("maxlen", -1))
    if maxlen <= 0:
        raise ValueError("sequence_mask needs a static maxlen attr")
    steps = torch.arange(maxlen, device=length.device)
    out = steps[None, :] < length.reshape(-1, 1)
    return {"Y": [out.to(to_torch_dtype(attrs.get("out_dtype", "int64")))]}


@register_op("sequence_softmax")
def _sequence_softmax(ctx, ins, attrs):
    """A softmax over the time axis of [B, T] or [B, T, ...] with the
    padding at -1e9 before it and 0 after it."""
    x = single_input(ins)
    m = _mask(x, ins)
    m_exp = m.reshape(m.shape + (1,) * (x.ndim - 2))
    logits = torch.where(m_exp > 0, x, -1e9)
    return {"Out": [torch.softmax(logits, dim=1) * m_exp]}


@register_op("sequence_expand")
def _sequence_expand(ctx, ins, attrs):
    """X [B, ...] repeated along a new time axis as long as Y's (the
    dense analogue of sequence_expand_op.cc)."""
    x = single_input(ins)
    return {"Out": [_expand_time(x, single_input(ins, "Y").shape[1])]}


@register_op("sequence_expand_as")
def _sequence_expand_as(ctx, ins, attrs):
    x = single_input(ins)
    return {"Out": [_expand_time(x, single_input(ins, "Y").shape[1])]}


@register_op("sequence_reverse")
def _sequence_reverse(ctx, ins, attrs):
    """Each row's valid steps reversed, its padding left in place (the
    whole time axis without a Length)."""
    x = single_input(ins)
    if not ins.get("Length"):
        return {"Y": [torch.flip(x, dims=[1])]}
    length = ins["Length"][0].reshape(-1).long()
    idx = torch.arange(x.shape[1], device=x.device)[None, :]
    rev = torch.where(idx < length[:, None], length[:, None] - 1 - idx, idx)
    rev = rev.reshape(rev.shape + (1,) * (x.ndim - 2)).expand(x.shape)
    return {"Y": [torch.gather(x, 1, rev)]}


@register_op("sequence_concat")
def _sequence_concat(ctx, ins, attrs):
    return {"Out": [torch.cat(list(ins["X"]), dim=1)]}


@register_op("sequence_slice")
def _sequence_slice(ctx, ins, attrs):
    """Steps [offset, offset + length) of every row (static attrs)."""
    x = single_input(ins)
    off = int(attrs["offset"])
    return {"Out": [x[:, off:off + int(attrs["length"])]]}


@register_op("sequence_pad")
def _sequence_pad(ctx, ins, attrs):
    """The time axis cut or padded with ``pad_value`` to
    ``padded_length``, which slices as a Python slice does (-1, the
    layer's default, drops the last step, as JAX's lowering does); Length
    passes the input's through, or is T for every row (int64)."""
    x = single_input(ins)
    target = int(attrs["padded_length"])
    t = x.shape[1]
    if t >= target:
        out = x[:, :target]
    else:
        pad = torch.full((x.shape[0], target - t) + tuple(x.shape[2:]),
                         attrs.get("pad_value", 0.0), dtype=x.dtype,
                         device=x.device)
        out = torch.cat([x, pad], dim=1)
    length = (ins["Length"][0] if ins.get("Length")
              else torch.full((x.shape[0],), t, dtype=torch.int64,
                              device=x.device))
    return {"Out": [out], "Length": [length]}


@register_op("sequence_unpad")
def _sequence_unpad(ctx, ins, attrs):
    """The dense stand-in for unpadding: steps past Length zeroed (an f32
    mask product, so an integer X comes out f32, as jnp promotes it)."""
    x = single_input(ins)
    m = _mask(x, ins)
    return {"Out": [x * m.reshape(m.shape + (1,) * (x.ndim - 2))]}


@register_op("sequence_enumerate")
def _sequence_enumerate(ctx, ins, attrs):
    """[B, T] ids -> [B, T, win_size]: each step's window of the next
    win_size ids, ``pad_value`` past the end."""
    x = single_input(ins)
    win = int(attrs["win_size"])
    t = x.shape[1]
    pad = torch.full((x.shape[0], win - 1), int(attrs.get("pad_value", 0)),
                     dtype=x.dtype, device=x.device)
    padded = torch.cat([x, pad], dim=1)
    return {"Out": [torch.stack([padded[:, i:i + t] for i in range(win)],
                                dim=-1)]}


@register_op("sequence_reshape")
def _sequence_reshape(ctx, ins, attrs):
    x = single_input(ins)
    return {"Out": [x.reshape(x.shape[0], -1, int(attrs["new_dim"]))]}


@register_op("sequence_scatter")
def _sequence_scatter(ctx, ins, attrs):
    """Out = X with Updates [B, K, ...] added at (row b, step Ids[b, k]),
    as ``x.at[rows, ids].add(upd)``: a negative id wraps once, an id still
    outside the time axis is dropped, repeated ids sum (atomics on the
    card)."""
    x = single_input(ins)
    ids = single_input(ins, "Ids").long()
    upd = single_input(ins, "Updates").to(x.dtype)
    ids, keep = wrap_or_drop(ids, x.shape[1])
    rows = torch.arange(x.shape[0], device=x.device)[:, None].expand(
        ids.shape)
    keep = keep.reshape(keep.shape + (1,) * (upd.ndim - 2))
    upd = torch.where(keep, upd, torch.zeros((), dtype=upd.dtype,
                                             device=upd.device))
    return {"Out": [x.index_put((rows, ids), upd, accumulate=True)]}


@register_op("lod_reset")
def _lod_reset(ctx, ins, attrs):
    """LoD is edge metadata here: X passes through."""
    return {"Out": [single_input(ins)]}


@register_op("row_conv")
def _row_conv(ctx, ins, attrs):
    """Lookahead row convolution (ref row_conv_op.cc): X [B, T, D] and
    Filter [future + 1, D]; step t sums x[t + i] * w[i], zeros past the
    end, added in JAX's order from a zero tensor."""
    x = single_input(ins)
    w = single_input(ins, "Filter")
    k, t = w.shape[0], x.shape[1]
    padded = torch.cat([x, x.new_zeros((x.shape[0], k - 1) + tuple(
        x.shape[2:]))], dim=1)
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + padded[:, i:i + t] * w[i][None, None, :]
    return {"Out": [out]}


@register_op("add_position_encoding")
def _add_position_encoding(ctx, ins, attrs):
    """alpha * X + beta * the sinusoid table of [B, T, D] (sines in the
    first D / 2 columns, cosines in the rest), built on the device."""
    x = single_input(ins)
    alpha = float(attrs.get("alpha", 1.0))
    beta = float(attrs.get("beta", 1.0))
    _, t, d = x.shape
    pos = torch.arange(t, dtype=torch.float32, device=x.device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=x.device)[None, :]
    angle = pos / torch.pow(torch.full((), 10000.0, device=x.device),
                            div(2 * i, d))
    pe = torch.cat([torch.sin(angle), torch.cos(angle)], dim=1)
    return {"Out": [alpha * x + beta * pe[None].to(x.dtype)]}
