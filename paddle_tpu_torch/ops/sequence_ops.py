"""Sequence ops over dense padded batches (counterpart of
paddle_tpu/ops/sequence_ops.py: ``_mask`` :24, sequence_pool :50 and
sequence_erase :166, which layers.edit_distance's ``ignored_tokens``
appends).

The reference's LoD-ragged batches are dense [B, T, ...] tensors with an
optional [B, T] 0/1 Mask or a [B] Length, as in the JAX package; padding
is masked out of every pool.
"""
from __future__ import annotations

import torch

from ..framework.registry import register_op, single_input


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
