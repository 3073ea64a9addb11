"""Reductions (counterpart of paddle_tpu/ops/reduce_ops.py: the
``_reduce`` family :15-39, arg_max :42, arg_min :49, argsort :56 and
top_k :67).  The index outputs are int64 (the port's integer width;
JAX's 32-bit plane gives int32)."""
from __future__ import annotations

import torch

from ..framework.registry import register_op, single_input


def _axes(attrs, ndim):
    """The reduced dims (JAX :15-21): every dim under ``reduce_all``,
    else ``dim`` (an int or a list, negative dims counted from the
    end)."""
    if attrs.get("reduce_all", False):
        return tuple(range(ndim))
    dim = attrs.get("dim", [0])
    if isinstance(dim, int):
        dim = [dim]
    return tuple(sorted({d % ndim for d in dim}))


def _over(fn):
    """A torch reduction of one dim applied over several, last dim first
    (torch.prod takes one dim only); no dims (a 0-d x) reduces all."""
    def reduce(x, dims, keepdim):
        if not dims:
            return fn(x)
        for d in sorted(dims, reverse=True):
            x = fn(x, dim=d, keepdim=keepdim)
        return x
    return reduce


def _reduce(name, fn):
    @register_op(name)
    def _lower(ctx, ins, attrs, _fn=fn):
        """A full reduction gives a 0-d tensor, as jnp.sum(axis=None)
        does (keep_dim keeps every dim as 1)."""
        x = single_input(ins)
        return {"Out": [_fn(x, _axes(attrs, x.ndim),
                            bool(attrs.get("keep_dim", False)))]}
    return _lower


_reduce("reduce_sum", lambda x, d, k: torch.sum(x, dim=d, keepdim=k))
_reduce("reduce_mean", lambda x, d, k: torch.mean(x, dim=d, keepdim=k))
_reduce("reduce_max", lambda x, d, k: torch.amax(x, dim=d, keepdim=k))
_reduce("reduce_min", lambda x, d, k: torch.amin(x, dim=d, keepdim=k))
_reduce("reduce_prod", _over(torch.prod))
_reduce("reduce_all", _over(torch.all))
_reduce("reduce_any", _over(torch.any))


@register_op("arg_max")
def _arg_max(ctx, ins, attrs):
    """The first index of the max along ``axis``, as jnp.argmax."""
    return {"Out": [torch.argmax(single_input(ins),
                                 dim=int(attrs.get("axis", -1)))]}


@register_op("arg_min")
def _arg_min(ctx, ins, attrs):
    return {"Out": [torch.argmin(single_input(ins),
                                 dim=int(attrs.get("axis", -1)))]}


@register_op("argsort")
def _argsort(ctx, ins, attrs):
    """A stable sort of x, or of -x when ``descending`` (JAX's key: equal
    entries keep their order either way).  Out is x gathered by the
    indices, so it carries a gradient back to x."""
    x = single_input(ins)
    axis = int(attrs.get("axis", -1))
    key = -x if attrs.get("descending", False) else x
    idx = torch.sort(key, dim=axis, stable=True).indices
    return {"Out": [torch.take_along_dim(x, idx, dim=axis)],
            "Indices": [idx]}


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
