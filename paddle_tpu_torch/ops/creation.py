"""Tensor creation / fill ops (the initializers' startup-program ops).

Counterpart of paddle_tpu/ops/creation.py: fill_constant :47,
fill_constant_batch_size_like :54, uniform_random :108, gaussian_random :118, assign :138, assign_value
:153, cast :160 and one_hot :172.

Random ops draw from the context's torch.Generator (ctx.rng()); a nonzero
per-op ``seed`` attr seeds a generator of its own, as the reference does.
Draws are made in f32 and cast, like the JAX lowering.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtypes import to_torch_dtype
from ..framework.registry import register_op, single_input


def op_generator(ctx, attrs):
    """The generator a random op draws from: one seeded from its nonzero
    ``seed`` attr, else the context's, on the op's device (None on
    meta, where nothing is drawn)."""
    seed = int(attrs.get("seed", 0) or 0)
    if not seed:
        return ctx.rng()
    if ctx.device.type == "meta":
        return None
    return torch.Generator(device=ctx.device).manual_seed(seed)


@register_op("fill_constant")
def _fill_constant(ctx, ins, attrs):
    dtype = to_torch_dtype(attrs.get("dtype", "float32"))
    shape = tuple(attrs["shape"])
    return {"Out": [torch.full(shape, attrs.get("value", 0.0), dtype=dtype,
                               device=ctx.device)]}


@register_op("fill_constant_batch_size_like")
def _fill_constant_batch_size_like(ctx, ins, attrs):
    """``value`` in the declared ``dtype`` (int32 stays int32), at
    ``shape`` with dim ``output_dim_idx`` taken from Input's dim
    ``input_dim_idx`` (ref fill_constant_batch_size_like_op.cc)."""
    x = single_input(ins, "Input")
    shape = list(attrs["shape"])
    shape[int(attrs.get("output_dim_idx", 0))] = x.shape[
        int(attrs.get("input_dim_idx", 0))]
    dtype = to_torch_dtype(attrs.get("dtype", "float32"))
    return {"Out": [torch.full(tuple(shape), attrs.get("value", 0.0),
                               dtype=dtype, device=x.device)]}


@register_op("uniform_random")
def _uniform_random(ctx, ins, attrs):
    dtype = to_torch_dtype(attrs.get("dtype", "float32"))
    shape = tuple(attrs["shape"])
    lo, hi = float(attrs.get("min", -1.0)), float(attrs.get("max", 1.0))
    u = torch.empty(shape, dtype=torch.float32, device=ctx.device)
    u.uniform_(lo, hi, generator=op_generator(ctx, attrs))
    return {"Out": [u.to(dtype)]}


@register_op("gaussian_random")
def _gaussian_random(ctx, ins, attrs):
    dtype = to_torch_dtype(attrs.get("dtype", "float32"))
    shape = tuple(attrs["shape"])
    mean, std = float(attrs.get("mean", 0.0)), float(attrs.get("std", 1.0))
    g = torch.randn(shape, dtype=torch.float32, device=ctx.device,
                    generator=op_generator(ctx, attrs))
    return {"Out": [(g * std + mean).to(dtype)]}


@register_op("assign")
def _assign(ctx, ins, attrs):
    """Out is X itself, as in the JAX package: no copy.  Gradient
    accumulation snapshots each updated var with it (``.preupdate``);
    that holds because every update op returns new tensors and nothing
    writes a var in place.  An in-place update must make this a copy.
    A StaticRNN step ends with ``assign new -> pre`` for each memory
    (ops/control_flow.py): the alias only binds the memory's name to the
    step's new value, each step starts from a fresh copy of the env, and
    no op writes into a tensor, so no step's value is written through
    the alias."""
    return {"Out": [single_input(ins)]}


@register_op("assign_value")
def _assign_value(ctx, ins, attrs):
    dtype = to_torch_dtype(attrs.get("dtype", "float32"))
    shape = tuple(attrs["shape"])
    if ctx.device.type == "meta":
        return {"Out": [torch.empty(shape, dtype=dtype, device=ctx.device)]}
    vals = np.asarray(attrs["values"]).reshape(shape)
    return {"Out": [torch.as_tensor(vals).to(device=ctx.device,
                                             dtype=dtype)]}


@register_op("cast")
def _cast(ctx, ins, attrs):
    x = single_input(ins)
    return {"Out": [x.to(to_torch_dtype(attrs["out_dtype"]))]}


@register_op("one_hot")
def _one_hot(ctx, ins, attrs):
    """f32 rows with a 1 at each index (a trailing dim of 1 squeezed
    first), as jax.nn.one_hot gives them: an index outside [0, depth)
    gives a row of zeros.  A comparison against an arange, so the card
    neither raises on such an index (F.one_hot does) nor reads the
    indices back to the host to check them.  No gradient reaches the
    indices (JAX registers the op stop_gradient)."""
    x = single_input(ins)
    depth = int(attrs["depth"])
    if x.ndim and x.shape[-1] == 1:
        x = x.squeeze(-1)
    cols = torch.arange(depth, device=x.device)
    return {"Out": [(x.long()[..., None] == cols).to(torch.float32)]}
