"""Tensor creation / fill ops (the initializers' startup-program ops).

Counterpart of paddle_tpu/ops/creation.py: fill_constant :47,
fill_constant_batch_size_like :54, uniform_random_batch_size_like :67,
gaussian_random_batch_size_like :82, fill_zeros_like :95, fill_any_like
:100, uniform_random :108, gaussian_random :118,
truncated_gaussian_random :128, assign :138, assign_value :153, cast
:160, shape :166, one_hot :172, range :182, eye :195, linspace :203 and
sampling_id :210.

Random ops draw from the context's torch.Generator (ctx.rng()); a nonzero
per-op ``seed`` attr seeds a generator of its own, as the reference does.
Draws are made in f32 and cast, like the JAX lowering.  torch's Philox is
not JAX's threefry: the draws are held to JAX's by their distribution.
``shape`` gives int64 (the port's integer width, where JAX's 32-bit plane
gives int32).
"""
from __future__ import annotations

import math

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


def _batch_size_like(x, attrs):
    """``shape`` with dim ``output_dim_idx`` taken from Input's dim
    ``input_dim_idx``."""
    shape = list(attrs["shape"])
    shape[int(attrs.get("output_dim_idx", 0))] = x.shape[
        int(attrs.get("input_dim_idx", 0))]
    return tuple(shape)


@register_op("fill_constant_batch_size_like")
def _fill_constant_batch_size_like(ctx, ins, attrs):
    """``value`` in the declared ``dtype`` (int32 stays int32), at
    ``shape`` with dim ``output_dim_idx`` taken from Input's dim
    ``input_dim_idx`` (ref fill_constant_batch_size_like_op.cc)."""
    x = single_input(ins, "Input")
    dtype = to_torch_dtype(attrs.get("dtype", "float32"))
    return {"Out": [torch.full(_batch_size_like(x, attrs),
                               attrs.get("value", 0.0), dtype=dtype,
                               device=x.device)]}


def _uniform(ctx, attrs, shape, device):
    lo, hi = float(attrs.get("min", -1.0)), float(attrs.get("max", 1.0))
    u = torch.empty(shape, dtype=torch.float32, device=device)
    u.uniform_(lo, hi, generator=op_generator(ctx, attrs))
    return u.to(to_torch_dtype(attrs.get("dtype", "float32")))


def _gaussian(ctx, attrs, shape, device):
    mean, std = float(attrs.get("mean", 0.0)), float(attrs.get("std", 1.0))
    g = torch.randn(shape, dtype=torch.float32, device=device,
                    generator=op_generator(ctx, attrs))
    return (g * std + mean).to(to_torch_dtype(attrs.get("dtype", "float32")))


@register_op("uniform_random_batch_size_like")
def _uniform_random_batch_size_like(ctx, ins, attrs):
    x = single_input(ins, "Input")
    return {"Out": [_uniform(ctx, attrs, _batch_size_like(x, attrs),
                             x.device)]}


@register_op("gaussian_random_batch_size_like")
def _gaussian_random_batch_size_like(ctx, ins, attrs):
    x = single_input(ins, "Input")
    return {"Out": [_gaussian(ctx, attrs, _batch_size_like(x, attrs),
                              x.device)]}


@register_op("fill_zeros_like")
def _fill_zeros_like(ctx, ins, attrs):
    return {"Out": [torch.zeros_like(single_input(ins))]}


@register_op("fill_any_like")
def _fill_any_like(ctx, ins, attrs):
    """``value`` in ``dtype``, or in X's dtype where none is given."""
    x = single_input(ins)
    dtype = attrs.get("dtype")
    dtype = to_torch_dtype(dtype) if dtype else x.dtype
    return {"Out": [torch.full_like(x, attrs.get("value", 0.0),
                                    dtype=dtype)]}


@register_op("uniform_random")
def _uniform_random(ctx, ins, attrs):
    return {"Out": [_uniform(ctx, attrs, tuple(attrs["shape"]),
                             ctx.device)]}


@register_op("gaussian_random")
def _gaussian_random(ctx, ins, attrs):
    return {"Out": [_gaussian(ctx, attrs, tuple(attrs["shape"]),
                              ctx.device)]}


@register_op("truncated_gaussian_random")
def _truncated_gaussian_random(ctx, ins, attrs):
    """A normal cut to [-2, 2], then scaled and shifted, drawn as
    jax.random.truncated_normal draws it: sqrt(2) erfinv(u) for u uniform
    on [erf(-sqrt 2), erf(sqrt 2)), clamped into the bounds."""
    bound = math.erf(2.0 / math.sqrt(2.0))
    shape = tuple(attrs["shape"])
    u = torch.empty(shape, dtype=torch.float32, device=ctx.device)
    u.uniform_(-bound, bound, generator=op_generator(ctx, attrs))
    g = torch.clamp(math.sqrt(2.0) * torch.erfinv(u), -2.0, 2.0)
    mean, std = float(attrs.get("mean", 0.0)), float(attrs.get("std", 1.0))
    return {"Out": [(g * std + mean).to(
        to_torch_dtype(attrs.get("dtype", "float32")))]}


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


@register_op("shape")
def _shape(ctx, ins, attrs):
    x = single_input(ins, "Input")
    return {"Out": [torch.tensor(tuple(x.shape), dtype=torch.int64,
                                 device=x.device)]}


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


@register_op("range")
def _range(ctx, ins, attrs):
    """start + step * arange(len): the length is the static ``len`` attr
    (a shape read from Start, End and Step would be data-dependent)."""
    start = single_input(ins, "Start")
    step = single_input(ins, "Step")
    if "len" not in attrs:
        raise ValueError("range op inside a program needs a static 'len' "
                         "attr")
    n = int(attrs["len"])
    return {"Out": [start + step * torch.arange(n, dtype=start.dtype,
                                                device=start.device)]}


@register_op("eye")
def _eye(ctx, ins, attrs):
    n = int(attrs["num_rows"])
    m = int(attrs.get("num_columns", n))
    return {"Out": [torch.eye(n, m, device=ctx.device,
                              dtype=to_torch_dtype(attrs.get("dtype",
                                                             "float32")))]}


def jax_linspace(start, stop, num, dtype=torch.float32, device=None):
    """jnp.linspace(start, stop, num) in the float order XLA compiles it
    to: start * (1 - i * r) + i * (stop * r) with r = f32(1 / (num - 1))
    (XLA multiplies by the reciprocal of the constant divisor and folds
    stop into it), the last entry ``stop`` itself.  From start 0 this is
    JAX's bits; elsewhere XLA's CPU code may fuse the add into an FMA and
    differ in the last bit.  torch.linspace counts the second half back
    from ``stop`` instead."""
    if num <= 1:
        return torch.full((num,), float(start), dtype=dtype, device=device)
    rcp = torch.tensor(1.0 / (num - 1), dtype=torch.float32, device=device)
    i = torch.arange(num - 1, dtype=torch.float32, device=device)
    out = float(start) * (1 - i * rcp) + i * (float(stop) * rcp)
    out = torch.cat([out, torch.full((1,), float(stop), dtype=torch.float32,
                                     device=device)])
    return out.to(dtype)


@register_op("linspace")
def _linspace(ctx, ins, attrs):
    return {"Out": [jax_linspace(
        attrs["start"], attrs["stop"], int(attrs["num"]),
        to_torch_dtype(attrs.get("dtype", "float32")), ctx.device)]}


@register_op("sampling_id")
def _sampling_id(ctx, ins, attrs):
    """One category a row, drawn with probability X's entry (ref
    operators/sampling_id_op.cc): the Gumbel-max draw that
    jax.random.categorical makes over log(X + 1e-20), on torch's
    generator.  int64 ids."""
    x = single_input(ins)
    u = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    u.uniform_(0.0, 1.0, generator=op_generator(ctx, attrs))
    gumbel = -torch.log(-torch.log(u))
    return {"Out": [torch.argmax(torch.log(x.float() + 1e-20) + gumbel,
                                 dim=-1)]}
