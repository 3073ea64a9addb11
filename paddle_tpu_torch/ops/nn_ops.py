"""NN ops (counterpart of paddle_tpu/ops/nn_ops.py: the conv plane,
conv2d :51, depthwise_conv2d :81, conv3d :89, conv2d_transpose :108,
pool2d :180 (``_pool_nd`` :139, which pool3d shares), pool2d_with_index
:213 with its aliases max_pool2d_with_index :580 and
max_pool3d_with_index :587 (``_max_pool_with_index`` :186), batch_norm
:220, group_norm :292 and instance_norm :314, with ``_pair`` :36 and
``_conv_padding`` :42; layer_norm :261, lrn :331, softmax :349,
log_softmax :356, dropout :362, lookup_table :384 with its alias
lookup_table_v2 :404, the sparse plane's sparse_embedding_lookup :427
(with ``_hash_mix_u32`` :410) and sparse_scatter_update :450, and the
resizes interpolate :462, bilinear_interp :497 and nearest_interp :502;
the vision extras affine_channel :507, im2sequence :516, grid_sampler
:540 and pad3d :571).

The resizes compute what JAX's compute.  With ``align_corners`` (the
default) a bilinear resize gathers the four corners at jnp.linspace's
coordinates (:477-492).  Otherwise JAX calls jax.image.resize, whose
``linear`` filters when it shrinks (F.interpolate's bilinear does not:
its ``antialias=True`` is the match) and whose ``nearest`` samples
floor((i + 0.5) * in / out) (F.interpolate's ``nearest-exact``, not its
``nearest``): the port builds jax.image.resize's weight matrices
(``compute_weight_mat``) and sample indices itself, on the device.

The JAX package leaves the conv plane to XLA (``conv_general_dilated``,
``reduce_window``, jnp arithmetic); here the convolutions are
``F.conv2d``, ``F.conv3d`` and ``F.conv_transpose2d`` (cuDNN on the
card) and pooling torch's, each where it computes JAX's function, and
the norms spell the JAX formulas.  Layout is NCHW / NCDHW with OIHW
filters (IOHW for the transposes), as in the JAX package; only
batch_norm reads ``data_layout``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..framework.registry import register_op, single_input
from ..kernels.layer_norm import layer_norm_train as _layer_norm_rows
from ._grad_rules import div
from .creation import jax_linspace, op_generator
from .math_ops import amp_inputs, amp_result


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _conv_padding(padding, ksize, strides, dilations, spatial):
    """Per spatial dim (lo, hi): the reference's symmetric int padding,
    or the SAME / VALID strings resolved as XLA resolves them (SAME: out
    = ceil(in / stride), the odd pad on the high side)."""
    if not isinstance(padding, str):
        return [(p, p) for p in _pair(padding, len(spatial))]
    if padding.upper() == "VALID":
        return [(0, 0)] * len(spatial)
    pads = []
    for n, k, s, d in zip(spatial, ksize, strides, dilations):
        out = -(-int(n) // s)
        total = max((out - 1) * s + (int(k) - 1) * d + 1 - int(n), 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _torch_pad(pads):
    """[(lo, hi)] per spatial dim as F.pad's list (last dim first)."""
    return [p for lo_hi in reversed(pads) for p in lo_hi]


def _conv_nd(x, w, attrs, nd, conv):
    """An N-d convolution (nd 2 or 3) with the JAX lowering's padding and
    AMP casts (JAX :57-105): SAME's odd pad an explicit F.pad first,
    both operands bf16 under FLAGS_amp_bf16 and the output kept bf16."""
    strides = _pair(attrs.get("strides", 1), nd)
    dilations = _pair(attrs.get("dilations", 1), nd)
    groups = int(attrs.get("groups", 1))
    pads = _conv_padding(attrs.get("paddings", 0), w.shape[2:], strides,
                         dilations, x.shape[2:])
    orig_dtype = x.dtype
    xc, wc = amp_inputs(x, w)
    if any(lo != hi for lo, hi in pads):
        xc = F.pad(xc, _torch_pad(pads))
        pads = [(0, 0)] * nd
    out = conv(xc, wc, None, strides, [lo for lo, _ in pads], dilations,
               groups)
    return out, orig_dtype


@register_op("conv2d")
def _conv2d(ctx, ins, attrs):
    """NCHW x OIHW -> NCHW (ref operators/conv_op.cc) through F.conv2d;
    asymmetric padding (SAME at some strides) is an explicit F.pad first.
    Under FLAGS_amp_bf16 the JAX lowering's casts: both operands bf16,
    the output stays bf16 (amp_result); cuDNN accumulates in f32.  The
    optional fused Bias is added after, in the output's dtype."""
    out, orig_dtype = _conv_nd(single_input(ins, "Input"),
                               single_input(ins, "Filter"), attrs, 2,
                               F.conv2d)
    if ins.get("Bias"):
        bias, = amp_inputs(ins["Bias"][0])
        out = out + bias.reshape(1, -1, 1, 1)
    return {"Output": [amp_result(out, orig_dtype)]}


@register_op("depthwise_conv2d")
def _depthwise_conv2d(ctx, ins, attrs):
    x = single_input(ins, "Input")
    return _conv2d(ctx, ins, dict(attrs, groups=x.shape[1]))


@register_op("conv3d")
def _conv3d(ctx, ins, attrs):
    """NCDHW x OIDHW -> NCDHW through F.conv3d (ref conv_op.cc 3-D)."""
    out, orig = _conv_nd(single_input(ins, "Input"),
                         single_input(ins, "Filter"), attrs, 3, F.conv3d)
    return {"Output": [amp_result(out, orig)]}


@register_op("conv2d_transpose")
def _conv2d_transpose(ctx, ins, attrs):
    """ref conv_transpose_op.cc, IOHW filter [C_in, C_out / groups, kh,
    kw].  JAX computes the gradient of a convolution (the stride as
    lhs_dilation, the flipped filter, the pad k_eff - 1 - p, which turns
    negative where p > k_eff - 1 and crops); F.conv_transpose2d at
    padding p and no output_padding is that function, with the filter in
    the same layout: out = (H - 1) * s - 2p + d * (k - 1) + 1.  AMP casts
    as conv2d's."""
    x = single_input(ins, "Input")
    w = single_input(ins, "Filter")
    orig_dtype = x.dtype
    xc, wc = amp_inputs(x, w)
    out = F.conv_transpose2d(xc, wc, None, _pair(attrs.get("strides", 1)),
                             _pair(attrs.get("paddings", 0)), 0,
                             int(attrs.get("groups", 1)),
                             _pair(attrs.get("dilations", 1)))
    return {"Output": [amp_result(out, orig_dtype)]}


def _pool_nd(x, attrs, nd):
    """N-d pooling (nd 2 or 3) with JAX's windows (ref pool_op.cc; JAX
    ``_pool_nd``): max | avg, global_pooling, ceil_mode (the high side
    padded by (s - rem) % s, every window kept), exclusive avg (divide by
    the in-bounds count, only where some padding is non-zero; otherwise
    by prod(ksize)).  Torch's own padding computes that function where
    the padding is symmetric and at most half the window; ceil_mode's
    extra padding or a wider one is an explicit F.pad (-inf for max, 0
    for avg) with the count taken from a padded volume of ones."""
    max_pool = F.max_pool2d if nd == 2 else F.max_pool3d
    avg_pool = F.avg_pool2d if nd == 2 else F.avg_pool3d
    ptype = attrs.get("pooling_type", "max")
    if attrs.get("global_pooling", False):
        ksize = tuple(int(s) for s in x.shape[2:])
        pads = [(0, 0)] * nd
        strides = (1,) * nd
    else:
        ksize = _pair(attrs["ksize"], nd)
        strides = _pair(attrs.get("strides", 1), nd)
        pads = [(p, p) for p in _pair(attrs.get("paddings", 0), nd)]
    if attrs.get("ceil_mode", False):
        pads = [(lo, hi + (s - (int(n) + lo + hi - k) % s) % s)
                for (lo, hi), n, k, s in zip(pads, x.shape[2:], ksize,
                                             strides)]
    padded = any(p != (0, 0) for p in pads)
    native = all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads,
                                                                 ksize))
    if ptype == "max":
        if native:
            return max_pool(x, ksize, strides, [lo for lo, _ in pads])
        return max_pool(F.pad(x, _torch_pad(pads), value=-math.inf),
                        ksize, strides)
    exclusive = bool(attrs.get("exclusive", True)) and padded
    dtype = x.dtype
    if nd == 3 and dtype == torch.bfloat16:
        # torch has no CPU avg_pool3d for bf16; its CUDA kernel sums bf16
        # in f32 and rounds once, which this is too
        x = x.float()
    if native:
        return avg_pool(x, ksize, strides, [lo for lo, _ in pads],
                        count_include_pad=not exclusive).to(dtype)
    summed = avg_pool(F.pad(x, _torch_pad(pads)), ksize, strides,
                      divisor_override=1)
    if not exclusive:
        return (summed / float(math.prod(ksize))).to(dtype)
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    counts = avg_pool(F.pad(ones, _torch_pad(pads)), ksize, strides,
                      divisor_override=1)
    return (summed / counts).to(dtype)


@register_op("pool2d")
def _pool2d(ctx, ins, attrs):
    """ref pool_op.cc: max|avg, global_pooling, exclusive avg, NCHW."""
    return {"Out": [_pool_nd(single_input(ins), attrs, 2)]}


def _max_pool_with_index(x, attrs, nd):
    """Max pooling that also returns each window's flat spatial argmax
    (ref pool_with_index_op.cc), JAX's (value, index) reduce_window
    spelt out: the windows of the input padded with -inf (index 0) are
    unfolded, and the running select of JAX's reducer, which takes an
    element only where it is strictly greater, keeps the first maximum
    in the order XLA visits the window, ignores NaN, and leaves index 0
    where nothing beats -inf.  XLA (the CPU backend, the JAX package's
    oracle) visits a window in row-major order, except that the last
    spatial dim with a window of 2 and a padding of 1 comes first
    (tests/test_torch_ops.py plants ties for each case); torch's
    ``return_indices`` order is not that contract.  Out in X's dtype
    (the gradient flows to the picked element), Mask int32 (JAX's
    index_dtype on its x32 plane)."""
    ksize = _pair(attrs["ksize"], nd)
    strides = _pair(attrs.get("strides", 1), nd)
    pads = [(p, p) for p in _pair(attrs.get("paddings", 0), nd)]
    spatial = tuple(int(n) for n in x.shape[2:])
    flat = torch.arange(math.prod(spatial), dtype=torch.int32,
                        device=x.device).reshape((1, 1) + spatial)
    win = F.pad(x, _torch_pad(pads), value=-math.inf)
    idx = F.pad(flat, _torch_pad(pads))
    for i, (k, s) in enumerate(zip(ksize, strides)):
        win = win.unfold(2 + i, k, s)
        idx = idx.unfold(2 + i, k, s)
    lead = [i for i in range(nd) if ksize[i] == 2 and pads[i][0] == 1]
    order = [i for i in range(nd) if not lead or i != lead[-1]]
    order = lead[-1:] + order
    visit = list(range(2 + nd)) + [2 + nd + i for i in order]
    win = win.permute(visit).flatten(-nd)       # [N, C, *out, K]
    idx = idx.permute(visit).flatten(-nd)       # [1, 1, *out, K]
    cand = torch.where(torch.isnan(win), -math.inf, win)
    best = cand.amax(-1, keepdim=True)
    hit = (cand == best) & (cand > -math.inf)
    first = hit.to(torch.uint8).argmax(-1, keepdim=True)
    found = hit.any(-1)
    vals = torch.where(found, win.gather(-1, first).squeeze(-1),
                       -math.inf)
    mask = torch.where(found, idx.expand(win.shape).gather(-1, first)
                       .squeeze(-1), 0)
    return {"Out": [vals.to(x.dtype)], "Mask": [mask.to(torch.int32)]}


@register_op("pool2d_with_index")
def _pool2d_with_index(ctx, ins, attrs):
    return _max_pool_with_index(single_input(ins), attrs, 2)


@register_op("max_pool2d_with_index")
def _max_pool2d_with_index(ctx, ins, attrs):
    """The reference's registered name for pool2d_with_index."""
    return _pool2d_with_index(ctx, ins, attrs)


@register_op("max_pool3d_with_index")
def _max_pool3d_with_index(ctx, ins, attrs):
    """pool2d_with_index over NCDHW windows."""
    return _max_pool_with_index(single_input(ins), attrs, 3)


@register_op("batch_norm")
def _batch_norm(ctx, ins, attrs):
    """ref batch_norm_op.cc, in the JAX lowering's formula (not
    F.batch_norm's): batch variance E[x^2] - mean^2 in f32; running
    stats momentum * running + (1 - momentum) * batch with the biased
    batch variance, detached (JAX's stop_gradient: a state output must
    not carry the step's graph into the scope); SavedVariance
    1/sqrt(var + eps); is_test and use_global_stats normalise by the
    running stats and write them back unchanged; Y in f32, cast back to
    X's dtype.  MeanOut / VarianceOut write the Mean / Variance names."""
    x = single_input(ins)
    scale = single_input(ins, "Scale")
    bias = single_input(ins, "Bias")
    mean = single_input(ins, "Mean")
    var = single_input(ins, "Variance")
    eps = float(attrs.get("epsilon", 1e-5))
    momentum = float(attrs.get("momentum", 0.9))
    c_axis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.ndim - 1
    red_axes = tuple(i for i in range(x.ndim) if i != c_axis)
    bshape = tuple(x.shape[c_axis] if i == c_axis else 1
                   for i in range(x.ndim))
    xf = x.float()
    if attrs.get("is_test", False) or attrs.get("use_global_stats", False):
        use_mean, use_var = mean, var
        saved_mean, saved_var = mean, var
        mean_out, var_out = mean, var
    else:
        bmean = torch.mean(xf, dim=red_axes)
        bvar = torch.mean(torch.square(xf), dim=red_axes) - torch.square(
            bmean)
        use_mean, use_var = bmean, bvar
        saved_mean = bmean
        saved_var = 1.0 / torch.sqrt(bvar + eps)
        mean_out = (momentum * mean + (1 - momentum) * bmean).detach().to(
            mean.dtype)
        var_out = (momentum * var + (1 - momentum) * bvar).detach().to(
            var.dtype)
    inv = torch.rsqrt(use_var.float() + eps)
    y = (xf - use_mean.reshape(bshape)) * inv.reshape(bshape)
    y = y * scale.reshape(bshape) + bias.reshape(bshape)
    return {"Y": [y.to(x.dtype)],
            "MeanOut": [mean_out], "VarianceOut": [var_out],
            "SavedMean": [saved_mean], "SavedVariance": [saved_var]}


@register_op("layer_norm")
def _layer_norm(ctx, ins, attrs):
    """ref layer_norm_op.cc: normalise over dims >= begin_norm_axis.
    A single trailing axis with affine params goes through the row kernel
    (kernels/layer_norm.py: the CUDA kernel on the card, its plain version
    on the CPU; differentiable, with the JAX fused path's analytic VJP);
    like the JAX fused path it reports Variance = 1/rstd^2 - eps."""
    x = single_input(ins)
    eps = float(attrs.get("epsilon", 1e-5))
    axis = int(attrs.get("begin_norm_axis", 1))
    if axis == x.ndim - 1 and ins.get("Scale") and ins.get("Bias"):
        D = x.shape[-1]
        y, mean, rstd = _layer_norm_rows(
            x.reshape(-1, D).contiguous(), ins["Scale"][0].reshape(D),
            ins["Bias"][0].reshape(D), eps)
        lead = x.shape[:-1]
        var = 1.0 / torch.square(rstd) - eps
        return {"Y": [y.reshape(x.shape)], "Mean": [mean.reshape(lead)],
                "Variance": [var.reshape(lead)]}
    dims = tuple(range(axis, x.ndim))
    xf = x.float()
    mean = torch.mean(xf, dim=dims, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=dims, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    norm_shape = x.shape[axis:]
    if ins.get("Scale"):
        y = y * ins["Scale"][0].reshape(norm_shape)
    if ins.get("Bias"):
        y = y + ins["Bias"][0].reshape(norm_shape)
    return {"Y": [y.to(x.dtype)],
            "Mean": [mean.reshape(x.shape[:axis])],
            "Variance": [var.reshape(x.shape[:axis])]}


@register_op("group_norm")
def _group_norm(ctx, ins, attrs):
    """ref group_norm_op.cc (NCHW and its N-d kin), JAX's formula, not
    F.group_norm's: f32 statistics over each of `groups` channel groups,
    the variance mean((x - mean)^2); Mean and Variance [N, groups]; Y
    cast back to X's dtype."""
    x = single_input(ins)
    g = int(attrs["groups"])
    eps = float(attrs.get("epsilon", 1e-5))
    n, c = x.shape[0], x.shape[1]
    rest = tuple(x.shape[2:])
    xf = x.float().reshape((n, g, c // g) + rest)
    dims = tuple(range(2, xf.ndim))
    mean = torch.mean(xf, dim=dims, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=dims, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    bshape = (1, c) + (1,) * len(rest)
    if ins.get("Scale"):
        y = y * ins["Scale"][0].reshape(bshape)
    if ins.get("Bias"):
        y = y + ins["Bias"][0].reshape(bshape)
    return {"Y": [y.to(x.dtype)],
            "Mean": [mean.reshape(n, g)], "Variance": [var.reshape(n, g)]}


@register_op("instance_norm")
def _instance_norm(ctx, ins, attrs):
    """ref instance_norm_op.cc, JAX's formula, not F.instance_norm's:
    f32 statistics over each sample's channel, the biased variance
    (jnp.var); Y cast back to X's dtype."""
    x = single_input(ins)
    eps = float(attrs.get("epsilon", 1e-5))
    dims = tuple(range(2, x.ndim))
    xf = x.float()
    mean = torch.mean(xf, dim=dims, keepdim=True)
    var = torch.var(xf, dim=dims, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    bshape = (1, x.shape[1]) + (1,) * (x.ndim - 2)
    if ins.get("Scale"):
        y = y * ins["Scale"][0].reshape(bshape)
    if ins.get("Bias"):
        y = y + ins["Bias"][0].reshape(bshape)
    return {"Y": [y.to(x.dtype)]}


@register_op("lrn")
def _lrn(ctx, ins, attrs):
    """Local response norm across channels (ref lrn_op.cc), JAX's formula
    (not F.local_response_norm's, which divides alpha by n and pads
    otherwise): the squares' sum over a window of n channels, the
    channels padded by (n // 2, n - 1 - n // 2); MidOut = k + alpha *
    sum, Out = x / MidOut ** beta.  The window adds n shifted slices in
    order in the input's dtype (bf16 under AMP, as XLA's reduce_window
    sums), and k, alpha and beta are first rounded to that dtype, as jnp
    rounds a Python scalar met by an array: bf16 results equal JAX's bit
    for bit on the CPU."""
    x = single_input(ins)
    n = int(attrs.get("n", 5))
    k, alpha, beta = (float(torch.tensor(float(attrs.get(a, d)),
                                         dtype=x.dtype))
                      for a, d in (("k", 2.0), ("alpha", 1e-4),
                                   ("beta", 0.75)))
    C = x.shape[1]
    sq = F.pad(torch.square(x), (0, 0, 0, 0, n // 2, n - 1 - n // 2))
    window = sq[:, :C]
    for i in range(1, n):
        window = window + sq[:, i:i + C]
    mid = k + alpha * window
    return {"Out": [x / torch.pow(mid, beta)], "MidOut": [mid]}


@register_op("softmax")
def _softmax(ctx, ins, attrs):
    x = single_input(ins)
    return {"Out": [torch.softmax(x, dim=int(attrs.get("axis", -1)))]}


@register_op("log_softmax")
def _log_softmax(ctx, ins, attrs):
    x = single_input(ins)
    return {"Out": [torch.log_softmax(x, dim=int(attrs.get("axis", -1)))]}


@register_op("dropout")
def _dropout(ctx, ins, attrs):
    """ref dropout_op.cc: implementations downgrade_in_infer (the
    default: scale by 1 - p at test time) and upscale_in_train (scale
    the kept entries by 1 / (1 - p) in training).  The keep draw is
    uniform < 1 - p from the op's generator on the op's device (a
    nonzero ``seed`` attr seeds its own); Philox draws other bits than
    JAX's threefry, so only the distribution is JAX's.  Mask is uint8."""
    x = single_input(ins)
    p = float(attrs.get("dropout_prob", 0.5))
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False):
        out = x * (1.0 - p) if impl == "downgrade_in_infer" else x
        return {"Out": [out], "Mask": [torch.ones_like(x, dtype=torch.uint8)]}
    u = torch.rand(x.shape, generator=op_generator(ctx, attrs),
                   device=ctx.device)
    keep = u < 1.0 - p
    if impl == "upscale_in_train":
        out = torch.where(keep, x / max(1.0 - p, 1e-8), 0.0)
    else:
        out = torch.where(keep, x, 0.0)
    return {"Out": [out.to(x.dtype)], "Mask": [keep.to(torch.uint8)]}


@register_op("lookup_table")
def _lookup_table(ctx, ins, attrs):
    """Embedding lookup (ref lookup_table_op.cc).  An ids trailing dim of
    1 is squeezed; padding_idx rows produce zeros."""
    w = single_input(ins, "W")
    ids = single_input(ins, "Ids")
    padding_idx = int(attrs.get("padding_idx", -1))
    if ids.ndim >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    ids = ids.long()
    out = F.embedding(ids, w)
    if padding_idx != -1:
        out = torch.where((ids == padding_idx)[..., None],
                          torch.zeros((), dtype=out.dtype, device=out.device),
                          out)
    return {"Out": [out]}


@register_op("lookup_table_v2")
def _lookup_table_v2(ctx, ins, attrs):
    return _lookup_table(ctx, ins, attrs)


_U32 = 0xFFFFFFFF
_HASH_MIX = 0x45D9F3B


def _hash_mix_u32(x):
    """The sparse plane's xor-shift/multiply avalanche on uint32 values
    held in int64 (torch has few uint32 ops on CUDA): the low 32 bits of
    every product are kept, as uint32 arithmetic wraps, and no product
    overflows (0x45D9F3B * 2^32 < 2^63).  Bit-identical to
    sparse/table.py's hash_bucket, so an id buckets to the same row
    whether folded on the host or in the graph."""
    x = x ^ (x >> 16)
    x = (x * _HASH_MIX) & _U32
    x = x ^ (x >> 16)
    x = (x * _HASH_MIX) & _U32
    return x ^ (x >> 16)


@register_op("sparse_embedding_lookup")
def _sparse_embedding_lookup(ctx, ins, attrs):
    """lookup_table plus ``hash_bucket``: raw ids of any magnitude fold
    into [0, rows) by the avalanche hash of their low 32 bits (what the
    JAX package's int32 feed and uint32 cast keep of an int64 id), then a
    modulo by the table's rows.  The gradient is F.embedding's: a dense
    [rows, dim] tensor, 0 on every row no id named, duplicate ids summed,
    as JAX's autodiff of jnp.take gives it."""
    w = single_input(ins, "W")
    ids = single_input(ins, "Ids")
    if ids.ndim >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    ids = ids.long()
    if bool(attrs.get("hash_bucket", False)):
        ids = _hash_mix_u32(ids & _U32) % w.shape[0]
    return {"Out": [F.embedding(ids, w)]}


@register_op("sparse_scatter_update")
def _sparse_scatter_update(ctx, ins, attrs):
    """Out = W with ``W[Ids] -= lr * Grad`` added once per occurrence:
    ``index_add``, never an indexed assignment, which would keep only one
    of a duplicate id's rows.  Ids [N] int, Grad [N, dim]; rows not named
    pass through.  On CUDA index_add sums a duplicate id's rows in no
    fixed order (atomics)."""
    w = single_input(ins, "W")
    ids = single_input(ins, "Ids").reshape(-1).long()
    grad = single_input(ins, "Grad").reshape(ids.shape[0], w.shape[1])
    lr = float(attrs.get("learning_rate", 1.0))
    return {"Out": [w.index_add(0, ids, -lr * grad.to(w.dtype))]}


def _triangle(x):
    return torch.clamp_min(1 - torch.abs(x), 0)


def _keys_cubic(x):
    """The Keys cubic kernel (a = -0.5) of jax.image.resize."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(m, n, kernel, device):
    """jax.image.resize's [m, n] weight matrix for resizing a dim of m to
    n with antialiasing (jax/_src/image/scale.py compute_weight_mat), in
    f32: each output's kernel weights over the inputs, widened by in /
    out when shrinking, normalized to sum 1, zero where the sample lies
    outside the input."""
    inv_scale = 1.0 / (n / m)
    sample = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) \
        * inv_scale - 0.5
    dist = torch.abs(sample[None, :] - torch.arange(
        m, dtype=torch.float32, device=device)[:, None])
    w = kernel(div(dist, max(inv_scale, 1.0)))
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(
        torch.finfo(torch.float32).eps), w / torch.where(
            total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _nearest_rows(m, n, device):
    """jax.image.resize's nearest samples: floor((i + 0.5) * m / n) in
    f32."""
    pos = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * m
    return torch.floor(div(pos, n)).long()


def _jax_resize(x, out_h, out_w, method):
    """jax.image.resize of NCHW x to [N, C, out_h, out_w]: dims whose
    size does not change are left alone."""
    h, w = x.shape[2], x.shape[3]
    if method == "nearest":
        if out_h != h:
            x = torch.index_select(x, 2, _nearest_rows(h, out_h, x.device))
        if out_w != w:
            x = torch.index_select(x, 3, _nearest_rows(w, out_w, x.device))
        return x
    kernel = {"linear": _triangle, "cubic": _keys_cubic}[method]
    if out_h != h:
        x = torch.einsum("nchw,hH->ncHw", x, _resize_weights(
            h, out_h, kernel, x.device).to(x.dtype))
    if out_w != w:
        x = torch.einsum("nchw,wW->nchW", x, _resize_weights(
            w, out_w, kernel, x.device).to(x.dtype))
    return x


@register_op("interpolate")
def _interpolate(ctx, ins, attrs):
    """Bilinear or nearest resize of NCHW (ref interpolate_op.cc) to
    (out_h, out_w), or by ``scale``."""
    x = single_input(ins)
    method = attrs.get("interp_method", "bilinear")
    out_h = int(attrs.get("out_h", 0))
    out_w = int(attrs.get("out_w", 0))
    scale = attrs.get("scale", 0)
    if (not out_h or not out_w) and scale:
        out_h = int(x.shape[2] * scale)
        out_w = int(x.shape[3] * scale)
    jmethod = {"bilinear": "linear", "nearest": "nearest",
               "trilinear": "linear", "bicubic": "cubic"}[method]
    if bool(attrs.get("align_corners", True)) and jmethod == "linear":
        h, w = x.shape[2], x.shape[3]
        ys = jax_linspace(0, h - 1, out_h, device=x.device)
        xs = jax_linspace(0, w - 1, out_w, device=x.device)
        y0, x0 = torch.floor(ys).long(), torch.floor(xs).long()
        y1 = torch.clamp_max(y0 + 1, h - 1)
        x1 = torch.clamp_max(x0 + 1, w - 1)
        wy = (ys - y0)[None, None, :, None]
        wx = (xs - x0)[None, None, None, :]

        def g(yy, xx):
            return torch.index_select(torch.index_select(x, 2, yy), 3, xx)

        out = ((1 - wy) * (1 - wx) * g(y0, x0) + (1 - wy) * wx * g(y0, x1)
               + wy * (1 - wx) * g(y1, x0) + wy * wx * g(y1, x1))
        return {"Out": [out.to(x.dtype)]}
    return {"Out": [_jax_resize(x, out_h, out_w, jmethod).to(x.dtype)]}


@register_op("bilinear_interp")
def _bilinear_interp(ctx, ins, attrs):
    return _interpolate(ctx, ins, dict(attrs, interp_method="bilinear"))


@register_op("nearest_interp")
def _nearest_interp(ctx, ins, attrs):
    return _interpolate(ctx, ins, dict(attrs, interp_method="nearest"))


@register_op("affine_channel")
def _affine_channel(ctx, ins, attrs):
    """X * Scale + Bias per channel of axis 1 (JAX's lowering reads no
    ``data_layout``)."""
    x = single_input(ins)
    shape = (1, x.shape[1]) + (1,) * (x.ndim - 2)
    return {"Out": [x * ins["Scale"][0].reshape(shape)
                    + ins["Bias"][0].reshape(shape)]}


@register_op("im2sequence")
def _im2sequence(ctx, ins, attrs):
    """Sliding-window patches as rows (ref im2sequence_op.cc): X [N, C,
    H, W] padded by ``paddings`` (top, left, bottom, right), each
    window's C * kh * kw values C-major, then kh, then kw (the order of
    conv_general_dilated_patches), as rows [N * oh * ow, C * kh * kw], or
    [N, oh * ow, C * kh * kw] under ``per_example``.  Strided slices
    stacked, so the values are copies, as the patches' one-hot
    convolution gives them."""
    x = single_input(ins)
    kh, kw = _pair(attrs["kernels"])
    sh, sw = _pair(attrs.get("strides", 1))
    p = attrs.get("paddings", [0, 0, 0, 0])
    x = F.pad(x, (p[1], p[3], p[0], p[2]))
    n, c, h, w = x.shape
    oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
    cols = torch.stack([x[:, :, i:i + sh * (oh - 1) + 1:sh,
                          j:j + sw * (ow - 1) + 1:sw]
                        for i in range(kh) for j in range(kw)], dim=2)
    out = cols.reshape(n, c * kh * kw, oh * ow).transpose(1, 2)
    if attrs.get("per_example"):
        return {"Out": [out.reshape(n, oh * ow, c * kh * kw)]}
    return {"Out": [out.reshape(n * oh * ow, c * kh * kw)]}


@register_op("grid_sampler")
def _grid_sampler(ctx, ins, attrs):
    """Bilinear sampling of X [N, C, H, W] at Grid [N, Ho, Wo, 2] (x, y in
    [-1, 1], the corners at -1 and 1; ref grid_sampler_op.cc) in JAX's
    formula, not F.grid_sample's: the four corners of floor(g), each a
    clipped gather zeroed where the corner lies outside, weighted and
    summed in JAX's order, so the gradient with respect to Grid follows
    JAX's float order too."""
    x = single_input(ins)
    grid = single_input(ins, "Grid")
    n, _, h, w = x.shape
    gx = (grid[..., 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[..., 1] + 1.0) * (h - 1) / 2.0
    x0, y0 = torch.floor(gx), torch.floor(gy)
    x1, y1 = x0 + 1, y0 + 1
    wx1, wy1 = gx - x0, gy - y0
    wx0, wy0 = 1 - wx1, 1 - wy1
    batch = torch.arange(n, device=x.device)[:, None, None]

    def sample(yy, xx):
        yi = torch.clamp(yy, 0, h - 1).long()
        xi = torch.clamp(xx, 0, w - 1).long()
        valid = ((yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1))
        v = torch.movedim(x[batch, :, yi, xi], -1, 1)     # [N, C, Ho, Wo]
        return v * valid[:, None].to(x.dtype)

    out = (sample(y0, x0) * (wy0 * wx0)[:, None]
           + sample(y0, x1) * (wy0 * wx1)[:, None]
           + sample(y1, x0) * (wy1 * wx0)[:, None]
           + sample(y1, x1) * (wy1 * wx1)[:, None])
    return {"Output": [out.to(x.dtype)]}


@register_op("pad3d")
def _pad3d(ctx, ins, attrs):
    """NCDHW constant padding by ``paddings`` [left, right, top, bottom,
    front, back] with ``value`` (JAX's lowering pads constant whatever
    the mode)."""
    x = single_input(ins)
    return {"Out": [F.pad(x, tuple(int(v) for v in attrs["paddings"]),
                          value=float(attrs.get("value", 0.0)))]}
