"""Fake quantization for QAT, and real int8 / fp8 execution.

Counterpart of paddle_tpu/ops/quantize_ops.py.  The first half is the fake
ops (:37-100): quantize-dequantize in one op with a straight-through
rounding, so training stays in floating point.  Their float order is
JAX's, so the int8 codes are its codes bit for bit, and so are their
gradients: the clip is ``min(max(x, -qmax), qmax)`` with lax.min and
lax.max's gradient at a tie (half to each side, ``_grad_rules.clip``),
which the abs-max element always meets (``x / s * qmax == qmax``), and
the scale ``max(|x|)`` is not detached, so that element also receives
``sum(g * (q / qmax - x / s))``.  A division by a constant is a true
division on every device (``_grad_rules.div``), so the card's values
are the CPU's.

The second half runs the products on int8 and fp8 operands (:104-288):

  * ``low_precision_matmul``: FLAGS_quantize_dtype's path under every
    mul/matmul/bmm (math_ops.amp_matmul), a dynamic per-tensor scale for x
    and per-column scales for y, a low-precision product and a
    straight-through backward through the AMP-policy product;
  * the ``quantized_matmul`` / ``quantized_conv2d`` ops that
    QuantizeTranspiler.freeze_program emits: weights already int8 or fp8
    with f32 scales beside them, the activation quantized against the
    trained ``InScale`` or its dynamic abs-max, the scales applied after
    accumulation.

The products (``lp_product``, ``lp_conv2d``) are library calls, the
low-precision counterparts of the torch.matmul the port uses where XLA
computes a plain product; no TPU kernel lies on this path.  On the card:
int8 x int8 -> int32 through ``torch._int_mm`` (2-D only; M above 16, K
and N multiples of 8: zero padding is exact), e4m3 through
``torch._scaled_mm`` with unit scales and ``use_fast_accum=False`` (f32
accumulation; the fast path accumulates in reduced precision), dims
padded to multiples of 16, the second operand column-major; e5m2, whose
e5m2 x e5m2 product cuBLASLt refuses, as a bf16 product with f32
accumulation (every e5m2 value is exact in bf16, so it is the same
function).  A product whose operands are both batched (the unfused
attention's q.k^T under the flag) is a loop of 2-D products, one launch a
batch entry.  ``quantized_conv2d`` on the card is an im2col of the
quantized activation (strided views copied into a [N*Ho*Wo, C*kh*kw]
matrix, zero-padded to the product's granule: ResNet-50's stem K 147 ->
152) and one product a group.  Nothing here slides onto a float product
of the unquantized operands: a product the library refuses raises.  Each
2-D product on the card adds one to ``lp_product.launches[route]``.

On the CPU (and on meta tensors) the products are the plain versions: an
f64 product of the int8 values cast to int32, exact while K < 2^53 /
127^2 (and independent of the im2col: F.conv2d in f64), and an f32
product of the fp8 values (each product exact, the sums in f32, as XLA's
f32 accumulation).  ``lp_product_plain`` and ``lp_conv2d_plain`` run on
any device, so the card's accumulators can be held to them there.
"""
from __future__ import annotations

import collections
import math

import torch
import torch.nn.functional as F

from ..core import flags
from ..core.enforce import EnforceNotMet
from ..framework.registry import register_op, single_input
from ._grad_rules import clip, div


def _ste_round(x):
    """round (half to even) with a straight-through gradient, spelled as
    JAX's ``x + stop_gradient(round(x) - x)``: in floating point this is
    not always round(x)."""
    return x + (torch.round(x) - x).detach()


def _promoted(x, scale):
    """x in the dtype jnp's promotion gives ``x / scale`` (a bf16 x over an
    f32 0-d scale is f32 in JAX; torch would keep bf16)."""
    return x.to(torch.promote_types(x.dtype, scale.dtype))


def _qmax(attrs):
    return float(2 ** (int(attrs.get("bit_length", 8)) - 1) - 1)


@register_op("fake_quantize_abs_max")
def _fake_quantize_abs_max(ctx, ins, attrs):
    x = single_input(ins)
    qmax = _qmax(attrs)
    scale = clip(torch.abs(x).max().float(), 1e-8)
    q = _ste_round(clip(_promoted(x, scale) / scale * qmax, -qmax, qmax))
    return {"Out": [div(q * scale, qmax).to(x.dtype)], "OutScale": [scale]}


@register_op("fake_quantize_moving_average_abs_max")
def _fake_quantize_ma(ctx, ins, attrs):
    """The scale is ``rate * InScale + (1 - rate) * max|x|`` (InScale alone
    under is_test); OutScale writes the persistable InScale back, so it
    leaves detached (the executor stores no autograd state)."""
    x = single_input(ins)
    in_scale = ins["InScale"][0]
    rate = float(attrs.get("moving_rate", 0.9))
    qmax = _qmax(attrs)
    if bool(attrs.get("is_test", False)):
        scale = in_scale
    else:
        cur = torch.abs(x).max().float()
        scale = rate * in_scale + (1 - rate) * cur
    scale = clip(scale, 1e-8)
    q = _ste_round(clip(_promoted(x, scale) / scale * qmax, -qmax, qmax))
    return {"Out": [div(q * scale, qmax).to(x.dtype)],
            "OutScale": [scale.detach()]}


@register_op("fake_channel_wise_quantize_abs_max")
def _fake_cw_quant(ctx, ins, attrs):
    """Per-channel weight quantization along quant_axis: 0 for conv2d
    (OIHW output channels), 1 for mul/matmul ([in, out]) and
    conv2d_transpose (IOHW)."""
    x = single_input(ins)
    axis = int(attrs.get("quant_axis", 0))
    qmax = _qmax(attrs)
    axes = tuple(a for a in range(x.ndim) if a != axis)
    scale = clip(torch.amax(torch.abs(x), dim=axes).float(), 1e-8)
    shape = [1] * x.ndim
    shape[axis] = -1
    s = scale.reshape(shape)
    q = _ste_round(clip(_promoted(x, s) / s * qmax, -qmax, qmax))
    return {"Out": [div(q * s, qmax).to(x.dtype)], "OutScale": [scale]}


@register_op("fake_dequantize_max_abs")
def _fake_dequantize(ctx, ins, attrs):
    x = single_input(ins)
    scale = ins["Scale"][0]
    max_range = float(attrs.get("max_range", 127.0))
    return {"Out": [div(_promoted(x, scale) * scale,
                         max_range).to(x.dtype)]}


# ---------------------------------------------------------------------------
# Real low-precision execution.
# ---------------------------------------------------------------------------

# storage dtype and representable max per quantize_dtype spelling
_QSPECS = {
    "int8": (torch.int8, 127.0),
    "e4m3": (torch.float8_e4m3fn, 448.0),
    "e5m2": (torch.float8_e5m2, 57344.0),
}


def qspec(quantize_dtype: str):
    """(storage torch dtype, qmax) for a quantize_dtype spelling; raises
    with the valid vocabulary on an unknown one."""
    if quantize_dtype not in _QSPECS:
        raise EnforceNotMet(
            f"unknown quantize_dtype {quantize_dtype!r}: expected one of "
            f"{sorted(_QSPECS)} (or '' = disabled)")
    return _QSPECS[quantize_dtype]


def quantize_array(x, scale, quantize_dtype: str):
    """x / scale mapped onto the storage grid: int8 rounds (half to even)
    and clips, fp8 clips and casts (round to nearest even).  `scale` is
    the absmax the grid's qmax lands on, broadcastable against x.  Both
    grids clip: a frozen scale below the live absmax would otherwise
    overflow fp8."""
    dt, qmax = qspec(quantize_dtype)
    s = torch.clamp(scale.float(), min=1e-8)
    y = torch.clamp(x.float() / s * qmax, -qmax, qmax)
    if quantize_dtype == "int8":
        return torch.round(y).to(dt)
    return y.to(dt)


def channel_scales(w, axis: int):
    """Per-channel absmax scales along `axis` (f32, on w's device): what
    freeze_program stores beside a quantized weight."""
    axes = tuple(a for a in range(w.ndim) if a != axis)
    return torch.clamp(torch.amax(torch.abs(w), dim=axes).float(), min=1e-8)


def _dequant_spec(scale, quantize_dtype):
    _, qmax = qspec(quantize_dtype)
    return div(torch.clamp(scale.float(), min=1e-8), qmax)


def _acc_dtype(quantize_dtype):
    return torch.int32 if quantize_dtype == "int8" else torch.float32


def _round_up(n, m):
    return -(-n // m) * m


def _pad2(t, rows, cols):
    """A 2-D int8 or fp8 tensor zero-padded to [rows, cols], contiguous.
    fp8 moves as its bytes (0x00 is +0.0 in both fp8 types)."""
    r, c = t.shape
    if (r, c) == (rows, cols) and t.is_contiguous():
        return t
    raw = t.view(torch.uint8) if t.is_floating_point() else t
    out = raw.new_zeros(rows, cols)
    out[:r, :c] = raw
    return out.view(t.dtype)


def _mm2d(a, bt, qd):
    """a [M, K] @ bt [N, K']^T on the card, K' <= K (the missing columns
    are zeros): int32 accumulators for int8, f32 for fp8.  Pads to the
    library's granules and slices back."""
    M, K = a.shape
    N = bt.shape[0]
    if qd == "int8":
        Mp, Kp, Np = (_round_up(max(M, 17), 8), _round_up(K, 8),
                      _round_up(N, 8))
        out = torch._int_mm(_pad2(a, Mp, Kp), _pad2(bt, Np, Kp).t())
        route = "int_mm"
    elif qd == "e4m3":
        Mp, Kp, Np = (_round_up(M, 16), _round_up(K, 16), _round_up(N, 16))
        one = torch.ones((), dtype=torch.float32, device=a.device)
        out = torch._scaled_mm(_pad2(a, Mp, Kp), _pad2(bt, Np, Kp).t(),
                               scale_a=one, scale_b=one,
                               out_dtype=torch.float32,
                               use_fast_accum=False)
        route = "scaled_mm"
    else:       # e5m2: exact in bf16, f32 accumulation
        Mp, Np = M, N
        if bt.shape[1] != K:
            bt = _pad2(bt, N, K)
        out = torch.mm(a.to(torch.bfloat16), bt.to(torch.bfloat16).t(),
                       out_dtype=torch.float32)
        route = "bf16_mm"
    lp_product.launches[route] += 1
    return out[:M, :N] if (Mp, Np) != (M, N) else out


def lp_product_plain(xq, yq, quantize_dtype: str):
    """xq [..., M, K] @ yq [..., K, N] in a wider float on any device:
    int8 in f64 cast to int32 (exact while K < 2^53 / 127^2), fp8 in
    f32."""
    wide = torch.float64 if quantize_dtype == "int8" else torch.float32
    return torch.matmul(xq.to(wide), yq.to(wide)).to(
        _acc_dtype(quantize_dtype))


def lp_product(xq, yq, quantize_dtype: str):
    """The accumulators of xq [..., M, K] @ yq [..., K, N] (batch dims
    broadcast): the library's low-precision product on the card, the plain
    version elsewhere."""
    if xq.device.type != "cuda":
        return lp_product_plain(xq, yq, quantize_dtype)
    return _product_lowered(xq, yq, quantize_dtype)


def _product_lowered(xq, yq, quantize_dtype):
    """lp_product's card lowering: 2-D products through _mm2d, a loop of
    them where both operands are batched."""
    K, N = yq.shape[-2:]
    if yq.ndim == 2:
        lead = xq.shape[:-1]
        return _mm2d(xq.reshape(-1, K), yq.t(), quantize_dtype).reshape(
            *lead, N)
    M = xq.shape[-2]
    batch = torch.broadcast_shapes(xq.shape[:-2], yq.shape[:-2])
    xs = xq.expand(*batch, M, K).reshape(-1, M, K)
    ys = yq.expand(*batch, K, N).reshape(-1, K, N)
    # both operands batched: one 2-D product a batch entry
    acc = torch.stack([_mm2d(a, b.t(), quantize_dtype)
                       for a, b in zip(xs, ys)])
    return acc.reshape(*batch, M, N)


lp_product.launches = collections.Counter()


def lp_conv2d_plain(xq, wq, quantize_dtype, strides, pads, dils, groups):
    """NCHW x OIHW accumulators through F.conv2d in a wider float on any
    device: int8 in f64 cast to int32 (exact), fp8 in f32."""
    wide = torch.float64 if quantize_dtype == "int8" else torch.float32
    return F.conv2d(xq.to(wide), wq.to(wide), None, strides, pads, dils,
                    groups).to(_acc_dtype(quantize_dtype))


def _im2col(xg, kh, kw, strides, dils, Ho, Wo, granule):
    """[N, Cg, Hp, Wp] (already padded) -> [N*Ho*Wo, Cg*kh*kw] as one copy
    of a strided view, zero-padded to the product's granule in both
    dims."""
    N, Cg = xg.shape[:2]
    sN, sC, sH, sW = xg.stride()
    win = xg.as_strided((N, Ho, Wo, Cg, kh, kw),
                        (sN, strides[0] * sH, strides[1] * sW, sC,
                         dils[0] * sH, dils[1] * sW), xg.storage_offset())
    M, K = N * Ho * Wo, Cg * kh * kw
    Mp, Kp = _round_up(max(M, 17), granule), _round_up(K, granule)
    cols = (xg.new_zeros if (Mp, Kp) != (M, K) else xg.new_empty)(Mp, Kp)
    cols[:M, :K].view(N, Ho, Wo, Cg, kh, kw).copy_(win)
    return cols


def lp_conv2d(xq, wq, quantize_dtype, strides, pads, dils, groups):
    """The accumulators of an NCHW x OIHW convolution of quantized
    operands (symmetric pads): an im2col and a product a group on the
    card, the plain version elsewhere."""
    if xq.device.type != "cuda":
        return lp_conv2d_plain(xq, wq, quantize_dtype, strides, pads, dils,
                               groups)
    return _conv_lowered(xq, wq, quantize_dtype, strides, pads, dils, groups)


def _conv_lowered(xq, wq, quantize_dtype, strides, pads, dils, groups):
    """lp_conv2d's card lowering: the padded activation's im2col and one
    _mm2d a group, the accumulators as an NCHW view of NHWC rows."""
    N, C, H, W = xq.shape
    O, Cg, kh, kw = wq.shape
    Ho = (H + 2 * pads[0] - dils[0] * (kh - 1) - 1) // strides[0] + 1
    Wo = (W + 2 * pads[1] - dils[1] * (kw - 1) - 1) // strides[1] + 1
    raw = xq.view(torch.uint8) if xq.is_floating_point() else xq
    if pads[0] or pads[1]:
        raw = F.pad(raw, (pads[1], pads[1], pads[0], pads[0]))
    granule = 8 if quantize_dtype == "int8" else 16
    Og = O // groups
    outs = []
    for g in range(groups):
        cols = _im2col(raw[:, g * Cg:(g + 1) * Cg], kh, kw, strides, dils,
                       Ho, Wo, granule).view(xq.dtype)
        wg = wq[g * Og:(g + 1) * Og].reshape(Og, Cg * kh * kw)
        outs.append(_mm2d(cols, wg, quantize_dtype)[:N * Ho * Wo])
    acc = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    return acc.reshape(N, Ho, Wo, O).permute(0, 3, 1, 2)


def _out_dtype(orig_dtype):
    """The AMP output policy: bf16 for an f32 origin under the flag."""
    if flags.get_flag("amp_bf16") and orig_dtype == torch.float32:
        return torch.bfloat16
    return orig_dtype


def _lp_forward(x, y, qd, out_dtype):
    if y.ndim < 2:
        raise EnforceNotMet(f"low_precision_matmul: y must be at least "
                            f"2-D, got {tuple(y.shape)}")
    sx = torch.abs(x).max().float()
    # per-column over y's last axis; every other axis reduced, so batched
    # products get one scale row
    sy = torch.amax(torch.abs(y), dim=tuple(range(y.ndim - 1))).float()
    xq = quantize_array(x, sx, qd)
    yq = quantize_array(y, sy.reshape((1,) * (y.ndim - 1) + (-1,)), qd)
    acc = lp_product(xq, yq, qd)
    out = (acc.float() * _dequant_spec(sx, qd) * _dequant_spec(sy, qd))
    return out.to(out_dtype)


def _surrogate_grads(x, y, g, out_dtype, need):
    """The vjp of the AMP-policy product ``matmul(*amp_inputs(x, y))``
    cast to out_dtype (JAX's ``surrogate``, :184): bf16 operands under
    FLAGS_amp_bf16 with f32 accumulation, the gradients cast back to the
    operands' dtypes."""
    from .math_ops import amp_inputs
    xa, ya = amp_inputs(x, y)
    gm = g.to(out_dtype).to(xa.dtype)
    gx = gy = None
    if need[0]:
        gx = torch.matmul(gm, ya.transpose(-1, -2)).sum_to_size(
            x.shape).to(x.dtype)
    if need[1]:
        if ya.ndim == 2:
            K, N = ya.shape
            gy = torch.matmul(xa.reshape(-1, K).t(), gm.reshape(-1, N))
        else:
            gy = torch.matmul(xa.transpose(-1, -2), gm).sum_to_size(
                y.shape)
        gy = gy.to(y.dtype)
    return gx, gy


class _LowPrecisionMatmul(torch.autograd.Function):
    """JAX's custom_vjp (:160-216): a low-precision forward, the
    straight-through backward of the AMP-policy product."""

    @staticmethod
    def forward(ctx, x, y, qd, out_dtype):
        ctx.save_for_backward(x, y)
        ctx.out_dtype = out_dtype
        return _lp_forward(x, y, qd, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        gx, gy = _surrogate_grads(x, y, g, ctx.out_dtype,
                                  ctx.needs_input_grad[:2])
        return gx, gy, None, None


def low_precision_matmul(x, y, quantize_dtype: str, orig_dtype):
    """The quantize_dtype-flag path of math_ops.amp_matmul: a real int8 or
    fp8 forward with dynamic scales, a straight-through backward.  The
    output dtype follows the AMP policy (bf16 for an f32 origin under
    FLAGS_amp_bf16, else the origin's)."""
    qspec(quantize_dtype)
    return _LowPrecisionMatmul.apply(x, y, quantize_dtype,
                                     _out_dtype(orig_dtype))


def _act_scale(ins, x):
    """The activation's scale: the trained InScale when the op has one,
    else x's abs-max (on the device: no host read)."""
    if ins.get("InScale"):
        return ins["InScale"][0].float().reshape(())
    return torch.abs(x).max().float()


@register_op("quantized_matmul")
def _quantized_matmul(ctx, ins, attrs):
    """Frozen-program matmul on quantized weights (what freeze_program
    emits in place of fc's mul).  X [..., K] float activation; W [K, N]
    int8 or fp8; WScale [N] f32 per-column absmax of the original weight;
    InScale [] f32, the trained activation scale (absent: dynamic abs-max).
    attrs: quantize_dtype, x_num_col_dims.  out = acc * (sx / qmax) *
    (sw / qmax), in the AMP output policy's dtype."""
    x = single_input(ins, "X")
    w = ins["W"][0]
    w_scale = ins["WScale"][0]
    qd = str(attrs.get("quantize_dtype", "int8"))
    xn = int(attrs.get("x_num_col_dims", 1))
    lead = math.prod(x.shape[:xn]) if xn else 1
    x2 = x.reshape(lead, -1)
    sx = _act_scale(ins, x2)
    acc = lp_product(quantize_array(x2, sx, qd), w, qd)
    out = (acc.float() * _dequant_spec(sx, qd)
           * _dequant_spec(w_scale, qd))
    out_shape = tuple(x.shape[:xn]) + (w.shape[1],)
    return {"Out": [out.reshape(out_shape).to(_out_dtype(x.dtype))]}


@register_op("quantized_conv2d")
def _quantized_conv2d(ctx, ins, attrs):
    """Frozen conv2d (NCHW x OIHW): Filter quantized per output channel at
    freeze time, the activation per tensor here, the scales applied after
    accumulation over the output-channel dim.  attrs: quantize_dtype,
    strides, paddings (symmetric), dilations, groups."""
    x = ins["Input"][0]
    w = ins["Filter"][0]
    f_scale = ins["FilterScale"][0]
    qd = str(attrs.get("quantize_dtype", "int8"))
    strides = tuple(int(s) for s in attrs.get("strides", (1, 1)))
    pads = tuple(int(p) for p in attrs.get("paddings", (0, 0)))
    dils = tuple(int(d) for d in attrs.get("dilations", (1, 1)))
    groups = int(attrs.get("groups", 1))
    sx = _act_scale(ins, x)
    acc = lp_conv2d(quantize_array(x, sx, qd), w, qd, strides, pads, dils,
                    groups)
    out = (acc.float() * _dequant_spec(sx, qd)
           * _dequant_spec(f_scale, qd).reshape(1, -1, 1, 1))
    return {"Output": [out.to(_out_dtype(x.dtype)).contiguous()]}
