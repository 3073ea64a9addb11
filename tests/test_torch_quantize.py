"""The quantize plane through both packages: the fake-quant ops, the
quantize_dtype flag's low-precision matmul, the frozen programs'
quantized_matmul / quantized_conv2d, QuantizeTranspiler and
fused_multihead_attention (ops/quantize_ops.py, fused_ops.py,
math_ops.py, transpiler/quantize_transpiler.py, layers/nn.py).

The same numpy inputs go through JAX's lowering (eager, as its tests call
it) and the port's.  Tolerances:

- int8 codes, int8 accumulators and every int8 op output: bit-equal (the
  port keeps JAX's float order; a division by a constant is a true
  division in both);
- fp8 codes: bit-equal; fp8 outputs: FP8_RTOL of max |JAX| (the same
  exact fp8 products summed in f32 in another order);
- the fake ops' gradients: bit-equal except at the abs-max elements,
  whose gradient is a sum over every element through the un-detached
  scale (FAKE_GRAD_RTOL of max |JAX|, another summation order); the
  clip-bound tie (0.5) is checked on its own;
- low_precision_matmul's STE backward: GRAD_RTOL of max |JAX| in f32,
  AMP_RTOL (one bf16 step at the largest entry) under FLAGS_amp_bf16;
- whole programs: a frozen program against JAX's executor in its eager
  per-op mode, int8 bit-equal and fp8 at FP8_RTOL (jitted, XLA turns a
  division by a constant into a multiplication by its reciprocal: an ulp
  that can flip a code of the next layer); a QAT or int8 training step
  (jitted in JAX) at the STEP tolerances, each step from JAX's state.
"""
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.core import flags as jflags
from paddle_tpu.framework.registry import LowerContext as JaxCtx
from paddle_tpu.framework.registry import get_op_def as jax_op
from paddle_tpu.ops import quantize_ops as jq
from paddle_tpu.transpiler import QuantizeTranspiler as JQT
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.framework.registry import LowerContext as TorchCtx
from paddle_tpu_torch.framework.registry import get_op_def as torch_op
from paddle_tpu_torch.ops import quantize_ops as tq
from paddle_tpu_torch.transpiler import QuantizeTranspiler as TQT
from test_torch_train import _op_view, _var_view

FP8_RTOL = 1e-6
FAKE_GRAD_RTOL = 1e-6
GRAD_RTOL = 1e-6
AMP_RTOL = 2.0 ** -7
STEP_LOSS_RTOL = 1e-5
STEP_STATE_RTOL = 1e-4     # of max |JAX| on each step's change of a param
QMAX = {"int8": 127.0, "e4m3": 448.0, "e5m2": 57344.0}
QDS = tuple(QMAX)


@pytest.fixture(autouse=True)
def fresh_programs():
    ptt.reset_default_programs()
    pt.reset_default_programs()
    yield
    ptt.reset_default_programs()
    for f in (jflags, ptt.flags):
        f.set_flag("amp_bf16", False)
        f.set_flag("quantize_dtype", "")


def _jlower(op, ins, attrs):
    return jax_op(op).lower(JaxCtx(jax.random.PRNGKey(0)),
                            {k: [jnp.asarray(a) for a in v]
                             for k, v in ins.items()}, attrs)


def _tlower(op, ins, attrs):
    return torch_op(op).lower(TorchCtx(0, torch.device("cpu")),
                              {k: [torch.from_numpy(np.array(a)) for a in v]
                               for k, v in ins.items()}, attrs)


def _bits(a):
    """Host bytes of a JAX array or torch tensor (fp8 as uint8)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.view(torch.uint8) if a.dtype in (
            torch.float8_e4m3fn, torch.float8_e5m2) else a).numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name.startswith("float8") else a


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


# --- the fake ops ---------------------------------------------------------

def _x(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


# name -> (op, inputs(rng), attrs, elements whose gradient runs through
# the scale: a mask of X or None for "every |x| at its reduction's max")
FAKE_CASES = {
    "abs_max_8": ("fake_quantize_abs_max", lambda r: {"X": [_x(r, 6, 7)]},
                  {"bit_length": 8}),
    "abs_max_4": ("fake_quantize_abs_max", lambda r: {"X": [_x(r, 5, 9)]},
                  {"bit_length": 4}),
    "abs_max_tied_max": ("fake_quantize_abs_max", lambda r: {
        "X": [np.array([[2.0, -2.0, 0.3], [1.1, -0.7, 2.0]], np.float32)]},
        {"bit_length": 8}),
    "channel_wise_conv_axis0": ("fake_channel_wise_quantize_abs_max",
                                lambda r: {"X": [_x(r, 4, 3, 3, 3)]},
                                {"quant_axis": 0}),
    "channel_wise_fc_axis1": ("fake_channel_wise_quantize_abs_max",
                              lambda r: {"X": [_x(r, 16, 8)]},
                              {"quant_axis": 1, "bit_length": 8}),
    "moving_average_train": ("fake_quantize_moving_average_abs_max",
                             lambda r: {"X": [_x(r, 4, 10)],
                                        "InScale": [np.float32(0.8)]},
                             {"moving_rate": 0.9, "is_test": False}),
    "moving_average_is_test": ("fake_quantize_moving_average_abs_max",
                               lambda r: {"X": [_x(r, 4, 10)],
                                          "InScale": [np.float32(1.3)]},
                               {"moving_rate": 0.9, "is_test": True}),
    "range_abs_max_window": ("fake_quantize_range_abs_max", lambda r: {
        "X": [np.array([[0.5, -0.25]], np.float32)],
        "Iter": [np.array([3], np.int64)],
        "InScales": [np.array([4.0, 2.0, 1.0], np.float32)]},
        {"bit_length": 8, "window_size": 3}),
    "range_abs_max_short_buffer": ("fake_quantize_range_abs_max",
                                   lambda r: {
                                       "X": [_x(r, 3, 5) * 3],
                                       "Iter": [np.array([1], np.int64)],
                                       "InScales": [np.array(
                                           [0.5, 9.0, 0.0], np.float32)]},
                                   {"window_size": 10}),
    "range_abs_max_stateless": ("fake_quantize_range_abs_max",
                                lambda r: {"X": [_x(r, 3, 5)],
                                           "InScale": [np.array(
                                               [1.5], np.float32)]}, {}),
    "range_abs_max_running": ("fake_quantize_range_abs_max",
                              lambda r: {"X": [_x(r, 3, 5)]}, {}),
    "dequantize": ("fake_dequantize_max_abs", lambda r: {
        "X": [np.round(_x(r, 4, 6) * 40)],
        "Scale": [np.float32(2.5)]}, {"max_range": 127.0}),
}


@pytest.mark.parametrize("name", sorted(FAKE_CASES))
def test_fake_op_values_and_ste_grads_match_jax(name):
    op, build, attrs = FAKE_CASES[name]
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    ins = build(rng)
    jo = _jlower(op, ins, attrs)
    to = _tlower(op, ins, attrs)
    assert set(jo) == set(to)
    for slot in jo:
        a, b = jo[slot][0], to[slot][0]
        assert tuple(b.shape) == tuple(np.shape(a)), slot
        np.testing.assert_array_equal(_bits(b), _bits(a), err_msg=slot)
    x = ins["X"][0]
    g = rng.randn(*x.shape).astype(np.float32)

    def jf(xv):
        return jax_op(op).lower(
            JaxCtx(jax.random.PRNGKey(0)),
            dict({k: [jnp.asarray(a) for a in v] for k, v in ins.items()},
                 X=[xv]), attrs)["Out"][0]

    _, vjp = jax.vjp(jf, jnp.asarray(x))
    gj = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x.copy()).requires_grad_()
    tins = {k: [torch.from_numpy(np.array(a)) for a in v]
            for k, v in ins.items()}
    tins["X"] = [xt]
    out = torch_op(op).lower(TorchCtx(0, torch.device("cpu")), tins,
                             attrs)["Out"][0]
    gt, = torch.autograd.grad(out, xt, torch.from_numpy(g))
    gt = gt.numpy()
    # the elements at their reduction's abs-max take the scale's gradient
    ax = x if op != "fake_channel_wise_quantize_abs_max" else None
    if ax is not None:
        at_max = np.abs(x) == np.abs(x).max()
    else:
        axis = attrs["quant_axis"]
        red = tuple(a for a in range(x.ndim) if a != axis)
        at_max = np.abs(x) == np.abs(x).max(axis=red, keepdims=True)
    np.testing.assert_array_equal(gt[~at_max], gj[~at_max])
    np.testing.assert_allclose(gt, gj, rtol=0,
                               atol=FAKE_GRAD_RTOL * np.abs(gj).max())


def test_clip_bound_tie_takes_half_the_gradient_as_in_jax():
    """An element at the clip's bound (x / s * 127 == 127): JAX's
    min(max(x, -q), q) gives it half the cotangent, a torch.clamp all of
    it.  Under abs_max the bound element is the scale itself and the tie's
    factor multiplies a zero (d(x / max|x|) / dx there is 0), so the
    frozen scale of is_test shows it: x == +-InScale."""
    x = np.array([[0.8, -0.8, 0.5, 1.7]], np.float32)
    attrs = {"moving_rate": 0.9, "is_test": True}
    op = "fake_quantize_moving_average_abs_max"
    _, vjp = jax.vjp(lambda v: jax_op(op).lower(
        JaxCtx(jax.random.PRNGKey(0)),
        {"X": [v], "InScale": [jnp.asarray(np.float32(0.8))]},
        attrs)["Out"][0], jnp.asarray(x))
    gj = np.asarray(vjp(jnp.ones((1, 4), jnp.float32))[0])
    np.testing.assert_array_equal(gj, [[0.5, 0.5, 1.0, 0.0]])
    xt = torch.from_numpy(x.copy()).requires_grad_()
    out = torch_op(op).lower(
        TorchCtx(0, torch.device("cpu")),
        {"X": [xt], "InScale": [torch.tensor(np.float32(0.8))]},
        attrs)["Out"][0]
    gt, = torch.autograd.grad(out, xt, torch.ones(1, 4))
    np.testing.assert_array_equal(gt.numpy(), gj)
    # the same formula with torch.clamp takes the bound as inside
    q = torch.clamp(xt / 0.8 * 127, -127, 127)
    q = q + (torch.round(q) - q).detach()
    gc, = torch.autograd.grad(q * 0.8 / 127, xt, torch.ones(1, 4))
    assert gc[0, 0] == 1.0 and gt[0, 0] == 0.5


def test_range_abs_max_window_state_and_length_rule():
    """JAX's windowed case (tests/test_inference_transpilers.py): slot 3 %
    3 overwritten, the window max 2.0; and a buffer shorter than
    window_size is the window (the update lands in it)."""
    out = _tlower("fake_quantize_range_abs_max",
                  FAKE_CASES["range_abs_max_window"][1](None),
                  {"bit_length": 8, "window_size": 3})
    np.testing.assert_array_equal(out["OutScales"][0].numpy(),
                                  [0.5, 2.0, 1.0])
    assert out["OutScale"][0].item() == 2.0
    assert out["OutIter"][0].tolist() == [4]
    short = _tlower("fake_quantize_range_abs_max",
                    {"X": [np.array([[7.0]], np.float32)],
                     "Iter": [np.array([4], np.int64)],
                     "InScales": [np.zeros(3, np.float32)]},
                    {"window_size": 100})
    np.testing.assert_array_equal(short["OutScales"][0].numpy(),
                                  [0.0, 7.0, 0.0])


# --- the codes --------------------------------------------------------------

def _planted(qd, scale):
    """f32 inputs whose x / scale * qmax lands exactly on a rounding tie
    of the grid (k + 0.5 for int8, the midpoint of two adjacent fp8
    values), both signs, plus saturating ones."""
    qmax = np.float32(QMAX[qd])
    s = np.float32(scale)
    if qd == "int8":
        targets = [np.float32(k + 0.5) for k in range(-5, 5)] + \
            [np.float32(126.5)]
    else:
        dt = torch.float8_e4m3fn if qd == "e4m3" else torch.float8_e5m2
        grid = torch.arange(256, dtype=torch.uint8).view(dt).float().numpy()
        grid = np.unique(grid[np.isfinite(grid)])
        mids = (grid[:-1] + grid[1:]) / 2
        pick = np.linspace(0, len(mids) - 1, 24).astype(int)
        targets = [np.float32(m) for m in mids[pick]
                   if np.float32(m) == m and abs(m) < qmax]
    out = []
    for t in targets:
        x = np.float32(t * s / qmax)
        for _ in range(64):
            y = np.float32(np.float32(x / s) * qmax)
            if y == t:
                out.append(x)
                break
            x = np.nextafter(x, np.float32(np.inf if y < t else -np.inf),
                             dtype=np.float32)
    out += [s * 3, -s * 5]            # saturate at +-qmax
    return np.array(out, np.float32)


@pytest.mark.parametrize("qd", QDS)
def test_quantize_array_codes_bit_equal_to_jax(qd):
    rng = np.random.RandomState(3)
    scale = np.float32(2.75)
    ties = _planted(qd, scale)
    assert len(ties) >= 8
    x = np.concatenate([ties, (rng.randn(4000) * 2).astype(np.float32)])
    want = jq.quantize_array(jnp.asarray(x), jnp.asarray(scale), qd)
    got = tq.quantize_array(torch.from_numpy(x), torch.tensor(scale), qd)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # per-channel scales broadcast as in JAX
    w = rng.randn(32, 6).astype(np.float32)
    sw = np.abs(w).max(0)
    np.testing.assert_array_equal(
        _bits(tq.quantize_array(torch.from_numpy(w),
                                torch.from_numpy(sw)[None], qd)),
        _bits(jq.quantize_array(jnp.asarray(w), jnp.asarray(sw)[None], qd)))
    np.testing.assert_array_equal(
        tq.channel_scales(torch.from_numpy(w), 1).numpy(),
        jq.channel_scales(w, 1))


def test_qspec_and_the_flag_refuse_an_unknown_spelling():
    for name in QDS:
        assert tq.qspec(name)[1] == QMAX[name]
    with pytest.raises(EnforceNotMet, match="unknown quantize_dtype"):
        tq.qspec("int4")
    ptt.flags.set_flag("quantize_dtype", "int4")
    with pytest.raises(EnforceNotMet, match="int4"):
        _tlower("mul", {"X": [np.ones((2, 3), np.float32)],
                        "Y": [np.ones((3, 4), np.float32)]}, {})


# --- the products -----------------------------------------------------------

LP_SHAPES = {"2d": ((8, 16), (16, 12)), "batched_x": ((4, 8, 16), (16, 12)),
             "both_batched": ((2, 3, 8, 16), (2, 3, 16, 12)),
             "broadcast": ((2, 3, 8, 16), (3, 16, 12))}


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp"])
@pytest.mark.parametrize("shape", sorted(LP_SHAPES))
@pytest.mark.parametrize("qd", QDS)
def test_low_precision_matmul_matches_jax(qd, shape, amp):
    """Forward: int8 bit-equal, fp8 within FP8_RTOL; the STE backward
    equal to JAX's custom_vjp (the AMP-policy product's vjp)."""
    jflags.set_flag("amp_bf16", amp)
    ptt.flags.set_flag("amp_bf16", amp)
    rng = np.random.RandomState(11)
    xs, ys = LP_SHAPES[shape]
    x, y = _x(rng, *xs), _x(rng, *ys)
    out_j, vjp = jax.vjp(
        lambda a, b: jq.low_precision_matmul(a, b, qd, jnp.float32),
        jnp.asarray(x), jnp.asarray(y))
    g = rng.randn(*out_j.shape).astype(np.float32)
    gxj, gyj = vjp(jnp.asarray(g).astype(out_j.dtype))
    xt, yt = (torch.from_numpy(a.copy()).requires_grad_() for a in (x, y))
    out_t = tq.low_precision_matmul(xt, yt, qd, torch.float32)
    assert str(out_t.dtype)[6:] == out_j.dtype.name
    gxt, gyt = torch.autograd.grad(out_t, (xt, yt),
                                   torch.from_numpy(g).to(out_t.dtype))
    if qd == "int8":
        np.testing.assert_array_equal(_f32(out_t), _f32(out_j))
    else:
        assert _rel(out_t, out_j) <= (AMP_RTOL if amp else FP8_RTOL)
    tol = AMP_RTOL if amp else GRAD_RTOL
    assert _rel(gxt, gxj) <= tol and _rel(gyt, gyj) <= tol
    assert gxt.dtype == torch.float32 and gyt.dtype == torch.float32


def test_low_precision_matmul_is_the_fake_quant_composition():
    """JAX's acceptance test (test_quantize_exec.py): the real int8
    forward is the fake-quant simulation of the same product (per-tensor
    x, per-column y), up to f32 rounding."""
    qd = "int8"
    rng = np.random.RandomState(2)
    x, w = _x(rng, 8, 16), _x(rng, 16, 4)
    real = tq.low_precision_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                   qd, torch.float32)
    xf = _tlower("fake_quantize_abs_max", {"X": [x]}, {})["Out"][0]
    wf = _tlower("fake_channel_wise_quantize_abs_max", {"X": [w]},
                 {"quant_axis": 1})["Out"][0]
    np.testing.assert_allclose(real.numpy(), (xf @ wf).numpy(), rtol=1e-5,
                               atol=1e-5)


def test_amp_matmul_takes_the_flag_for_floating_operands_only():
    rng = np.random.RandomState(5)
    x, y = _x(rng, 4, 8), _x(rng, 8, 3)
    ins = {"X": [x], "Y": [y]}
    plain = _tlower("mul", ins, {})["Out"][0]
    for f in (jflags, ptt.flags):
        f.set_flag("quantize_dtype", "int8")
    q = _tlower("mul", ins, {})["Out"][0]
    np.testing.assert_array_equal(q.numpy(),
                                  np.asarray(_jlower("mul", ins, {})["Out"][0]))
    assert not torch.equal(q, plain)
    ints = {"X": [np.arange(12).reshape(3, 4).astype(np.int32)],
            "Y": [np.ones((4, 2), np.int32)]}
    np.testing.assert_array_equal(
        _tlower("matmul", ints, {})["Out"][0].numpy(),
        ints["X"][0] @ ints["Y"][0])
    # bmm and matmul take it too
    a, b = _x(rng, 2, 4, 8), _x(rng, 2, 8, 3)
    for op in ("bmm", "matmul"):
        np.testing.assert_array_equal(
            _tlower(op, {"X": [a], "Y": [b]}, {})["Out"][0].numpy(),
            np.asarray(_jlower(op, {"X": [a], "Y": [b]}, {})["Out"][0]))


def _frozen_weight(rng, shape, axis, qd):
    w = _x(rng, *shape) * 0.3
    s = np.maximum(np.abs(w).max(axis=tuple(a for a in range(w.ndim)
                                          if a != axis)), 1e-8)
    bshape = [1] * w.ndim
    bshape[axis] = -1
    wq = jq.quantize_array(jnp.asarray(w), jnp.asarray(s).reshape(bshape),
                           qd)
    return wq, s.astype(np.float32)


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name.startswith("float8"):
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            getattr(torch, a.dtype.name))
    return torch.from_numpy(a.copy())


def _both(op, ins, attrs, out):
    j = np.asarray(jax_op(op).lower(JaxCtx(jax.random.PRNGKey(0)),
                                    {k: [jnp.asarray(v) for v in vs]
                                     for k, vs in ins.items()},
                                    attrs)[out][0])
    t = torch_op(op).lower(TorchCtx(0, torch.device("cpu")),
                           {k: [_to_torch(v) for v in vs]
                            for k, vs in ins.items()}, attrs)[out][0]
    return j, t


@pytest.mark.parametrize("in_scale", [False, True], ids=["dynamic", "inscale"])
@pytest.mark.parametrize("xn", [1, 2])
@pytest.mark.parametrize("qd", QDS)
def test_quantized_matmul_matches_jax(qd, xn, in_scale):
    rng = np.random.RandomState(7)
    x = _x(rng, 3, 5, 16) if xn == 2 else _x(rng, 6, 16)
    wq, s = _frozen_weight(rng, (16, 12), 1, qd)
    ins = {"X": [x], "W": [wq], "WScale": [s]}
    if in_scale:
        ins["InScale"] = [np.float32(1.25)]   # below max |x|: clips
    j, t = _both("quantized_matmul", ins,
                 {"quantize_dtype": qd, "x_num_col_dims": xn}, "Out")
    assert tuple(t.shape) == j.shape
    if qd == "int8":
        np.testing.assert_array_equal(t.numpy(), j)
    else:
        assert _rel(t, j) <= FP8_RTOL


CONV_CASES = {
    "plain": dict(strides=[1, 1], paddings=[0, 0], dilations=[1, 1],
                  groups=1),
    "stride_pad": dict(strides=[2, 2], paddings=[1, 1], dilations=[1, 1],
                       groups=1),
    "asym_stride_dilated": dict(strides=[2, 1], paddings=[2, 1],
                                dilations=[2, 1], groups=1),
    "groups": dict(strides=[1, 1], paddings=[1, 1], dilations=[1, 1],
                   groups=4),
    "depthwise": dict(strides=[1, 1], paddings=[1, 1], dilations=[1, 1],
                      groups=8),
}


def _conv_operands(rng, case, qd):
    groups = CONV_CASES[case]["groups"]
    x = _x(rng, 2, 8, 9, 9)
    wq, s = _frozen_weight(rng, (16, 8 // groups, 3, 3), 0, qd)
    return x, wq, s


@pytest.mark.parametrize("in_scale", [False, True], ids=["dynamic", "inscale"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
@pytest.mark.parametrize("qd", QDS)
def test_quantized_conv2d_matches_jax(qd, case, in_scale):
    rng = np.random.RandomState(9)
    x, wq, s = _conv_operands(rng, case, qd)
    ins = {"Input": [x], "Filter": [wq], "FilterScale": [s]}
    if in_scale:
        ins["InScale"] = [np.float32(1.5)]
    j, t = _both("quantized_conv2d", ins,
                 dict(CONV_CASES[case], quantize_dtype=qd), "Output")
    assert tuple(t.shape) == j.shape
    if qd == "int8":
        np.testing.assert_array_equal(t.numpy(), j)
    else:
        assert _rel(t, j) <= FP8_RTOL


@pytest.mark.parametrize("case", sorted(CONV_CASES))
@pytest.mark.parametrize("qd", ["int8", "e4m3"])
def test_the_card_lowerings_equal_the_plain_versions(qd, case):
    """The card's im2col convolution and its 2-D product loop, run on the
    CPU through the same library entries (torch._int_mm, _scaled_mm):
    the accumulators equal F.conv2d / matmul in f64 (int8) or f32 (e4m3)
    of the same codes.  e5m2's bf16 product (torch.mm with out_dtype) has
    no CPU kernel: the card tests hold it."""
    rng = np.random.RandomState(13)
    x, wq, _ = _conv_operands(rng, case, qd)
    xt = torch.from_numpy(x)
    xq = tq.quantize_array(xt, xt.abs().max(), qd)
    wt = _to_torch(wq)
    c = CONV_CASES[case]
    geo = (tuple(c["strides"]), tuple(c["paddings"]),
           tuple(c["dilations"]), c["groups"])
    before = dict(tq.lp_product.launches)
    got = tq._conv_lowered(xq, wt, qd, *geo)
    want = tq.lp_conv2d_plain(xq, wt, qd, *geo)
    route = "int_mm" if qd == "int8" else "scaled_mm"
    assert tq.lp_product.launches[route] - before.get(route, 0) == \
        c["groups"]
    assert got.dtype == want.dtype and got.shape == want.shape
    if qd == "int8":
        assert torch.equal(got, want)
    else:
        assert _rel(got, want) <= FP8_RTOL
    # the product loop, with every dimension off the library's granules
    for xs, ys in (((5, 13), (13, 3)), ((2, 3, 9, 20), (2, 3, 20, 7)),
                   ((4, 17, 24), (24, 16))):
        a = tq.quantize_array(torch.from_numpy(_x(rng, *xs)),
                              torch.tensor(2.0), qd)
        b = tq.quantize_array(torch.from_numpy(_x(rng, *ys)),
                              torch.tensor(2.0), qd)
        got = tq._product_lowered(a, b, qd)
        want = tq.lp_product_plain(a, b, qd)
        assert got.shape == want.shape
        if qd == "int8":
            assert torch.equal(got, want)
        else:
            assert _rel(got, want) <= FP8_RTOL


def test_quantized_op_infer_rules_match_jax():
    from paddle_tpu.analysis import infer_rules as jrules
    from paddle_tpu_torch.analysis import infer_rules as trules
    from paddle_tpu.framework.registry import get_shape_infer as jget
    from paddle_tpu_torch.framework.registry import get_shape_infer as tget

    class Op:
        inputs = {"W": ["w"]}

    cases = [("quantized_matmul", {"X": [((-1, 16), "float32")],
                                   "W": [((16, 8), "int8")]},
              {"x_num_col_dims": 1}),
             ("quantized_matmul", {"X": [((-1, 4, 16), "float32")],
                                   "W": [((16, 8), "int8")]},
              {"x_num_col_dims": 2}),
             ("quantized_conv2d", {"Input": [((-1, 8, 9, 9), "float32")],
                                   "Filter": [((16, 2, 3, 3), "int8")]},
              {"groups": 4})]
    for op, ins, attrs in cases:
        assert tget(op)(Op, ins, attrs) == jget(op)(Op, ins, attrs)
    bad = [("quantized_matmul", {"X": [((-1, 12), "float32")],
                                 "W": [((16, 8), "int8")]}, {}),
           ("quantized_conv2d", {"Input": [((-1, 8, 9, 9), "float32")],
                                 "Filter": [((16, 3, 3, 3), "int8")]},
            {"groups": 1})]
    for op, ins, attrs in bad:
        with pytest.raises(jrules.InferError):
            jget(op)(Op, ins, attrs)
        with pytest.raises(trules.InferError):
            tget(op)(Op, ins, attrs)


def test_meta_evaluation_runs_with_the_flag_off():
    """A program built under FLAGS_quantize_dtype declares what it
    declares without it; the flag is restored after each evaluation."""
    views = []
    for qd in ("", "int8"):
        ptt.reset_default_programs()
        ptt.flags.set_flag("quantize_dtype", qd)
        main, startup = ptt.Program(), ptt.Program()
        with ptt.program_guard(main, startup):
            x = ptt.layers.data("x", [6, 16], dtype="float32")
            h = ptt.layers.fc(x, size=8, num_flatten_dims=2)
            ptt.layers.matmul(h, h, transpose_y=True)
        assert ptt.flags.get_flag("quantize_dtype") == qd
        views.append({v.name: (v.shape, v.dtype) for v in main.list_vars()})
    assert views[0] == views[1]


# --- the transpiler and the programs ---------------------------------------

def _qat_net(pkg, conv=False):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup):
        if conv:
            img = pkg.layers.data("img", [3, 8, 8], dtype="float32")
            c = pkg.layers.conv2d(img, 4, 3, padding=1, act="relu")
            c = pkg.layers.conv2d(c, 4, 3, stride=2, padding=1, groups=2)
            x = pkg.layers.reshape(c, [-1, 64])
        else:
            x = pkg.layers.data("x", [16], dtype="float32")
        y = pkg.layers.data("y", [1], dtype="float32")
        h = pkg.layers.fc(x, size=16, act="relu")
        pred = pkg.layers.fc(h, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
    return main, startup, pred, loss


def _feed(conv, seed=0, n=32):
    rng = np.random.RandomState(seed)
    if conv:
        feed = {"img": _x(rng, n, 3, 8, 8)}
        feed["y"] = feed["img"].reshape(n, -1)[:, :1] * 2
    else:
        feed = {"x": _x(rng, n, 16)}
        feed["y"] = feed["x"] @ np.linspace(-1, 1, 16, dtype=np.float32
                                            ).reshape(16, 1)
    return feed


def _startup_view(prog):
    return [(op.type, op.inputs, op.outputs, op.attrs)
            for op in prog.global_block().ops]


@pytest.mark.parametrize("act", ["abs_max", "moving_average_abs_max",
                                 "range_abs_max"])
@pytest.mark.parametrize("conv", [False, True], ids=["fc", "conv"])
def test_training_transpile_serializes_like_jax(conv, act):
    progs = {}
    for pkg, qt in ((pt, JQT), (ptt, TQT)):
        pkg.reset_default_programs()
        main, startup, _, _ = _qat_net(pkg, conv)
        test = main.clone(for_test=True)
        t = qt(activation_quantize_type=act)
        t.training_transpile(main, startup)
        t.training_transpile(test, startup)
        progs[pkg] = (main, startup, test)
    for j, t in zip(progs[pt], progs[ptt]):
        assert _op_view(t) == _op_view(j)
        assert _var_view(t) == _var_view(j)
    assert _startup_view(progs[ptt][1]) == _startup_view(progs[pt][1])
    kinds = [op.type for op in progs[ptt][0].global_block().ops]
    assert kinds.count("fake_channel_wise_quantize_abs_max") == \
        (4 if conv else 2)


def _train_jax(conv, act, steps, qd=None):
    """QAT in JAX from its startup: (main, startup, pred, loss, frozen-able
    test clone, transpiler, scope, the startup's persistables)."""
    pt.reset_default_programs()
    main, startup, pred, loss = _qat_net(pt, conv)
    qt = JQT(activation_quantize_type=act)
    qt.training_transpile(main, startup)
    test = main.clone(for_test=True)
    with pt.program_guard(main, startup):
        pt.optimizer.SGD(0.05).minimize(loss)
    exe = pt.Executor(pt.CPUPlace(), scope=pt.Scope())
    exe.run(startup)
    init = {v.name: np.asarray(exe.scope.find_var(v.name))
            for v in main.list_vars() if v.persistable
            and exe.scope.find_var(v.name) is not None}
    for s in range(steps):
        exe.run(main, feed=_feed(conv, s), fetch_list=[loss])
    return dict(main=main, startup=startup, pred=pred, loss=loss,
                test=test, qt=qt, exe=exe, init=init)


def _port_programs(conv, act):
    ptt.reset_default_programs()
    main, startup, pred, loss = _qat_net(ptt, conv)
    qt = TQT(activation_quantize_type=act)
    qt.training_transpile(main, startup)
    test = main.clone(for_test=True)
    with ptt.program_guard(main, startup):
        ptt.optimizer.SGD(0.05).minimize(loss)
    return main, startup, pred, loss, test, qt


def _scope_of(jexe, prog):
    arrays = {v.name: np.asarray(jexe.scope.find_var(v.name))
              for v in prog.list_vars() if v.persistable
              and jexe.scope.find_var(v.name) is not None}
    scope = ptt.Scope()
    ptt.io.params_from_numpy(scope, arrays, ptt.CPUPlace())
    return scope


@pytest.mark.parametrize("qd", QDS)
@pytest.mark.parametrize("conv", [False, True], ids=["fc", "conv"])
def test_freeze_program_matches_jax(conv, qd):
    """From JAX's trained state: the frozen programs serialize alike, the
    quantized weights and their scales are JAX's bit for bit, and the
    frozen outputs agree."""
    j = _train_jax(conv, "moving_average_abs_max", 4)
    _, _, pred, _, test, qt = _port_programs(conv, "moving_average_abs_max")
    scope = _scope_of(j["exe"], j["main"])
    jf = j["qt"].freeze_program(j["test"], scope=j["exe"].scope,
                                quantize_dtype=qd)
    tf = qt.freeze_program(test, scope=scope, quantize_dtype=qd)
    assert _op_view(tf) == _op_view(jf)
    assert _var_view(tf) == _var_view(jf)
    kinds = [op.type for op in tf.global_block().ops]
    assert kinds.count("quantized_matmul") == 2
    assert kinds.count("quantized_conv2d") == (2 if conv else 0)
    assert not any(k.startswith("fake_") for k in kinds)
    for op in tf.global_block().ops:
        for slot in ("W", "Filter", "WScale", "FilterScale"):
            for n in op.inputs.get(slot, ()):
                want = j["exe"].scope.find_var(n)
                got = scope.find_var(n)
                assert tf.global_block().var(n).dtype == \
                    jf.global_block().var(n).dtype
                np.testing.assert_array_equal(_bits(got), _bits(want),
                                              err_msg=n)
    # JAX's executor run eagerly (its per-op debug mode), where a division
    # by a constant stays a division: jitted, XLA's reciprocal moves a
    # value by an ulp, which can flip a code of the next layer
    feed = _feed(conv, 9)
    jflags.set_flag("check_nan_inf_per_op", True)
    try:
        want, = j["exe"].run(jf, feed=feed, fetch_list=[pred.name])
    finally:
        jflags.set_flag("check_nan_inf_per_op", False)
    got, = ptt.Executor(ptt.CPUPlace(), scope=scope).run(
        tf, feed=feed, fetch_list=[pred.name])
    if qd == "int8":
        np.testing.assert_array_equal(got, np.asarray(want))
    else:
        assert _rel(got, np.asarray(want)) <= FP8_RTOL


def test_freeze_program_refusals():
    _, startup, _, _, test, qt = _port_programs(False,
                                                "moving_average_abs_max")
    exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    with pytest.raises(EnforceNotMet, match="no recorded value"):
        qt.freeze_program(test.clone(), scope=exe.scope)
    exe.run(startup)
    with pytest.raises(EnforceNotMet, match="never trained"):
        qt.freeze_program(test.clone(), scope=exe.scope)
    with pytest.raises(EnforceNotMet, match="unknown quantize_dtype"):
        qt.freeze_program(test.clone(), scope=exe.scope,
                          quantize_dtype="fp4")


def test_freeze_drops_orphans_and_keeps_scale_state_shared():
    """The train program and its test clone, transpiled apart, share the
    deterministic .quant_in_scale vars; after the freeze no fp32 weight
    Parameter is left and every weight reads an int8 twin."""
    main, startup, pred, loss, test, qt = _port_programs(
        False, "moving_average_abs_max")
    scales = sorted(v.name for v in main.list_vars()
                    if v.persistable and "quant_in_scale" in v.name)
    assert scales == sorted(v.name for v in test.list_vars()
                            if v.persistable and "quant_in_scale" in v.name)
    exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    exe.run(startup)
    for s in range(3):
        exe.run(main, feed=_feed(False, s), fetch_list=[loss])
    assert all(float(exe.scope.find_var(n)) != 1.0 for n in scales)
    frozen = qt.freeze_program(test, scope=exe.scope)
    params = [p.name for p in frozen.all_parameters()]
    assert not any(n.endswith(".w_0") for n in params), params
    for op in frozen.global_block().ops:
        if op.type == "quantized_matmul":
            assert exe.scope.find_var(op.inputs["W"][0]).dtype == torch.int8


@pytest.mark.parametrize("act", ["abs_max", "moving_average_abs_max"])
def test_qat_steps_match_jax(act):
    """Three SGD steps of the conv QAT net, each from JAX's state before
    it: the loss, every param's change and the moving-average scales."""
    j = _train_jax(True, act, 0)
    main, startup, pred, loss, _, _ = _port_programs(True, act)
    names = sorted(j["init"])
    assert names == sorted(v.name for v in main.list_vars()
                           if v.persistable and v.name in j["init"])
    texe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    for s in range(3):
        before = {n: np.asarray(j["exe"].scope.find_var(n)) for n in names}
        ptt.io.params_from_numpy(texe.scope, before, ptt.CPUPlace())
        feed = _feed(True, s)
        jl, = j["exe"].run(j["main"], feed=feed, fetch_list=[j["loss"]])
        tl, = texe.run(main, feed=feed, fetch_list=[loss])
        np.testing.assert_allclose(tl, np.asarray(jl), rtol=STEP_LOSS_RTOL)
        for n in names:
            want = np.asarray(j["exe"].scope.find_var(n)) - before[n]
            got = texe.scope.find_var(n).numpy() - before[n]
            assert np.abs(got - want).max() <= STEP_STATE_RTOL * max(
                np.abs(want).max(), np.abs(before[n]).max()), n
    if act == "moving_average_abs_max":
        moved = [n for n in names if n.endswith(".quant_in_scale")]
        assert moved and all(float(texe.scope.find_var(n)) != 1.0
                             for n in moved)


def test_verify_program_on_frozen_programs_matches_jax():
    from paddle_tpu import analysis as janalysis
    from paddle_tpu_torch import analysis as tanalysis
    for qd in ("int8", "e4m3"):
        j = _train_jax(True, "moving_average_abs_max", 2)
        _, _, _, _, test, qt = _port_programs(True,
                                              "moving_average_abs_max")
        scope = _scope_of(j["exe"], j["main"])
        jf = j["qt"].freeze_program(j["test"], scope=j["exe"].scope,
                                    quantize_dtype=qd)
        tf = qt.freeze_program(test, scope=scope, quantize_dtype=qd)
        jr = janalysis.verify_program(jf, strict_shapes=True)
        tr = tanalysis.verify_program(tf, strict_shapes=True)
        assert sorted((f.code, f.severity) for f in tr.findings) == \
            sorted((f.code, f.severity) for f in jr.findings)
        assert not tr.errors


def test_int8_lm_steps_match_jax():
    """test_quantize_exec.py::test_int8_lm_compiles_and_trains_on_cpu's
    small LM (the unfused build: its q.k^T is a product of two batched
    operands) under quantize_dtype int8, three SGD steps each from JAX's
    state: the loss and every param's change."""
    from paddle_tpu.models import transformer as jtr
    from paddle_tpu_torch.models import transformer as ttr
    progs = {}
    for pkg, tr in ((pt, jtr), (ptt, ttr)):
        pkg.reset_default_programs()
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 3
        cfg = tr.TransformerConfig(src_vocab_size=128, tgt_vocab_size=128,
                                   max_length=32, n_layer=1, n_head=2,
                                   d_model=16, d_inner=32, dropout=0.0)
        with pkg.program_guard(main, startup):
            _, loss, _ = tr.build_lm_net(cfg, 16, fused_attention=False)
            pkg.optimizer.SGD(0.1).minimize(loss)
        progs[pkg] = (main, startup, loss, cfg)
    jmain, jstart, jloss, cfg = progs[pt]
    tmain, _, tloss, _ = progs[ptt]
    assert _op_view(tmain) == _op_view(jmain)
    jexe = pt.Executor(pt.CPUPlace(), scope=pt.Scope())
    jexe.run(jstart)
    texe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    names = sorted(v.name for v in jmain.list_vars() if v.persistable
                   and jexe.scope.find_var(v.name) is not None)
    for f in (jflags, ptt.flags):
        f.set_flag("quantize_dtype", "int8")
    losses = []
    for s in range(3):
        before = {n: np.asarray(jexe.scope.find_var(n)) for n in names}
        ptt.io.params_from_numpy(texe.scope, before, ptt.CPUPlace())
        feed = jtr.make_fake_lm_batch(cfg, 2, 16, seed=s)
        jl, = jexe.run(jmain, feed=feed, fetch_list=[jloss])
        tl, = texe.run(tmain, feed=feed, fetch_list=[tloss])
        np.testing.assert_allclose(tl, np.asarray(jl), rtol=STEP_LOSS_RTOL)
        losses.append(float(np.asarray(tl).reshape(-1)[0]))
        for n in names:
            want = np.asarray(jexe.scope.find_var(n)) - before[n]
            got = texe.scope.find_var(n).numpy() - before[n]
            assert np.abs(got - want).max() <= STEP_STATE_RTOL * max(
                np.abs(want).max(), 1e-3 * np.abs(before[n]).max()), n
    assert all(np.isfinite(losses))


def test_fused_multihead_attention_matches_jax():
    """Three matmul projections, one fused_attention op and the output
    matmul under JAX's names; from JAX's initialisation the output and
    every param gradient agree."""
    progs = {}
    for pkg in (pt, ptt):
        pkg.reset_default_programs()
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 8
        with pkg.program_guard(main, startup):
            q, k, v = (pkg.layers.data(n, [16, 32], dtype="float32")
                       for n in "qkv")
            out = pkg.layers.fused_multihead_attention(
                q, k, v, 4, causal=True,
                param_attr=pkg.ParamAttr(name="mha"))
            loss = pkg.layers.mean(pkg.layers.square(out))
            _, pg = pkg.optimizer.SGD(0.0).minimize(loss)
        progs[pkg] = (main, startup, out, [g.name for _, g in pg])
    (jm, js, jo, jg), (tm, _, to, tg) = progs[pt], progs[ptt]
    assert _op_view(tm) == _op_view(jm) and _var_view(tm) == _var_view(jm)
    assert [op.type for op in tm.global_block().ops][:5] == \
        ["matmul", "matmul", "matmul", "fused_attention", "matmul"]
    assert sorted(p.name for p in tm.all_parameters()) == \
        ["mha.k", "mha.o", "mha.q", "mha.v"]
    jexe = pt.Executor(pt.CPUPlace(), scope=pt.Scope())
    jexe.run(js)
    rng = np.random.RandomState(4)
    feed = {n: _x(rng, 2, 16, 32) for n in "qkv"}
    want = jexe.run(jm, feed=feed, fetch_list=[jo] + jg)
    texe = ptt.Executor(ptt.CPUPlace(), scope=_scope_of(jexe, jm))
    got = texe.run(tm, feed=feed, fetch_list=[to] + tg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                   atol=1e-5 * np.abs(np.asarray(w)).max())
