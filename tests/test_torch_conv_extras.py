"""The rest of the conv family through both packages: conv3d,
conv2d_transpose, depthwise_conv2d_transpose, conv3d_transpose, pool3d,
the index pools (pool2d_with_index, max_pool2d_with_index,
max_pool3d_with_index), group_norm and instance_norm (ops/nn_ops.py,
misc_ops.py, fused_ops.py), and their layers.

The forward of every case is in ``tests/test_torch_ops.py``'s
``CONV_EXTRA_CASES``.  Here:

- gradients: torch autograd through the port's lowering against jax.vjp
  of the JAX lowering under seeded cotangents of every float output, at
  CONV (rtol 1e-4, atol 1e-5: sums over a window or a group in another
  order);
- the index pools: JAX's variadic reduce_window has no vjp (jax.vjp
  raises); the port's gradient puts each cotangent on the element its
  Mask names (rtol and atol 1e-6: where overlapping windows pick one
  element, its cotangents add in another order), and a seeded sweep
  of 2-D and 3-D windows, strides and paddings on planted ties gives
  JAX's Out and Mask exactly;
- under FLAGS_amp_bf16 each op returns the dtype the JAX lowering returns
  under the flag, on bf16 activations beside f32 filters and norm
  params, with values within AMP_STEPS bf16 steps (2^-7) of max |JAX|;
- the layers (JAX's test_vision_extras build, tests/test_layers_breadth.py
  :172-201: conv3d, pool3d, adaptive_pool3d, conv3d_transpose; and
  conv2d_transpose and group_norm) serialize like JAX's and, from JAX's
  initialisation, give its outputs at CONV.
"""
import itertools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.framework.registry import LowerContext as JaxCtx
from paddle_tpu.framework.registry import get_op_def as jax_op
from paddle_tpu_torch.framework.registry import LowerContext as TorchCtx
from paddle_tpu_torch.framework.registry import get_op_def as torch_op
from test_torch_ops import CASES, CONV, _multi_grads
from test_torch_train import _op_view, _var_view

AMP_STEPS = 2
STEP = 2.0 ** -7

# case of CONV_EXTRA_CASES -> (differentiated slots, output slots)
GRAD_CASES = {
    "conv3d_sweep": (("Input", "Filter"), ("Output",)),
    "conv3d_pad_stride_dilation": (("Input", "Filter"), ("Output",)),
    "conv3d_groups_same": (("Input", "Filter"), ("Output",)),
    "conv2d_transpose_sweep": (("Input", "Filter"), ("Output",)),
    "conv2d_transpose_stride_pad": (("Input", "Filter"), ("Output",)),
    "conv2d_transpose_wide_pad_dilated": (("Input", "Filter"), ("Output",)),
    "conv2d_transpose_groups": (("Input", "Filter"), ("Output",)),
    "depthwise_conv2d_transpose_sweep": (("Input", "Filter"), ("Output",)),
    "depthwise_conv2d_transpose_multiplier": (("Input", "Filter"),
                                              ("Output",)),
    "conv3d_transpose_sweep": (("Input", "Filter"), ("Output",)),
    "conv3d_transpose_stride_pad": (("Input", "Filter"), ("Output",)),
    "pool3d_sweep_avg": (("X",), ("Out",)),
    "pool3d_default_window_max": (("X",), ("Out",)),
    "pool3d_max_pad_ceil": (("X",), ("Out",)),
    "pool3d_avg_pad_excl": (("X",), ("Out",)),
    "pool3d_avg_incl_ceil": (("X",), ("Out",)),
    "pool3d_global_avg": (("X",), ("Out",)),
    "group_norm_sweep": (("X", "Scale", "Bias"), ("Y", "Mean", "Variance")),
    "group_norm_no_affine_3d": (("X",), ("Y", "Mean", "Variance")),
    "group_norm_g1": (("X", "Scale"), ("Y",)),
    "instance_norm_sweep": (("X",), ("Y",)),
    "instance_norm_affine": (("X", "Scale", "Bias"), ("Y",)),
}


@pytest.fixture(autouse=True)
def fresh_programs():
    ptt.reset_default_programs()
    yield
    ptt.reset_default_programs()
    pt.core.flags.set_flag("amp_bf16", False)
    ptt.flags.set_flag("amp_bf16", False)


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_conv_extra_grad_matches_jax(name):
    op, build, attrs, _, _ = CASES[name]
    wrt, outs = GRAD_CASES[name]
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    jg, tg, jo, to = _multi_grads(op, build(rng), attrs, wrt, outs, rng)
    assert len(jg) == len(tg) == len(wrt)
    for j, t in zip(jo, to):
        assert tuple(t.shape) == j.shape
    for slot, j, t in zip(wrt, jg, tg):
        assert t.shape == j.shape, slot
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=slot,
                                   **CONV)
        assert np.abs(np.asarray(j)).max() > 0, slot


def _lower(side, op, ins, attrs):
    if side == "jax":
        return jax_op(op).lower(JaxCtx(jax.random.PRNGKey(0)),
                                {k: [jnp.asarray(a) for a in v]
                                 for k, v in ins.items()}, attrs)
    return torch_op(op).lower(TorchCtx(0, torch.device("cpu")),
                              {k: [torch.from_numpy(np.array(a))
                                   for a in v] for k, v in ins.items()},
                              attrs)


INDEX_POOLS = ["pool2d_with_index_ties_pad", "max_pool2d_with_index_sweep",
               "max_pool3d_with_index_ties_pad",
               "pool2d_with_index_ties_k2p1_last"]


@pytest.mark.parametrize("name", INDEX_POOLS)
def test_index_pool_grad_goes_to_the_masked_element(name):
    """JAX cannot differentiate its (value, index) reduce_window; the
    port's gradient of Out is the cotangent scatter-added at Mask."""
    op, build, attrs, _, _ = CASES[name]
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    ins = build(rng)
    with pytest.raises(Exception):
        jax.vjp(lambda x: jax_op(op).lower(
            JaxCtx(jax.random.PRNGKey(0)), {"X": [x]}, attrs)["Out"][0],
            jnp.asarray(ins["X"][0]))
    x = torch.from_numpy(ins["X"][0].copy()).requires_grad_(True)
    res = torch_op(op).lower(TorchCtx(0, torch.device("cpu")), {"X": [x]},
                             attrs)
    ct = rng.randn(*res["Out"][0].shape).astype("float32")
    g, = torch.autograd.grad(res["Out"][0], x, torch.from_numpy(ct))
    n, c = x.shape[:2]
    want = np.zeros((n, c, int(np.prod(x.shape[2:]))), np.float32)
    mask = res["Mask"][0].numpy().reshape(n, c, -1)
    for i in range(n):
        for j in range(c):
            np.add.at(want[i, j], mask[i, j], ct.reshape(n, c, -1)[i, j])
    np.testing.assert_allclose(g.numpy(), want.reshape(x.shape), rtol=1e-6,
                               atol=1e-6)


def _sweep_cases():
    """Seeded 2-D and 3-D windows, strides and paddings (a padding at
    most half the window, as pool_with_index_op.cc takes it)."""
    rng = np.random.RandomState(23)
    out = []
    for nd in (2, 3):
        for _ in range(12):
            k = [int(rng.randint(1, 4)) for _ in range(nd)]
            k[rng.randint(nd)] = max(k) if max(k) > 1 else 2
            s = [int(rng.randint(1, 3)) for _ in range(nd)]
            p = [int(rng.randint(0, kk // 2 + 1)) for kk in k]
            out.append((nd, k, s, p))
    return out


@pytest.mark.parametrize("nd,k,s,p", _sweep_cases())
def test_index_pool_ties_sweep_matches_jax(nd, k, s, p):
    op = "pool2d_with_index" if nd == 2 else "max_pool3d_with_index"
    rng = np.random.RandomState(zlib.crc32(repr((nd, k, s, p)).encode()))
    shape = (2, 3) + tuple(int(rng.randint(4, 8)) for _ in range(nd))
    x = np.round(rng.rand(*shape) * 2).astype("float32")
    attrs = {"ksize": k, "strides": s, "paddings": p}
    j, t = _lower("jax", op, {"X": [x]}, attrs), _lower(
        "port", op, {"X": [x]}, attrs)
    for slot in ("Out", "Mask"):
        a, b = t[slot][0].numpy(), np.asarray(j[slot][0])
        assert a.dtype == b.dtype, slot
        np.testing.assert_array_equal(a, b, err_msg=slot)


# (op, inputs, attrs, slots entering bf16, output slot)
AMP_CASES = {
    "conv3d": ("conv3d", lambda r: {
        "Input": [r.randn(2, 3, 5, 6, 5).astype("float32")],
        "Filter": [r.randn(4, 3, 3, 3, 3).astype("float32") * 0.3]},
        {"paddings": 1}, ("Input",), "Output"),
    "conv3d_f32_input": ("conv3d", lambda r: {
        "Input": [r.randn(2, 3, 5, 6, 5).astype("float32")],
        "Filter": [r.randn(4, 3, 2, 2, 2).astype("float32") * 0.3]},
        {"strides": 2}, (), "Output"),
    "conv2d_transpose": ("conv2d_transpose", lambda r: {
        "Input": [r.randn(2, 4, 5, 6).astype("float32")],
        "Filter": [r.randn(4, 3, 4, 4).astype("float32") * 0.3]},
        {"strides": [2, 2], "paddings": [1, 1]}, ("Input",), "Output"),
    "depthwise_conv2d_transpose": ("depthwise_conv2d_transpose", lambda r: {
        "Input": [r.randn(2, 3, 5, 5).astype("float32")],
        "Filter": [r.randn(3, 1, 2, 2).astype("float32")]},
        {"strides": 2}, ("Input",), "Output"),
    # no AMP casts in JAX's conv3d_transpose: an f32 input stays f32
    "conv3d_transpose_f32": ("conv3d_transpose", lambda r: {
        "Input": [r.randn(2, 3, 3, 4, 3).astype("float32")],
        "Filter": [r.randn(3, 2, 2, 2, 2).astype("float32") * 0.3]},
        {"strides": 2}, (), "Output"),
    "pool3d_max": ("pool3d", lambda r: {
        "X": [r.randn(2, 3, 4, 6, 4).astype("float32")]},
        {"pooling_type": "max"}, ("X",), "Out"),
    "pool3d_avg": ("pool3d", lambda r: {
        "X": [r.randn(2, 3, 4, 6, 4).astype("float32")]},
        {"pooling_type": "avg", "ksize": 2, "strides": 2}, ("X",), "Out"),
    "group_norm": ("group_norm", lambda r: {
        "X": [r.randn(2, 4, 5, 5).astype("float32") * 3],
        "Scale": [r.randn(4).astype("float32")],
        "Bias": [r.randn(4).astype("float32")]}, {"groups": 2}, ("X",),
        "Y"),
    "instance_norm": ("instance_norm", lambda r: {
        "X": [r.randn(2, 4, 5, 5).astype("float32") * 3],
        "Scale": [r.randn(4).astype("float32")],
        "Bias": [r.randn(4).astype("float32")]}, {}, ("X",), "Y"),
}


def _bf16_values(a):
    return np.asarray(torch.from_numpy(a).to(torch.bfloat16).float())


@pytest.mark.parametrize("name", sorted(AMP_CASES))
def test_conv_extra_amp_dtypes_match_jax(name):
    """Under FLAGS_amp_bf16: bf16 activations (f32 filters and norm
    params beside them) give JAX's output dtype, and values within
    AMP_STEPS bf16 steps of max |JAX| (the same bf16-rounded inputs)."""
    op, build, attrs, bf16, out = AMP_CASES[name]
    ins = build(np.random.RandomState(zlib.crc32(name.encode())))
    ins = {k: [_bf16_values(a) if k in bf16 else a for a in v]
           for k, v in ins.items()}
    jins = {k: [jnp.asarray(a).astype(jnp.bfloat16) if k in bf16
                else jnp.asarray(a) for a in v] for k, v in ins.items()}
    tins = {k: [torch.from_numpy(a).to(torch.bfloat16) if k in bf16
                else torch.from_numpy(a) for a in v]
            for k, v in ins.items()}
    pt.core.flags.set_flag("amp_bf16", True)
    ptt.flags.set_flag("amp_bf16", True)
    try:
        j = jax_op(op).lower(JaxCtx(jax.random.PRNGKey(0)), jins,
                             attrs)[out][0]
        t = torch_op(op).lower(TorchCtx(0, torch.device("cpu")), tins,
                               attrs)[out][0]
    finally:
        pt.core.flags.set_flag("amp_bf16", False)
        ptt.flags.set_flag("amp_bf16", False)
    assert str(t.dtype).split(".")[-1] == str(j.dtype), (t.dtype, j.dtype)
    j = np.asarray(jnp.asarray(j).astype(jnp.float32))
    t = t.float().numpy()
    assert t.shape == j.shape
    assert np.abs(t - j).max() <= AMP_STEPS * STEP * np.abs(j).max()


@pytest.mark.parametrize("op,attrs,shape", [
    ("pool2d_with_index", {"ksize": 3, "strides": 2, "paddings": 1},
     (2, 3, 7, 8)),
    ("max_pool3d_with_index", {"ksize": 2, "strides": 2}, (2, 3, 4, 6, 4))])
def test_index_pools_take_bf16_where_jax_raises(op, attrs, shape):
    """JAX's (value, index) reduce_window starts from f32 init values,
    which bf16 operands refuse (ROADMAP C); the port's index pools take
    a bf16 activation and give the f32 pool's Out (a max of bf16 values
    is one of them) in bf16 and its Mask."""
    x = _bf16_values(np.random.RandomState(4).randn(*shape).astype(
        "float32"))
    with pytest.raises(TypeError, match="reduce_window"):
        jax_op(op).lower(JaxCtx(jax.random.PRNGKey(0)),
                         {"X": [jnp.asarray(x).astype(jnp.bfloat16)]},
                         attrs)
    want = _lower("jax", op, {"X": [x]}, attrs)
    got = torch_op(op).lower(TorchCtx(0, torch.device("cpu")),
                             {"X": [torch.from_numpy(x).to(torch.bfloat16)]},
                             attrs)
    assert got["Out"][0].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["Out"][0].float().numpy(),
                                  np.asarray(want["Out"][0]))
    np.testing.assert_array_equal(got["Mask"][0].numpy(),
                                  np.asarray(want["Mask"][0]))


# ---------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------

def vision_net(pkg):
    L = pkg.layers
    v = L.data("img", [3, 8, 8])
    w = L.data("vol", [2, 4, 4, 4])
    c3 = L.conv3d(w, num_filters=4, filter_size=3, padding=1)
    p3 = L.pool3d(w, pool_size=2, pool_stride=2)
    a3 = L.adaptive_pool3d(w, pool_size=2)
    t3 = L.conv3d_transpose(w, num_filters=2, filter_size=2, stride=2)
    t2 = L.conv2d_transpose(v, num_filters=4, filter_size=4, stride=2,
                            padding=1, act="relu")
    g2 = L.group_norm(t2, groups=2)
    return [c3, p3, a3, t3, t2, g2]


def test_vision_layers_build_and_run_like_jax():
    r = np.random.RandomState(7)
    feed = {"img": r.randn(2, 3, 8, 8).astype("float32"),
            "vol": r.randn(1, 2, 4, 4, 4).astype("float32")}
    progs, outs = {}, {}
    for pkg in (pt, ptt):
        pkg.reset_default_programs()
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 9
        with pkg.program_guard(main, startup):
            fetches = vision_net(pkg)
        exe = pkg.Executor(pkg.CPUPlace(), scope=pkg.Scope())
        exe.run(startup)
        if pkg is pt:
            init = {p.name: np.asarray(exe.scope.find_var(p.name))
                    for p in main.all_parameters()}
        else:
            ptt.io.params_from_numpy(exe.scope, init, ptt.CPUPlace())
        progs[pkg] = (main, startup)
        outs[pkg] = [np.asarray(o) for o in exe.run(main, feed=feed,
                                                    fetch_list=fetches)]
    for t, j in zip(progs[ptt], progs[pt]):
        assert _op_view(t) == _op_view(j)
        assert _var_view(t) == _var_view(j)
    shapes = [(1, 4, 4, 4, 4), (1, 2, 2, 2, 2), (1, 2, 2, 2, 2),
              (1, 2, 8, 8, 8), (2, 4, 16, 16), (2, 4, 16, 16)]
    for a, b, shape in zip(outs[ptt], outs[pt], shapes):
        assert a.shape == b.shape == shape
        np.testing.assert_allclose(a, b, **CONV)


def test_adaptive_pool3d_tiles_the_volume():
    """A 5x6x7 volume into 2x3x2 cells: strides d // o, windows
    d - (o - 1) * stride, as JAX derives them."""
    main = ptt.Program()
    with ptt.program_guard(main, ptt.Program()):
        x = ptt.layers.data("x", [2, 5, 6, 7])
        y = ptt.layers.adaptive_pool3d(x, [2, 3, 2], pool_type="avg")
    op = main.global_block().ops[-1]
    assert op.type == "pool3d"
    assert op.attrs["ksize"] == [3, 2, 4] and op.attrs["strides"] == [2, 2, 3]
    assert y.shape == (-1, 2, 2, 3, 2)


@pytest.mark.parametrize("k,s,p,d", list(itertools.product(
    (2, 3), (1, 2), (0, 2), (1, 2))))
def test_conv2d_transpose_output_size(k, s, p, d):
    """(H - 1) * s - 2p + d * (k - 1) + 1, the size of JAX's
    gradient-of-conv formulation, padding past k_eff - 1 included."""
    r = np.random.RandomState(k * 100 + s * 10 + p + d)
    ins = {"Input": [r.randn(1, 2, 5, 4).astype("float32")],
           "Filter": [r.randn(2, 3, k, k).astype("float32")]}
    attrs = {"strides": s, "paddings": p, "dilations": d}
    want = [(n - 1) * s - 2 * p + d * (k - 1) + 1 for n in (5, 4)]
    assert min(want) > 0
    j = np.asarray(_lower("jax", "conv2d_transpose", ins, attrs)[
        "Output"][0])
    t = _lower("port", "conv2d_transpose", ins, attrs)["Output"][0].numpy()
    assert t.shape == j.shape == (1, 3, *want)
    np.testing.assert_allclose(t, j, **CONV)
