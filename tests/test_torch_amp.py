"""The port under FLAGS_amp_bf16 against the JAX package under the same flag.

Inputs are made from a numpy seed and rounded to bf16 the same way on both
sides (round to nearest even).  The JAX side runs on the CPU, its Pallas
kernels in interpret mode, as its own tests run them.

- The bf16 plain kernels (flash forward and backward in the head-major
  layout, the LM head forward and backward) against the Pallas kernels on
  bf16 operands.  The two compute the same roundings with f32 sums in
  another order, so a bf16 output may round one step the other way where
  its f32 value lies near a rounding boundary: each bf16 output is held to
  one bf16 step at its largest entry (2^-7 of max |JAX|; bf16 keeps 8
  significant bits) and at least 99 % of its entries must be the same bits
  (a rounding taken at another place would move most of them).  f32
  outputs (lse, loss) are held to 1e-5 absolute: the same f32 math.
  XLA on the CPU keeps q * bf16(scale) in f32 where the Pallas kernel
  names a bf16 product (flash_attention.py:529), and the port rounds it as
  the kernel states; the cases therefore use head dims whose scale is a
  power of two (the product is exact), d 128 with scale 1/8.
- The AMP dtype policy op by op (mul, elementwise_add, layer_norm,
  fused_mha, fused_lm_head_loss) against the JAX lowerings: the same
  output dtypes, values within the bf16 tolerance stated per case.
- The AMP training program (L 2, N 256) built by both packages from one
  saved parameter set, 3 Adam steps; its tolerances are stated beside
  the test.
- The program built under the flag serializes as the JAX one does.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.framework.registry import LowerContext as JaxCtx
from paddle_tpu.framework.registry import get_op_def as jax_op
from paddle_tpu.models import transformer as jtr
from paddle_tpu_torch.framework.registry import LowerContext as TorchCtx
from paddle_tpu_torch.framework.registry import get_op_def as torch_op
from paddle_tpu_torch.kernels import flash_attention as tflash
from paddle_tpu_torch.kernels import lm_head as tlm
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.ops import nn_ops as tnn
from test_torch_train import (LR, STEPS, _op_view, _var_view, build, feeds,
                              persistables)

# the package re-exports a function under the module's name
jflash = importlib.import_module("paddle_tpu.kernels.flash_attention")
jlm = importlib.import_module("paddle_tpu.kernels.lm_head")

BF16_STEP = 2.0 ** -7   # one bf16 rounding step at the largest entry
SAME_BITS = 0.99        # share of bf16 entries that must be the same bits
F32 = dict(rtol=0, atol=1e-5)


@pytest.fixture
def amp():
    """FLAGS_amp_bf16 on in both packages for one test."""
    old = pt.core.flags.get_flag("amp_bf16"), ptt.flags.get_flag("amp_bf16")
    pt.core.flags.set_flag("amp_bf16", True)
    ptt.flags.set_flag("amp_bf16", True)
    yield
    pt.core.flags.set_flag("amp_bf16", old[0])
    ptt.flags.set_flag("amp_bf16", old[1])


def _jbf(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _tbf(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _np(a):
    """A torch tensor or a jax array as f32 numpy (bf16 widens exactly)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def assert_bf16_close(t, j, what, step=BF16_STEP, same=SAME_BITS):
    assert t.dtype == torch.bfloat16, (what, t.dtype)
    assert j.dtype == jnp.bfloat16, (what, j.dtype)
    t, j = _np(t), _np(j)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    err = float(np.abs(t - j).max())
    top = float(np.abs(j).max())
    assert err <= step * top, (what, err, top)
    assert float((t == j).mean()) >= same, (what, float((t == j).mean()))


def test_amp_flag_is_declared_off_and_takes_its_env_override(monkeypatch):
    assert ptt.flags.get_flag("amp_bf16") is False
    assert pt.core.flags.get_flag("amp_bf16") is False
    monkeypatch.setenv("PTPU_AMP_BF16", "1")
    try:
        ptt.flags.define_flag("amp_bf16", False)
        assert ptt.flags.get_flag("amp_bf16") is True
    finally:
        monkeypatch.delenv("PTPU_AMP_BF16")
        ptt.flags.define_flag("amp_bf16", False)
    assert ptt.flags.get_flag("amp_bf16") is False


# --- the bf16 plain kernels against the Pallas kernels ----------------------

# (H, d, B, Tq, Tk, causal, kv_len, scale)
FLASH_CASES = [
    (2, 64, 2, 128, 128, True, None, None),
    (2, 64, 2, 128, 128, True, 72, None),        # causal with kv_len
    (2, 64, 2, 256, 256, False, 200, None),
    (2, 16, 2, 128, 256, False, None, None),     # Tq != Tk
    (2, 128, 1, 256, 256, True, None, 0.125),    # head dim 128
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(
    str(v) for v in c))
def test_flash_bf16_plain_matches_pallas(case):
    H, d, B, Tq, Tk, causal, kv_len, scale = case
    rng = np.random.RandomState(H + d + Tq + 3 * Tk + (kv_len or 0))
    q, do = (rng.randn(H, d, B * Tq).astype("float32") * 2 for _ in range(2))
    k, v = (rng.randn(H, d, B * Tk).astype("float32") * 2 for _ in range(2))
    s = scale or 1.0 / np.sqrt(d)
    jq, jk, jv, jdo = map(_jbf, (q, k, v, do))
    jo, jlse = jflash._flash_fwd_hdt(jq, jk, jv, B, s, causal, True, None,
                                     None, kv_len)
    jgrads = jflash._flash_bwd_hdt(B, s, causal, kv_len, True,
                                   (jq, jk, jv, jo, jlse), jdo)
    # the entry point too, the way fused_mha calls it
    jo2 = jflash.flash_attention_hdt(jq, jk, jv, batch=B, causal=causal,
                                     scale=scale, kv_len=kv_len,
                                     interpret=True)
    tq, tk, tv, tdo = map(_tbf, (q, k, v, do))
    to, tlse = tflash.flash_attention_hdt_plain(
        tq, tk, tv, B, causal=causal, scale=scale, kv_len=kv_len)
    assert_bf16_close(to, jo, "o")
    assert_bf16_close(to, jo2, "o (entry)")
    assert tlse.dtype == torch.float32
    np.testing.assert_allclose(_np(tlse), _np(jlse), **F32)
    # delta in f32 from do before its rounding, as _FlashHdt.backward and
    # _flash_bwd_hdt take it
    delta = torch.sum(tdo.float() * to.float(), dim=1, keepdim=True)
    tgrads = tflash.flash_attention_hdt_bwd_plain(
        tq, tk, tv, tlse, delta, tdo, B, causal=causal, scale=scale,
        kv_len=kv_len)
    for name, t, j in zip(("dq", "dk", "dv"), tgrads, jgrads):
        assert_bf16_close(t, j, name)


def test_flash_bf16_autograd_matches_the_plain_backward():
    rng = np.random.RandomState(5)
    H, d, B, T_ = 2, 64, 2, 40
    q, k, v, do = (_tbf(rng.randn(H, d, B * T_).astype("float32"))
                   for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = tflash.flash_attention_hdt(*leaves, B, causal=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    o.backward(do)
    delta = torch.sum(do.float() * o.detach().float(), dim=1, keepdim=True)
    want = tflash.flash_attention_hdt_bwd_plain(q, k, v, lse, delta, do, B,
                                                causal=True)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == torch.bfloat16
        assert torch.equal(leaf.grad, w)


@pytest.mark.parametrize("T_,amp", [(256, 1), (65, 4)])
def test_bf16_flash_compare_refuses_a_skipped_key_tile(T_, amp):
    """chip_smoke's bf16 flash compare (tile_rel_err: of each head's
    64-token tile's max |plain|, at BF16_RTOL) passes the Pallas kernel's
    o and dq against the port's plain version, a peaked softmax (q, k x 4)
    included, and refuses those of a kernel whose last row tile skips the
    first key tile."""
    from chip_smoke import BF16_RTOL, skipped_key_tile, tile_rel_err
    rng = np.random.RandomState(11)
    H, d, B = 2, 64, 2
    q, k, v, do = (rng.randn(H, d, B * T_).astype("float32")
                   for _ in range(4))
    q, k = q * amp, k * amp
    s = 1.0 / np.sqrt(d)
    jq, jk, jv, jdo = map(_jbf, (q, k, v, do))
    jo, jlse = jflash._flash_fwd_hdt(jq, jk, jv, B, s, True, True, None,
                                     None, None)
    jdq = jflash._flash_bwd_hdt(B, s, True, None, True,
                                (jq, jk, jv, jo, jlse), jdo)[0]
    tq, tk, tv, tdo = map(_tbf, (q, k, v, do))
    o, lse = tflash.flash_attention_hdt_plain(tq, tk, tv, B, causal=True)
    delta = torch.sum(tdo.float() * o.float(), dim=1, keepdim=True)
    dq = tflash.flash_attention_hdt_bwd_plain(tq, tk, tv, lse, delta, tdo,
                                              B, causal=True)[0]
    pallas = [_tbf(np.array(_np(a))) for a in (jo, jdq)]
    assert tile_rel_err(pallas, [o, dq]) <= BF16_RTOL
    fo, fdq = skipped_key_tile(tflash, tq, tk, tv, lse, delta, tdo, B, T_)
    assert tile_rel_err([fo], [o]) > BF16_RTOL
    assert tile_rel_err([fdq], [dq]) > BF16_RTOL


# (N, D, V, chunk, ignored labels)
HEAD_CASES = [
    (256, 32, 300, 256, 5),      # V not a multiple of a vocab block
    (512, 64, 1000, 128, 17),    # four backward chunks
    (256, 16, 256, 128, 0),
]


@pytest.mark.parametrize("case", HEAD_CASES, ids=lambda c: "-".join(
    str(v) for v in c))
def test_lm_head_bf16_plain_matches_pallas(case):
    N, D, V, chunk, n_ign = case
    rng = np.random.RandomState(N + D + V)
    x = rng.randn(N, D).astype("float32")
    w = (rng.randn(D, V) * 0.2).astype("float32")
    y = rng.randint(0, V, N).astype("int64")
    y[rng.choice(N, n_ign, replace=False)] = -1
    g = (rng.rand(N) / N).astype("float32")
    jloss, vjp = jax.vjp(
        lambda a, b: jlm.lm_head_xent(a, b, jnp.asarray(y.astype("int32")),
                                      interpret=True, chunk=chunk),
        _jbf(x), _jbf(w))
    jdx, jdw = vjp(jnp.asarray(g))
    tx, tw, ty = _tbf(x), _tbf(w), torch.from_numpy(y)
    tloss, tlse = tlm.lm_head_fwd_plain(tx, tw, ty)
    assert tloss.dtype == torch.float32 and jloss.dtype == jnp.float32
    np.testing.assert_allclose(_np(tloss), _np(jloss), **F32)
    assert (_np(tloss)[y < 0] == 0).all()
    tdx, tdw = tlm.lm_head_bwd_plain(tx, tw, ty, tlse, torch.from_numpy(g),
                                     chunk)
    assert_bf16_close(tdx, jdx, "dx")
    assert_bf16_close(tdw, jdw, "dw")


def test_lm_head_bf16_rounds_dlogits_and_dw_once():
    """dx and dW of bf16 inputs are the products of bf16 dlogits, summed in
    f32 over every chunk and rounded once: the chunk size moves dW only by
    f32 sums in another order, and neither equals the unrounded f32
    composition's."""
    rng = np.random.RandomState(3)
    N, D, V = 96, 16, 50
    x = _tbf(rng.randn(N, D).astype("float32"))
    w = _tbf(rng.randn(D, V).astype("float32") * 0.3)
    y = torch.from_numpy(rng.randint(0, V, N))
    g = torch.full((N,), 1.0 / N)
    _, lse = tlm.lm_head_fwd_plain(x, w, y)
    dx1, dw1 = tlm.lm_head_bwd_plain(x, w, y, lse, g, chunk=N)
    dx3, dw3 = tlm.lm_head_bwd_plain(x, w, y, lse, g, chunk=32)
    assert torch.equal(dx1, dx3)
    assert (dw1.float() - dw3.float()).abs().max() <= 2.0 ** -7 * \
        dw1.float().abs().max()
    fx, fw = tlm.lm_head_bwd_plain(x.float(), w.float(), y, lse, g, chunk=N)
    assert not torch.equal(dx1.float(), fx.to(torch.bfloat16).float())


# --- the AMP dtype policy, op by op ------------------------------------------

def _run_both(op, ins, attrs, bf16=()):
    """The JAX and port lowerings of op on the same inputs; the slots in
    bf16 enter as bf16 on both sides."""
    jins = {k: [_jbf(a) if k in bf16 else jnp.asarray(
        a.astype(np.int32) if a.dtype == np.int64 else a) for a in v]
        for k, v in ins.items()}
    tins = {k: [_tbf(a) if k in bf16 else torch.from_numpy(
        np.ascontiguousarray(a)) for a in v] for k, v in ins.items()}
    jouts = jax_op(op).lower(JaxCtx(jax.random.PRNGKey(0)), jins, attrs)
    touts = torch_op(op).lower(TorchCtx(0, torch.device("cpu")), tins, attrs)
    return jouts, touts


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype("float32")


def _dtype_name(a):
    return str(a.dtype).replace("torch.", "")


# (name, op, inputs, attrs, bf16 input slots, {slot: dtype}, bf16 step
# allowed on the outputs).  Products: the operands round to bf16 on both
# sides and the product is rounded once, so one bf16 step; fused_mha chains
# three rounded products and the flash kernel's p, so four.
def _mha(r):
    return {"X": [_rand(r, 2, 40, 32)], "Wq": [_rand(r, 32, 32, scale=0.2)],
            "Wk": [_rand(r, 32, 32, scale=0.2)],
            "Wv": [_rand(r, 32, 32, scale=0.2)],
            "Wo": [_rand(r, 32, 32, scale=0.2)]}


POLICY_CASES = [
    ("mul_f32_x", "mul",
     lambda r: {"X": [_rand(r, 2, 5, 16)], "Y": [_rand(r, 16, 7)]},
     {"x_num_col_dims": 2}, (), {"Out": "bfloat16"}, BF16_STEP),
    ("mul_bf16_x", "mul",
     lambda r: {"X": [_rand(r, 6, 16)], "Y": [_rand(r, 16, 7)]},
     {}, ("X",), {"Out": "bfloat16"}, BF16_STEP),
    ("add_bf16_f32", "elementwise_add",
     lambda r: {"X": [_rand(r, 2, 3, 8)], "Y": [_rand(r, 8)]},
     {"axis": 2}, ("X",), {"Out": "bfloat16"}, BF16_STEP),
    ("add_f32_bf16_residual", "elementwise_add",
     lambda r: {"X": [_rand(r, 2, 3, 8)], "Y": [_rand(r, 2, 3, 8)]},
     {"axis": -1}, ("Y",), {"Out": "bfloat16"}, BF16_STEP),
    ("layer_norm_bf16_x", "layer_norm",
     lambda r: {"X": [_rand(r, 2, 5, 64) * 3 + 1], "Scale": [_rand(r, 64)],
                "Bias": [_rand(r, 64)]},
     {"begin_norm_axis": 2, "epsilon": 1e-5}, ("X",),
     {"Y": "bfloat16", "Mean": "float32", "Variance": "float32"},
     BF16_STEP),
    ("fused_mha_f32_x", "fused_mha", _mha, {"n_head": 2, "causal": True},
     (), {"Out": "bfloat16"}, 4 * BF16_STEP),
    ("fused_mha_bf16_x", "fused_mha", _mha, {"n_head": 2, "causal": True},
     ("X",), {"Out": "bfloat16"}, 4 * BF16_STEP),
    ("fused_lm_head_loss_bf16_x", "fused_lm_head_loss",
     lambda r: {"X": [_rand(r, 256, 16)], "W": [_rand(r, 16, 300) * 0.2],
                "Label": [r.randint(-1, 300, 256)]},
     {"chunk_size": 128}, ("X",), {"Loss": "float32"}, None),
    ("fused_lm_head_loss_f32_x", "fused_lm_head_loss",
     lambda r: {"X": [_rand(r, 256, 16)], "W": [_rand(r, 16, 300) * 0.2],
                "Label": [r.randint(-1, 300, 256)]},
     {"chunk_size": 128}, (), {"Loss": "float32"}, None),
]


@pytest.mark.parametrize("case", POLICY_CASES, ids=lambda c: c[0])
def test_amp_policy_matches_jax(amp, case):
    name, op, make, attrs, bf16, dtypes, step = case
    rng = np.random.RandomState(len(name) * 31 + len(op))
    jouts, touts = _run_both(op, make(rng), attrs, bf16)
    for slot, dtype in dtypes.items():
        j, t = jouts[slot][0], touts[slot][0]
        assert _dtype_name(j) == _dtype_name(t) == dtype, (slot, j.dtype,
                                                           t.dtype)
        if step is None:       # f32 outputs of bf16 products: same math
            np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5, atol=1e-5,
                                       err_msg=slot)
        elif dtype == "bfloat16":
            err = float(np.abs(_np(t) - _np(j)).max())
            assert err <= step * float(np.abs(_np(j)).max()), (slot, err)
        else:                  # layer norm's f32 stats of a bf16 x
            np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5, atol=1e-5,
                                       err_msg=slot)


def test_without_amp_the_ops_keep_f32():
    rng = np.random.RandomState(0)
    assert ptt.flags.get_flag("amp_bf16") is False
    _, touts = _run_both("mul", {"X": [_rand(rng, 4, 8)],
                                 "Y": [_rand(rng, 8, 3)]}, {})
    assert touts["Out"][0].dtype == torch.float32
    _, touts = _run_both("elementwise_add", {"X": [_rand(rng, 4, 8)],
                                             "Y": [_rand(rng, 8)]},
                         {"axis": 1}, ("X",))
    assert touts["Out"][0].dtype == torch.float32      # type promotion
    _, touts = _run_both("fused_mha", _mha(rng), {"n_head": 2,
                                                  "causal": True})
    assert touts["Out"][0].dtype == torch.float32


def test_bf16_kernel_wrappers_refuse_other_inputs():
    q = torch.zeros(2, 64, 16)
    with pytest.raises(ValueError, match="bf16"):
        tflash.flash_attention_hdt_bf16(q, q, q, 1)
    with pytest.raises(ValueError, match="bf16"):
        tflash.flash_attention_hdt_bwd_bf16(q, q, q, q[:, :1], q[:, :1], q,
                                            1)
    x = torch.zeros(4, 8)
    y = torch.zeros(4, dtype=torch.long)
    with pytest.raises(ValueError, match="bf16"):
        tlm.lm_head_fwd_bf16(x, torch.zeros(8, 5), y)
    with pytest.raises(ValueError, match="bf16"):
        tlm.lm_head_bwd_bf16(x, torch.zeros(8, 5), y, y.float(), y.float())
    # a CPU tensor never reaches a kernel
    qb = q.to(torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA"):
        tflash.flash_attention_hdt_bf16(qb, qb, qb, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.lm_head_fwd_bf16(x.to(torch.bfloat16),
                             torch.zeros(8, 5, dtype=torch.bfloat16), y)


# --- the AMP training program ------------------------------------------------

@pytest.fixture(scope="module")
def amp_runs():
    """Both packages' 3-step trajectories under FLAGS_amp_bf16 from the JAX
    initialisation, the port's layer-norm input dtypes on the first step,
    and the port's f32 loss from the same start.

    The JAX program is built with the flag off and run with it on: AMP as
    a lowering-time policy over f32 master params.  (Built under the flag,
    the JAX package declares bf16 params: test_amp_program_serializes_like_
    jax.)  The port's program is built under the flag, as bench.py builds
    the reference's flagship row."""
    main, startup, loss, grads = build(pt, jtr)
    jscope = pt.Scope()
    jexe = pt.Executor(pt.CPUPlace(), scope=jscope)
    jexe.run(startup)
    names = persistables(main)
    init = {n: np.asarray(jscope.find_var(n)) for n in names}
    old = pt.core.flags.get_flag("amp_bf16"), ptt.flags.get_flag("amp_bf16")
    pt.core.flags.set_flag("amp_bf16", True)
    ptt.flags.set_flag("amp_bf16", True)
    try:
        # the FFN relus' inputs, fetched on step 1 for the branch replay
        relu_in = [op.inputs["X"][0] for op in main.global_block().ops
                   if op.type == "relu"]
        jax_run = {"loss": [], "step_grads": []}
        for step in range(STEPS):
            fetch = [loss] + grads + (relu_in if step == 0 else [])
            out = jexe.run(main, feed=feeds(step), fetch_list=fetch)
            jax_run["loss"].append(np.asarray(out[0]))
            jax_run["step_grads"].append(dict(zip(grads, map(
                np.asarray, out[1:1 + len(grads)]))))
            if step == 0:
                masks = [torch.from_numpy((_np(a) > 0).astype("float32"))
                         for a in out[1 + len(grads):]]
        jax_run["state"] = {n: np.asarray(jscope.find_var(n)) for n in names}
        jax_run["grads"] = jax_run["step_grads"][0]

        tmain, _, tloss, tgrads = build(ptt, ttr)
        assert persistables(tmain) == names and tgrads == grads
        seen = []
        orig_ln = tnn._layer_norm_rows

        def ln_rows(x2d, *args):
            seen.append(x2d.dtype)
            return orig_ln(x2d, *args)

        tscope = ptt.Scope()
        texe = ptt.Executor(ptt.CPUPlace(), scope=tscope)
        ptt.io.params_from_numpy(tscope, init, ptt.CPUPlace())
        port_run = {"loss": [], "step_grads": []}
        for step in range(STEPS):
            tnn._layer_norm_rows = ln_rows if step == 0 else orig_ln
            try:
                out = texe.run(tmain, feed=feeds(step),
                               fetch_list=[tloss] + tgrads)
            finally:
                tnn._layer_norm_rows = orig_ln
            port_run["loss"].append(out[0])
            port_run["step_grads"].append(dict(zip(tgrads, out[1:])))
        port_run["state"] = {n: tscope.find_var(n).numpy() for n in names}
        port_run["grads"] = port_run["step_grads"][0]
        port_run["ln_dtypes"] = seen
        # step 1 again, each relu taking JAX's branch
        from chip_smoke import replayed_relu_masks
        rscope = ptt.Scope()
        ptt.io.params_from_numpy(rscope, init, ptt.CPUPlace())
        with replayed_relu_masks(masks) as left:
            out = ptt.Executor(ptt.CPUPlace(), scope=rscope).run(
                tmain, feed=feeds(0), fetch_list=tgrads)
        assert not left and len(masks) == 2
        port_run["grads_replayed"] = dict(zip(tgrads, out))
    finally:
        pt.core.flags.set_flag("amp_bf16", old[0])
        ptt.flags.set_flag("amp_bf16", old[1])
    fmain, _, floss, _ = build(ptt, ttr)
    fscope = ptt.Scope()
    ptt.io.params_from_numpy(fscope, init, ptt.CPUPlace())
    f32_loss = ptt.Executor(ptt.CPUPlace(), scope=fscope).run(
        fmain, feed=feeds(0), fetch_list=[floss])[0]
    return dict(jax=jax_run, port=port_run, main=main, startup=startup,
                init=init, f32_loss=f32_loss)


def test_amp_losses_match_step_for_step(amp_runs):
    """rtol 1e-3 per step: the mean of 256 per-token losses near log 256
    computed from bf16 activations on both sides; XLA on the CPU keeps some
    bf16 elementwise results in f32 where torch rounds them (the flash
    test's q * scale is one), which moves single activations by a bf16
    step and the mean loss by far less.  The AMP loss must also differ from
    the f32 program's (the policy is on) by less than the reference's bf16
    tolerance 2e-2."""
    j, t = amp_runs["jax"]["loss"], amp_runs["port"]["loss"]
    assert len(j) == len(t) == STEPS
    for a, b in zip(t, j):
        assert a.dtype == b.dtype == np.float32 and a.shape == (1,)
        np.testing.assert_allclose(a, b, rtol=1e-3)
    assert t[-1][0] < t[0][0]
    f32 = amp_runs["f32_loss"][0]
    assert 0 < abs(t[0][0] - f32) <= 2e-2 * abs(f32)


# Under AMP a pre-activation within a bf16 step of 0 may take the other
# relu branch in the two packages (their bf16 activations round apart where
# XLA keeps an elementwise result in f32), and that moves its unit's column
# of the FFN's first weight, and its bias, by the token's share: about 5 %
# of the largest entry in the first step, on a few units.  So the grads are
# held at the reference's bf16 tolerance, 2e-2 of each @GRAD's max |JAX|
# entry, with JAX's relu branches replayed in the port; without the replay
# every entry within FLIP_TOL, which also bounds the moments after three
# steps.
BF16_TOL = 2e-2
FLIP_TOL = 8e-2


def _rel_to_max(t, j):
    return float(np.abs(t - j).max()) / max(float(np.abs(j).max()), 1e-30)


def test_amp_grads_match_at_step_1(amp_runs):
    """Every @GRAD is f32 (the master params' dtype: autograd's cast carries
    the bf16 gradient back): within BF16_TOL of its max |JAX| entry when the
    port takes JAX's relu branches; as it runs, within FLIP_TOL."""
    j, t = amp_runs["jax"]["grads"], amp_runs["port"]["grads"]
    r = amp_runs["port"]["grads_replayed"]
    assert sorted(j) == sorted(t) == sorted(r) and len(j) == 1 + 12 * 2 + 3
    for name in j:
        assert t[name].dtype == np.float32 and t[name].shape == j[name].shape
        assert float(np.abs(j[name]).max()) > 0, name
        assert _rel_to_max(r[name], j[name]) <= BF16_TOL, name
        assert _rel_to_max(t[name], j[name]) <= FLIP_TOL, name


# Adam's update of one param after three steps, from the three gradients a
# package fetched, in f64: the recurrence of the adam op (Adam's defaults)
def _adam_change(step_grads, name, b1=0.9, b2=0.999, eps=1e-8):
    m = v = change = 0.0
    for t, grads in enumerate(step_grads, 1):
        g = grads[name + "@GRAD"].astype(np.float64)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        change = change - LR * np.sqrt(1 - b2 ** t) / (1 - b1 ** t) * m / (
            np.sqrt(v) + eps)
    return change


ADAM_TOL = 1e-3     # of lr: f32 rounding of p (ulp 1.2e-7 = 1.2e-4 lr at
                    # |p| ~ 1) over three updates
CHANGE_TOL = 5e-2   # of lr, beyond the gap the two gradient histories give


@pytest.mark.parametrize("kind", ["param", "moment1", "moment2", "pow_lr"])
def test_amp_state_after_three_steps_matches(amp_runs, kind):
    """Params, by their change over the three steps (p3 - p0):

    - the port's change is Adam's update of the port's own three gradients
      within ADAM_TOL (so every entry moved, by about lr a step, the way
      its gradients say);
    - it is JAX's change within CHANGE_TOL plus the gap between Adam's
      updates of the two packages' gradient histories.  That gap is not
      small: Adam's normalised step m / sqrt(v) after step 1 depends on the
      ratio of an entry's gradients across steps, and an entry that is
      small against its tensor's largest moves by a large relative amount
      when bf16 activations round apart (and by 2 lr a step where its sign
      flips).  With the gap, every entry holds; where the gap is under
      0.01 lr, every entry is within CHANGE_TOL of JAX's;
    - each param moved: the median |change| at least lr, within 10 % of
      JAX's.

    The gradient histories are held to JAX by the step-1 @GRAD test and the
    moments here.  Moments: within FLIP_TOL of their max entry (sums of the
    gradients, relu flips included).  Beta pows and lr: exact math."""
    j, t = amp_runs["jax"]["state"], amp_runs["port"]["state"]
    params = amp_runs["main"].all_parameters()
    if kind == "param":
        names = sorted(p.name for p in params if p.trainable)
        for p in params:            # the position table is not trained
            if not p.trainable:
                assert (t[p.name] == j[p.name]).all(), p.name
    else:
        suffix = {"moment1": (".moment1",), "moment2": (".moment2",),
                  "pow_lr": ("_pow", ".lr")}[kind]
        names = [n for n in j if n.endswith(suffix)]
    assert names
    for n in names:
        assert t[n].dtype == j[n].dtype == np.float32, n
        if kind == "param":
            init = amp_runs["init"][n]
            mine, theirs = t[n] - init, j[n] - init
            adam_t = _adam_change(amp_runs["port"]["step_grads"], n)
            adam_j = _adam_change(amp_runs["jax"]["step_grads"], n)
            np.testing.assert_allclose(mine, adam_t, rtol=0,
                                       atol=ADAM_TOL * LR, err_msg=n)
            gap = np.abs(adam_t - adam_j)
            assert (np.abs(mine - theirs) <= CHANGE_TOL * LR + gap).all(), n
            moved = np.median(np.abs(mine))
            assert moved >= LR, (n, moved / LR)
            assert abs(moved / np.median(np.abs(theirs)) - 1) <= 0.1, n
        elif kind == "pow_lr":
            np.testing.assert_allclose(t[n], j[n], rtol=1e-6, err_msg=n)
        else:
            assert _rel_to_max(t[n], j[n]) <= FLIP_TOL, n


def test_amp_layer_norms_see_bf16_after_the_first(amp_runs):
    """13 layer norms a step: the first normalises the f32 embedding sum;
    every later one a residual sum that the AMP add rule keeps bf16."""
    seen = amp_runs["port"]["ln_dtypes"]
    assert seen == [torch.float32] + [torch.bfloat16] * 4, seen   # L 2


def test_amp_program_serializes_like_jax(amp_runs, amp):
    """AMP is lowering-time only in the port: the program it builds under
    the flag is the one the JAX package builds without it, op for op and
    var for var, the declared dtypes included (all f32), and its op set is
    slice 2's.  The JAX package's own build under the flag has the same ops
    but declares every parameter made after the first bf16 activation, and
    its Adam state, bf16 (its eval_shape runs the AMP lowerings): ROADMAP
    queue C."""
    main, startup, _, _ = build(ptt, ttr)
    for mine, theirs in ((main, amp_runs["main"]),
                         (startup, amp_runs["startup"])):
        assert _op_view(mine) == _op_view(theirs)
        assert _var_view(mine) == _var_view(theirs)
        for v in theirs.list_vars():
            if v.dtype.startswith("float"):
                assert mine.global_block().var(v.name).dtype == v.dtype, \
                    v.name
    assert {op.type for op in main.global_block().ops} == {
        "lookup_table", "scale", "unsqueeze", "elementwise_add",
        "layer_norm", "fused_mha", "mul", "relu", "reshape",
        "fused_lm_head_loss", "autodiff", "adam"}
    assert all(p.dtype == "float32" for p in main.all_parameters())
    jmain, _, _, _ = build(pt, jtr)
    assert _op_view(jmain) == _op_view(main)
    bf16 = [p.name for p in jmain.all_parameters() if p.dtype == "bfloat16"]
    assert bf16 and "src_word_emb" not in bf16
