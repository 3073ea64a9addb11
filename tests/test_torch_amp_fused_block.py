"""The fuse-block program under FLAGS_amp_bf16: the port against the JAX
package on the CPU, at the fused-block tests' small widths (D = E 64,
F 128, H 4).  Inputs are made from a numpy seed and rounded to bf16 the
same way on both sides; the JAX side runs its Pallas kernels in
interpret mode, as its own tests run them.

- (a) The bf16 [B, H, T, d] flash plain forward and backward against JAX
  ``flash_attention`` (Pallas, interpret) on bf16 inputs, held as
  tests/test_torch_amp.py holds the head-major ones: each bf16 output
  within one bf16 step of its largest entry with at least 99 % of entries
  the same bits (dq: 97 %, DQ_SAME_BITS), lse at 1e-5.  Head dims whose
  scale is a power of two (XLA on the CPU keeps q * bf16(scale) in f32).
- (b) ``transformer_block_plain`` in bf16 against JAX ``block_reference``
  in bf16, within one bf16 step of max with at least 85 % of entries the
  same bits (BLOCK_SAME_BITS), with the op's inputs (f32 LN params and
  biases) and with every param bf16 (tests/test_fused_block.py:148).
- (c) The port's block against the JAX Pallas block kernel (interpret) at
  the reference's own bf16 bound, 2e-2 of max (tests/test_fused_block.py
  :148), on T 128 and a ragged T 80.
- (d) Gradients for x and all 12 params against JAX's custom VJP in bf16,
  the port taking JAX's relu branches, at 2e-2 of max.
- (e) The AMP policy of ``fused_attention`` (output f32, the input's
  dtype) and ``fused_transformer_block`` (output bf16) against the JAX
  lowerings.
- (f) 3 AMP Adam steps of the fuse_block tiny LM against JAX (the JAX
  program built with the flag off and run with it on, as
  tests/test_torch_amp.py does); tolerances beside the tests.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.core import flags as jflags
from paddle_tpu.kernels import fused_block as jfb
from paddle_tpu.models import transformer as jtr
from paddle_tpu.transpiler import fused_block as jtp
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.kernels import flash_attention as tflash
from paddle_tpu_torch.kernels import fused_block as tfb
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.ops import nn_ops as tnn
from paddle_tpu_torch.ops.fused_ops import BLOCK_SLOTS
from paddle_tpu_torch.transpiler import fused_block as ttp
from test_torch_amp import amp  # noqa: F401 (the fixture)
from test_torch_amp import (ADAM_TOL, BF16_STEP, BF16_TOL, CHANGE_TOL, F32,
                            FLIP_TOL, _adam_change, _jbf, _np, _rel_to_max,
                            _run_both, _tbf, assert_bf16_close)
from test_torch_fused_block import (D, E, F, H, LR, STEPS, build, feeds,
                                    persistables)

# the package re-exports a function under the module's name
jflash = importlib.import_module("paddle_tpu.kernels.flash_attention")

REF_BF16_TOL = 2e-2   # tests/test_fused_block.py:148, fused vs unfused
# dq's share of bit-equal entries: dq's small entries sit near rounding
# boundaries, and f32 sums of 64-128 products in another order move them
# across (97.8-99.9 % over 5 seeds of each case on the CPU, while its
# largest error stays within 7e-4 of max |dq|)
DQ_SAME_BITS = 0.97
# the block's: one rounding that goes the other way early in a token's
# row (in q, or in s through the softmax) moves every later value of the
# row, so a correct block shares 91-100 % of its entries' bits with JAX's
# (36 seeded runs of the cases here), while a product rounded to bf16 before
# its f32 epilogue (at h, u or out, as a bf16 torch.matmul would) shares
# 40-72 % and still passes one bf16 step of max
BLOCK_SAME_BITS = 0.85


# --- (a) the bf16 [B, H, T, d] flash plain versions --------------------------

# (B, H, T, d, causal, scale, layout): "bthd" hands the port [B, T, H, d]
# views of a [B, T, H*d] array, as the block's recompute does
FLASH_CASES = [
    (2, 2, 128, 64, True, None, "bhtd"),
    (2, 2, 128, 64, True, None, "bthd"),
    (1, 2, 256, 64, False, None, "bthd"),
    (2, 2, 80, 64, True, None, "bthd"),          # ragged: JAX pads to 128
    (2, 4, 128, 16, False, None, "bhtd"),
    (1, 2, 128, 128, True, 0.125, "bthd"),       # head dim 128
]


def _flash_inputs(case):
    B, Hn, T, d, causal, scale, layout = case
    rng = np.random.RandomState(B + 3 * Hn + T + d)
    arrs = [(rng.randn(B, Hn, T, d) * 2).astype("float32")
            for _ in range(4)]                              # q, k, v, do

    def port(a):
        t = _tbf(a)
        if layout == "bthd":    # the same values as a strided view
            t = t.transpose(1, 2).contiguous().transpose(1, 2)
        return t

    return arrs, [port(a) for a in arrs]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(
    str(v) for v in c))
def test_flash_bhtd_bf16_plain_matches_pallas(case):
    B, Hn, T, d, causal, scale, layout = case
    (q, k, v, do), (tq, tk, tv, tdo) = _flash_inputs(case)
    s = scale or 1.0 / np.sqrt(d)
    jq, jk, jv, jdo = map(_jbf, (q, k, v, do))
    jo, vjp = jax.vjp(lambda a, b, c: jflash.flash_attention(
        a, b, c, causal=causal, scale=scale, interpret=True), jq, jk, jv)
    jgrads = vjp(jdo)
    to, tlse = tflash.flash_attention_plain(tq, tk, tv, causal, scale)
    assert_bf16_close(to, jo, "o")
    assert tlse.dtype == torch.float32 and tuple(tlse.shape) == (B, Hn, T)
    lse = tlse
    if T % 128 == 0:    # lse from the Pallas forward itself (no padding)
        _, jlse = jflash._flash_fwd(
            jq.reshape(B * Hn, T, d), jk.reshape(B * Hn, T, d),
            jv.reshape(B * Hn, T, d), s, causal, True, None, None)
        jlse = _np(jlse).reshape(B, Hn, T)
        np.testing.assert_allclose(_np(tlse), jlse, **F32)
        lse = torch.from_numpy(np.array(jlse))
    # the backward from the Pallas forward's residuals where they are at
    # hand (its o, and its lse at unpadded T), so that the backwards are
    # compared alone; delta in f32 from do before its rounding, as
    # _Flash.backward and _flash_bwd take it
    delta = torch.sum(tdo.float() * torch.from_numpy(np.array(_np(jo))),
                      dim=-1)
    tgrads = tflash.flash_attention_bwd_plain(tq, tk, tv, lse, delta, tdo,
                                              causal, scale)
    for name, t, j in zip(("dq", "dk", "dv"), tgrads, jgrads):
        assert_bf16_close(t, j, name,
                          same=DQ_SAME_BITS if name == "dq" else 0.99)


def test_flash_bhtd_bf16_autograd_is_the_plain_backward():
    """flash_attention on bf16 [B, T, H, d] views: o bf16, and autograd's
    gradients are the plain backward's bits."""
    rng = np.random.RandomState(8)
    B, Hn, T, d = 2, 2, 40, 64
    q, k, v, do = (_tbf(rng.randn(B, T, Hn * d).astype("float32")).reshape(
        B, T, Hn, d).transpose(1, 2) for _ in range(4))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = tflash.flash_attention_bf16.launches
    o = tflash.flash_attention(*leaves, causal=True)
    assert tflash.flash_attention_bf16.launches == before   # CPU: no kernel
    assert o.dtype == torch.bfloat16
    o.backward(do)
    want_o, lse = tflash.flash_attention_plain(q, k, v, causal=True)
    assert torch.equal(o.detach(), want_o)
    delta = torch.sum(do.float() * o.detach().float(), dim=-1)
    want = tflash.flash_attention_bwd_plain(q, k, v, lse, delta, do,
                                            causal=True)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == torch.bfloat16
        assert torch.equal(leaf.grad, w)


def test_bf16_bhtd_wrappers_refuse_other_inputs():
    q = torch.zeros(1, 2, 16, 64)
    with pytest.raises(ValueError, match="bf16"):
        tflash.flash_attention_bf16(q, q, q)
    with pytest.raises(ValueError, match="bf16"):
        tflash.flash_attention_bwd_bf16(q, q, q, q[..., 0], q[..., 0], q)
    qb = q.to(torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA"):      # never the plain
        tflash.flash_attention_bf16(qb, qb, qb)
    x, p = _block_inputs(1, 8, "op")
    with pytest.raises(ValueError, match="bf16"):
        tfb.transformer_block_bf16(x.float(), p, H)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfb.transformer_block_bf16(x, p, H)


# --- (b)-(d) the bf16 block ---------------------------------------------------

BLOCK_CASES = [(2, 128, True), (2, 80, True), (1, 200, False)]


def _block_arrays(B, Tn):
    rng = np.random.RandomState(Tn + B + 1)

    def mk(*shape):
        return (rng.randn(*shape) * 0.3).astype("float32")

    x = mk(B, Tn, D)
    p = (mk(D) + 1.0, mk(D), mk(D, E), mk(D, E), mk(D, E), mk(E, D),
         mk(D) + 1.0, mk(D), mk(D, F), mk(F), mk(F, D), mk(D))
    return x, p, mk(B, Tn, D)


def _vector(a):
    return a.ndim == 1


def _block_inputs(B, Tn, params, jax_side=False):
    """bf16 x and matrices; the vectors f32 ("op": the op's AMP inputs)
    or bf16 ("bf16": tests/test_fused_block.py:148's)."""
    x, p, _ = _block_arrays(B, Tn)
    cast = _jbf if jax_side else _tbf

    def param(a):
        if _vector(a) and params == "op":
            return jnp.asarray(a) if jax_side else torch.from_numpy(a)
        return cast(a)

    return cast(x), tuple(param(a) for a in p)


@pytest.mark.parametrize("params", ["op", "bf16"])
@pytest.mark.parametrize("case", BLOCK_CASES, ids=lambda c: "-".join(
    str(v) for v in c))
def test_block_bf16_plain_matches_jax_reference(case, params):
    B, Tn, causal = case
    tx, tp = _block_inputs(B, Tn, params)
    jx, jp = _block_inputs(B, Tn, params, jax_side=True)
    out = tfb.transformer_block_plain(tx, tp, H, causal)
    assert_bf16_close(out, jfb.block_reference(jx, jp, H, causal), "out",
                      same=BLOCK_SAME_BITS)


_JAX_PALLAS = {}


def _jax_pallas(case, params):
    """The JAX Pallas block kernel (interpret) in bf16: its output and its
    custom VJP's 13 gradients under a bf16 cotangent."""
    key = case + (params,)
    if key not in _JAX_PALLAS:
        B, Tn, causal = case
        jx, jp = _block_inputs(B, Tn, params, jax_side=True)
        out, vjp = jax.vjp(
            lambda x_, *p_: jfb.transformer_block(
                x_, p_, H, causal, use_pallas=True, interpret=True), jx, *jp)
        g = _jbf(_block_arrays(B, Tn)[2])
        _JAX_PALLAS[key] = (out, vjp(g))
    return _JAX_PALLAS[key]


@pytest.mark.parametrize("params", ["op", "bf16"])
@pytest.mark.parametrize("case", [(2, 128, True), (2, 80, True)],
                         ids=lambda c: "-".join(str(v) for v in c))
def test_block_bf16_matches_the_pallas_kernel(case, params):
    B, Tn, causal = case
    tx, tp = _block_inputs(B, Tn, params)
    before = tfb.transformer_block_bf16.launches
    out = tfb.transformer_block(tx, tp, H, causal)
    assert tfb.transformer_block_bf16.launches == before   # CPU: the plain
    assert out.dtype == torch.bfloat16
    want = _np(_jax_pallas(case, params)[0])
    rel = float(np.abs(_np(out) - want).max() / np.abs(want).max())
    assert rel < REF_BF16_TOL, rel


class _RecordRelu:
    """The jax.numpy seen by paddle_tpu.kernels.fused_block, except that
    maximum (block_reference's relu, its only call there off-TPU) also
    records its first operand, the MLP's f32 pre-activation."""

    def __init__(self, pre):
        self._pre = pre

    def __getattr__(self, name):
        return getattr(jnp, name)

    def maximum(self, a, b):
        self._pre.append(np.asarray(a))
        return jnp.maximum(a, b)


# Gradients: both recompute block_reference with the same casts, but a
# pre-activation within a rounding of 0 may take the other relu branch in
# the two packages, which moves its unit's column of dW1 (and b1, and the
# gradients behind it) by that token's share: 3-13 % of max in 4 of 36
# seeded runs.  So the port takes JAX's relu branches (recorded from JAX's
# own block_reference) in its forward and recompute, and every gradient is
# held to the reference's bf16 tolerance, 2e-2 of its max |JAX| entry
# (measured without flips: at most 7e-3).
def _jax_relu_masks(x, p, causal):
    """JAX block_reference's relu masks on (x, p), recorded eagerly."""
    pre = []
    mod = jfb.jnp
    jfb.jnp = _RecordRelu(pre)
    try:
        jfb.block_reference(x, p, H, causal)
    finally:
        jfb.jnp = mod
    assert len(pre) == 1
    return torch.from_numpy((pre[0] > 0).astype("float32"))


@pytest.mark.parametrize("params", ["op", "bf16"])
@pytest.mark.parametrize("case", BLOCK_CASES, ids=lambda c: "-".join(
    str(v) for v in c))
def test_block_bf16_grads_match_jax_custom_vjp(case, params):
    from chip_smoke import block_relu
    B, Tn, causal = case
    tx, tp = _block_inputs(B, Tn, params)
    jx, jp = _block_inputs(B, Tn, params, jax_side=True)
    mask = _jax_relu_masks(jx, jp, causal)
    ins = [t.clone().requires_grad_() for t in (tx, *tp)]
    g = _tbf(_block_arrays(B, Tn)[2])
    with block_relu(masks=[mask, mask]) as left:   # forward, recompute
        grads = torch.autograd.grad(tfb.transformer_block(
            ins[0], ins[1:], H, causal), ins, g)
    assert not left
    want = _jax_pallas(case, params)[1]
    assert len(grads) == len(want) == 13
    for name, t, j in zip(("x",) + tfb.PARAM_NAMES, grads, want):
        assert _np(t).shape == _np(j).shape, name
        assert str(t.dtype)[6:] == str(j.dtype), (name, t.dtype, j.dtype)
        assert _rel_to_max(_np(t), _np(j)) <= BF16_TOL, name


def test_block_bf16_vjp_of_the_f32_masters():
    """The op casts the f32 matrices to bf16 before the block; autograd
    carries their gradients back through the casts as f32, equal to the
    bf16 gradients widened."""
    tx, tp = _block_inputs(1, 24, "op")
    masters = [t.float().requires_grad_() if not _vector(t) else
               t.clone().requires_grad_() for t in tp]
    cast = [m.to(torch.bfloat16) if m.ndim == 2 else m for m in masters]
    out = tfb.transformer_block(tx, cast, H, True)
    g = torch.ones_like(out)
    gm = torch.autograd.grad(out, masters, g)
    leaves = [c.detach().requires_grad_() for c in cast]
    gb = torch.autograd.grad(tfb.transformer_block(tx, leaves, H, True),
                             leaves, g)
    for m, a, b in zip(masters, gm, gb):
        assert a.dtype == torch.float32 == m.dtype
        assert torch.equal(a, b.float())


# --- (e) the op policy --------------------------------------------------------

def _qkv(r):
    """q, k, v [2, 40, 64]: head dims 64 (n_head 1) and 16 (n_head 4),
    whose scales are powers of two"""
    return {n: [(r.randn(2, 40, 64) * 2).astype("float32")] for n in "QKV"}


def _block_op(r):
    x, p, _ = _block_arrays(2, 40)
    return dict(X=[x], **{s: [a] for s, a in zip(BLOCK_SLOTS, p)})


# (name, op, inputs, attrs, bf16 input slots, output dtype)
POLICY_CASES = [
    ("fused_attention_f32_qkv", "fused_attention", _qkv,
     {"n_head": 1, "causal": True}, (), "float32"),
    ("fused_attention_bf16_qkv", "fused_attention", _qkv,
     {"n_head": 4, "causal": False}, ("Q", "K", "V"), "bfloat16"),
    ("fused_transformer_block_f32_x", "fused_transformer_block", _block_op,
     {"n_head": H, "causal": True}, (), "bfloat16"),
    ("fused_transformer_block_bf16_x", "fused_transformer_block", _block_op,
     {"n_head": H, "causal": True}, ("X",), "bfloat16"),
]


@pytest.mark.parametrize("case", POLICY_CASES, ids=lambda c: c[0])
def test_amp_policy_of_the_fused_ops_matches_jax(amp, case):
    """fused_attention leaves in its input's dtype (f32 for f32 q, k, v:
    JAX attention_ops.py:63), fused_transformer_block in bf16 (amp_result);
    both values within one bf16 step of max |JAX| with >= 99 % of entries
    the same bits (the block: BLOCK_SAME_BITS; the f32 output of
    fused_attention is a widened bf16)."""
    name, op, make, attrs, bf16, dtype = case
    rng = np.random.RandomState(len(name))
    jouts, touts = _run_both(op, make(rng), attrs, bf16)
    j, t = jouts["Out"][0], touts["Out"][0]
    assert str(j.dtype) == str(t.dtype)[6:] == dtype, (j.dtype, t.dtype)
    assert_bf16_close(t.to(torch.bfloat16), j.astype(jnp.bfloat16), name,
                      same=BLOCK_SAME_BITS if op == "fused_transformer_block"
                      else 0.99)


def test_without_amp_the_fused_ops_keep_f32():
    assert ptt.flags.get_flag("amp_bf16") is False
    rng = np.random.RandomState(2)
    for op, make, attrs in (("fused_attention", _qkv, {"n_head": 2}),
                            ("fused_transformer_block", _block_op,
                             {"n_head": H})):
        _, touts = _run_both(op, make(rng), attrs)
        assert touts["Out"][0].dtype == torch.float32, op


# --- (f) the AMP fuse_block training program ---------------------------------

def _jax_block_masks(jmain, state, xs):
    """JAX's relu masks of each block on the first step: its
    block_reference run eagerly on the block's input as the step saw it
    (fetched) and its first-step params, cast as the op's AMP policy
    casts them."""
    masks = []
    ops = [op for op in jmain.global_block().ops
           if op.type == "fused_transformer_block"]
    for op, x in zip(ops, xs):
        p = []
        for s in BLOCK_SLOTS:
            a = jnp.asarray(state[op.inputs[s][0]])
            p.append(a.astype(jnp.bfloat16) if a.ndim == 2 else a)
        pre = []
        mod = jfb.jnp
        jfb.jnp = _RecordRelu(pre)
        try:
            jfb.block_reference(jnp.asarray(x).astype(jnp.bfloat16), p,
                                int(op.attrs["n_head"]),
                                bool(op.attrs.get("causal", False)),
                                float(op.attrs.get("eps1", 1e-5)),
                                float(op.attrs.get("eps2", 1e-5)))
        finally:
            jfb.jnp = mod
        assert len(pre) == 1
        masks.append(torch.from_numpy((pre[0] > 0).astype("float32")))
    return masks


@pytest.fixture(scope="module")
def amp_fused_runs():
    """Both packages' 3-step fuse_block trajectories under FLAGS_amp_bf16
    from the JAX init; the port's step 1 again taking JAX's relu branches
    inside the blocks; the port's layer-norm input dtypes."""
    from chip_smoke import block_relu
    old = (jflags.get_flag("fuse_block"), tflags.get_flag("fuse_block"),
           jflags.get_flag("amp_bf16"), tflags.get_flag("amp_bf16"))
    jflags.set_flag("fuse_block", True)
    tflags.set_flag("fuse_block", True)
    try:
        main, startup, loss, grads, n = build(pt, jtr, jtp)
        assert n == 2
        jscope = pt.Scope()
        jexe = pt.Executor(pt.CPUPlace(), scope=jscope)
        jexe.run(startup)
        names = persistables(main)
        init = {k: np.asarray(jscope.find_var(k)) for k in names}
        tmain, _, tloss, tgrads, tn = build(ptt, ttr, ttp)
        assert tn == 2 and persistables(tmain) == names and tgrads == grads
        jflags.set_flag("amp_bf16", True)
        tflags.set_flag("amp_bf16", True)
        xs = [op.inputs["X"][0] for op in main.global_block().ops
              if op.type == "fused_transformer_block"]
        jax_run = {"loss": [], "step_grads": []}
        for step in range(STEPS):
            fetch = [loss] + grads + (xs if step == 0 else [])
            out = jexe.run(main, feed=feeds(step), fetch_list=fetch)
            jax_run["loss"].append(np.asarray(out[0]))
            jax_run["step_grads"].append(dict(zip(grads, map(
                np.asarray, out[1:1 + len(grads)]))))
            if step == 0:
                masks = _jax_block_masks(main, init, out[1 + len(grads):])
        jax_run["state"] = {k: np.asarray(jscope.find_var(k)) for k in names}

        seen, orig_ln = [], tnn._layer_norm_rows

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
        port_run["state"] = {k: tscope.find_var(k).numpy() for k in names}
        port_run["ln_dtypes"] = seen
        # step 1 again, the plain forward (layer order) and the backward's
        # recompute (last layer first) taking JAX's relu branches
        rscope = ptt.Scope()
        ptt.io.params_from_numpy(rscope, init, ptt.CPUPlace())
        with block_relu(masks=masks + masks[::-1]) as left:
            out = ptt.Executor(ptt.CPUPlace(), scope=rscope).run(
                tmain, feed=feeds(0), fetch_list=[tloss] + tgrads)
        assert not left
        port_run["loss_replayed"] = out[0]
        port_run["grads_replayed"] = dict(zip(tgrads, out[1:]))
    finally:
        jflags.set_flag("fuse_block", old[0])
        tflags.set_flag("fuse_block", old[1])
        jflags.set_flag("amp_bf16", old[2])
        tflags.set_flag("amp_bf16", old[3])
    return dict(jax=jax_run, port=port_run, main=main, init=init)


def test_amp_fused_losses_match_step_for_step(amp_fused_runs):
    """rtol 1e-3 per step, as test_amp_losses_match_step_for_step: the
    mean of 256 per-token losses from bf16 activations on both sides."""
    j, t = amp_fused_runs["jax"]["loss"], amp_fused_runs["port"]["loss"]
    assert len(j) == len(t) == STEPS
    for a, b in zip(t, j):
        assert a.dtype == b.dtype == np.float32 and a.shape == (1,)
        np.testing.assert_allclose(a, b, rtol=1e-3)
    assert t[-1][0] < t[0][0]
    np.testing.assert_allclose(amp_fused_runs["port"]["loss_replayed"], j[0],
                               rtol=1e-3)


def test_amp_fused_grads_match_at_step_1(amp_fused_runs):
    """Every @GRAD is f32 (the masters' dtype): within BF16_TOL (2e-2) of
    its max |JAX| entry when the port's blocks take JAX's relu branches;
    as it runs, within FLIP_TOL, as tests/test_torch_amp.py holds the
    unfused program."""
    j = amp_fused_runs["jax"]["step_grads"][0]
    t = amp_fused_runs["port"]["step_grads"][0]
    r = amp_fused_runs["port"]["grads_replayed"]
    assert sorted(j) == sorted(t) == sorted(r) and len(j) == 1 + 12 * 2 + 3
    for name in j:
        assert t[name].dtype == np.float32 and t[name].shape == j[name].shape
        assert float(np.abs(j[name]).max()) > 0, name
        assert _rel_to_max(r[name], j[name]) <= BF16_TOL, name
        assert _rel_to_max(t[name], j[name]) <= FLIP_TOL, name


def test_amp_fused_params_after_three_steps_match(amp_fused_runs):
    """Each trainable param by its change over the three steps, as
    test_amp_state_after_three_steps_matches[param] holds the unfused
    program's: the port's change is Adam's update of its own gradients
    within ADAM_TOL; it is JAX's change within CHANGE_TOL plus the gap
    between Adam's updates of the two gradient histories; each param
    moved (median |change| >= lr, within 10 % of JAX's)."""
    j, t = amp_fused_runs["jax"]["state"], amp_fused_runs["port"]["state"]
    params = amp_fused_runs["main"].all_parameters()
    for p in params:
        if not p.trainable:
            assert (t[p.name] == j[p.name]).all(), p.name
    names = sorted(p.name for p in params if p.trainable)
    assert len(names) == 1 + 12 * 2 + 3
    for n in names:
        assert t[n].dtype == j[n].dtype == np.float32, n
        init = amp_fused_runs["init"][n]
        mine, theirs = t[n] - init, j[n] - init
        adam_t = _adam_change(amp_fused_runs["port"]["step_grads"], n)
        adam_j = _adam_change(amp_fused_runs["jax"]["step_grads"], n)
        np.testing.assert_allclose(mine, adam_t, rtol=0, atol=ADAM_TOL * LR,
                                   err_msg=n)
        gap = np.abs(adam_t - adam_j)
        assert (np.abs(mine - theirs) <= CHANGE_TOL * LR + gap).all(), n
        moved = np.median(np.abs(mine))
        assert moved >= LR, (n, moved / LR)
        assert abs(moved / np.median(np.abs(theirs)) - 1) <= 0.1, n


def test_amp_fused_final_layer_norm_sees_bf16(amp_fused_runs):
    """The program's one layer_norm op (the final one; the blocks' norms
    run inside the block) takes the last block's bf16 output."""
    assert amp_fused_runs["port"]["ln_dtypes"] == [torch.bfloat16]
