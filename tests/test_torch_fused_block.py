"""The fuse-block slice: the fused transformer block, its transpiler, and
the flagship LM trained with ``FLAGS_fuse_block`` through both packages.

- Kernel level: the port's ``transformer_block_plain`` and
  ``transformer_block`` (value, and gradients for x and all 12 params)
  against the JAX Pallas block kernel in interpret mode and its custom VJP,
  on the cases of tests/test_fused_block.py:120 (ragged T 80 and 200
  included).  Tolerance 1e-4 abs, the JAX test's own, on the output; the
  gradients reach 10-280 here (one f32 ulp is 1e-6 to 3e-5 there), so they
  are held to 1e-4 of max(1, their largest entry).
- The transpiler: on a tiny LM (V 256, L 2, H 4, d_model 64, d_inner 128,
  T 128) both packages fuse 2 blocks and, after ``Adam.minimize``,
  serialize alike; foreign ops and external consumers keep a block
  unfused; ``maybe_fuse`` is flag-gated.
- The slice: from the JAX init and Adam state (``io.params_from_numpy``),
  3 Adam steps with fuse_block on in both packages, held to
  tests/test_torch_train.py's tolerances, with one addition: a param entry
  whose step-1 gradient is below the gradients' atol (1e-6; f32 residue of
  sums that cancel to 1e-5 of the max) has no relative bound on its
  gradient, and Adam divides by sqrt(v) + 1e-8, so its update follows that
  residue: those entries (the unused embedding rows and a few dozen
  weights) are held to 1e-5 instead of 2e-6.  The port's fused losses equal
  its unfused losses to rtol 1e-4, as tests/test_fused_block.py:70 holds
  JAX's.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import layers as jlayers
from paddle_tpu.core import flags as jflags
from paddle_tpu.kernels import fused_block as jfb
from paddle_tpu.models import transformer as jtr
from paddle_tpu.transpiler import fused_block as jtp
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.framework.registry import LowerContext
from paddle_tpu_torch.framework.registry import get_op_def
from paddle_tpu_torch.kernels import fused_block as tfb
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.ops.fused_ops import BLOCK_SLOTS
from paddle_tpu_torch.transpiler import fused_block as ttp

BLOCK_TOL = 1e-4
D, E, F, H = 64, 64, 128, 4
BLOCK_CASES = [(2, 128, True), (2, 80, True), (1, 200, False)]
T, BATCH, STEPS, LR = 128, 2, 3, 1e-3


def _block_inputs(B, Tn):
    rng = np.random.RandomState(Tn + B)

    def mk(*shape):
        return (rng.randn(*shape) * 0.3).astype("float32")

    x = mk(B, Tn, D)
    p = (mk(D) + 1.0, mk(D), mk(D, E), mk(D, E), mk(D, E), mk(E, D),
         mk(D) + 1.0, mk(D), mk(D, F), mk(F), mk(F, D), mk(D))
    g = mk(B, Tn, D)
    return x, p, g


_JAX_BLOCK = {}


def _jax_block(case):
    """The JAX Pallas kernel (interpret mode): its output and its custom
    VJP's gradients for x and the 12 params under cotangent g."""
    if case not in _JAX_BLOCK:
        B, Tn, causal = case
        x, p, g = _block_inputs(B, Tn)
        out, vjp = jax.vjp(
            lambda x_, *p_: jfb.transformer_block(
                x_, p_, H, causal, use_pallas=True, interpret=True),
            jnp.asarray(x), *map(jnp.asarray, p))
        _JAX_BLOCK[case] = (np.asarray(out),
                            [np.asarray(a) for a in vjp(jnp.asarray(g))])
    return _JAX_BLOCK[case]


@pytest.mark.parametrize("entry", ["plain", "transformer_block"])
@pytest.mark.parametrize("case", BLOCK_CASES, ids=lambda c: "-".join(
    str(v) for v in c))
def test_block_forward_matches_jax_pallas(case, entry):
    B, Tn, causal = case
    x, p, _ = _block_inputs(B, Tn)
    fn = (tfb.transformer_block_plain if entry == "plain"
          else tfb.transformer_block)
    n = tfb.transformer_block.launches
    out = fn(torch.from_numpy(x), tuple(map(torch.from_numpy, p)), H, causal)
    assert tfb.transformer_block.launches == n     # CPU: no kernel
    want, _ = _jax_block(case)
    assert out.shape == want.shape
    assert np.abs(out.numpy() - want).max() < BLOCK_TOL


@pytest.mark.parametrize("case", BLOCK_CASES, ids=lambda c: "-".join(
    str(v) for v in c))
def test_block_grads_match_jax_custom_vjp(case):
    B, Tn, causal = case
    x, p, g = _block_inputs(B, Tn)
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, *p)]
    out = tfb.transformer_block(ins[0], tuple(ins[1:]), H, causal)
    grads = torch.autograd.grad(out, ins, torch.from_numpy(g))
    _, want = _jax_block(case)
    assert len(grads) == len(want) == 13
    for name, a, w in zip(("x",) + tfb.PARAM_NAMES, grads, want):
        assert a.shape == w.shape, name
        err = np.abs(a.numpy() - w).max()
        assert err < BLOCK_TOL * max(1.0, np.abs(w).max()), (name, err)


def test_block_backward_is_the_reference_vjp_f64():
    """The Function's recompute backward against autograd through the
    composition, and against finite differences, in f64."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(1, 6, 8) * 0.5).requires_grad_()
    p = [torch.from_numpy(rng.randn(*s) * 0.5).requires_grad_()
         for s in ((8,), (8,), (8, 8), (8, 8), (8, 8), (8, 8), (8,), (8,),
                   (8, 12), (12,), (12, 8), (8,))]

    def fused(x_, *p_):
        return tfb.transformer_block(x_, p_, 2, True)

    assert torch.autograd.gradcheck(fused, (x, *p))
    cot = torch.from_numpy(rng.randn(1, 6, 8))
    got = torch.autograd.grad(fused(x, *p), (x, *p), cot)
    want = torch.autograd.grad(tfb.block_reference(x, p, 2, True),
                               (x, *p), cot)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-12)


def test_fused_op_lowers_on_meta_and_cpu():
    x, p, _ = _block_inputs(2, 40)
    attrs = {"n_head": H, "causal": True, "eps1": 1e-5, "eps2": 1e-5}
    op = get_op_def("fused_transformer_block")
    meta = {"X": [torch.empty(97, 40, D, device="meta")]}
    meta.update({s: [torch.empty(a.shape, device="meta")]
                 for s, a in zip(BLOCK_SLOTS, p)})
    out, = op.lower(LowerContext(0, torch.device("meta")), meta,
                    attrs)["Out"]
    assert out.device.type == "meta" and tuple(out.shape) == (97, 40, D)
    ins = {"X": [torch.from_numpy(x)]}
    ins.update({s: [torch.from_numpy(a)] for s, a in zip(BLOCK_SLOTS, p)})
    got, = op.lower(LowerContext(0, torch.device("cpu")), ins, attrs)["Out"]
    want = tfb.transformer_block_plain(torch.from_numpy(x),
                                       tuple(map(torch.from_numpy, p)), H,
                                       True)
    assert torch.equal(got, want)


def test_block_launch_without_a_card_raises():
    x, p, _ = _block_inputs(1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfb._launch(torch.from_numpy(x), tuple(map(torch.from_numpy, p)), H,
                    True, 1e-5, 1e-5)


# --- the transpiler ---------------------------------------------------------

def tiny_cfg(mod):
    return mod.TransformerConfig(src_vocab_size=256, max_length=128,
                                 n_layer=2, n_head=4, d_model=64,
                                 d_inner=128, dropout=0.0)


@pytest.fixture
def fuse_block_on():
    """FLAGS_fuse_block on in both packages for one test."""
    old = (jflags.get_flag("fuse_block"), tflags.get_flag("fuse_block"))
    jflags.set_flag("fuse_block", True)
    tflags.set_flag("fuse_block", True)
    yield
    jflags.set_flag("fuse_block", old[0])
    tflags.set_flag("fuse_block", old[1])


@pytest.fixture(autouse=True)
def fresh_port_programs():
    ptt.reset_default_programs()
    yield
    ptt.reset_default_programs()


def build(pkg, tr, tp, seed=7):
    """The tiny LM's training program with maybe_fuse before minimize, as
    bench.py's _bench_lm_cfg builds it: (main, startup, loss, grad names,
    blocks fused)."""
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup):
        _, loss, _ = tr.build_lm_net(tiny_cfg(tr), T, fused_attention=True,
                                     fused_head=True)
        n = tp.maybe_fuse(main)
        _, pg = pkg.optimizer.Adam(learning_rate=LR).minimize(loss)
    return main, startup, loss, [g.name for _, g in pg], n


def _op_view(prog):
    return [(op.type, op.inputs, op.outputs,
             json.loads(json.dumps(op.to_dict()["attrs"])))
            for op in prog.global_block().ops]


def _var_view(prog):
    return {v.name: (tuple(v.shape or ()), v.persistable, v.stop_gradient,
                     type(v).__name__) for v in prog.list_vars()}


def test_fused_training_program_serializes_like_jax(fuse_block_on):
    jmain, jstart, _, _, jn = build(pt, jtr, jtp)
    tmain, tstart, _, _, tn = build(ptt, ttr, ttp)
    assert jn == tn == 2
    for mine, theirs in ((tmain, jmain), (tstart, jstart)):
        assert _op_view(mine) == _op_view(theirs)
        assert _var_view(mine) == _var_view(theirs)
    assert ({p.name: tuple(p.shape) for p in tmain.all_parameters()}
            == {p.name: tuple(p.shape) for p in jmain.all_parameters()})
    types = [op.type for op in tmain.global_block().ops]
    assert types.count("fused_transformer_block") == 2
    assert not {"fused_mha", "relu", "mul"} & set(types)
    d = json.loads(json.dumps(jmain.to_dict()))
    assert json.loads(json.dumps(
        ptt.Program.from_dict(d).to_dict())) == d


def test_fuse_block_skips_foreign_ops_and_external_consumers():
    # a foreign op inside the would-be window (a scale between attention
    # and its residual, the slot dropout occupies at rate > 0): no fusion
    main = ptt.Program()
    with ptt.program_guard(main, ptt.Program()):
        x = tlayers.data("x", [12, 16], dtype="float32")
        ln1 = tlayers.layer_norm(x, begin_norm_axis=2)
        attn = tlayers.fused_mha(ln1, 2, causal=True)
        attn = tlayers.scale(attn, scale=1.0)
        res1 = tlayers.elementwise_add(attn, x)
        ln2 = tlayers.layer_norm(res1, begin_norm_axis=2)
        ffn = tlayers.fc(tlayers.fc(ln2, size=32, num_flatten_dims=2,
                                    act="relu"), size=16, num_flatten_dims=2)
        tlayers.elementwise_add(ffn, res1)
    assert ttp.FuseBlockTranspiler().transpile(main) == 0

    # an intermediate consumed OUTSIDE the block keeps it unfused
    ptt.reset_default_programs()
    main = ptt.Program()
    with ptt.program_guard(main, ptt.Program()):
        tokens = tlayers.data("tokens", [16], dtype="int64")
        x = ttr.prepare_embedding(tokens, 100, 16, 32, 0.0, name="src")
        ttr.encoder_layer(x, None, 2, 8, 8, 16, 32, 0.0, causal=True,
                          fused=True)
        block = main.global_block()
        mha_out = [op for op in block.ops if op.type == "fused_mha"
                   ][0].outputs["Out"][0]
        assert ttp.FuseBlockTranspiler().transpile(main.clone()) == 1
        tlayers.mean(block.var(mha_out))
    assert ttp.FuseBlockTranspiler().transpile(main) == 0


def test_maybe_fuse_is_flag_gated():
    main = ptt.Program()
    with ptt.program_guard(main, ptt.Program()):
        ttr.build_lm_net(tiny_cfg(ttr), 32, fused_attention=True,
                         fused_head=True)
    assert not tflags.get_flag("fuse_block")
    assert ttp.maybe_fuse(main) == 0                    # flag off
    assert "fused_transformer_block" not in [
        op.type for op in main.global_block().ops]
    tflags.set_flag("fuse_block", True)
    try:
        assert ttp.maybe_fuse(main) == 2
    finally:
        tflags.set_flag("fuse_block", False)


def test_fused_attention_layer_appends_the_jax_op():
    def prog(pkg, lyr):
        pkg.reset_default_programs()
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            q, k, v = (lyr.data(n, [24, 32], dtype="float32")
                       for n in "qkv")
            out = lyr.fused_attention_qkv(q, k, v, n_head=4, causal=True)
        assert tuple(out.shape) == (-1, 24, 32)
        return main

    assert _op_view(prog(ptt, tlayers)) == _op_view(prog(pt, jlayers))


# --- the slice: 3 Adam steps with fuse_block on ------------------------------

def feeds(step):
    return ttr.make_fake_lm_batch(tiny_cfg(ttr), BATCH, T, seed=100 + step)


def persistables(prog):
    return sorted(v.name for v in prog.list_vars() if v.persistable)


def _train(pkg, exe, scope_get, main, loss, grads):
    run = {"loss": [], "grads": None}
    for step in range(STEPS):
        out = exe.run(main, feed=feeds(step), fetch_list=[loss] + grads)
        run["loss"].append(np.asarray(out[0]))
        if step == 0:
            run["grads"] = dict(zip(grads, map(np.asarray, out[1:])))
    run["state"] = {n: scope_get(n) for n in persistables(main)}
    return run


@pytest.fixture(scope="module")
def runs():
    """Both packages' 3-step fused trajectories from the JAX init, and the
    port's unfused one from the same init."""
    old = (jflags.get_flag("fuse_block"), tflags.get_flag("fuse_block"))
    jflags.set_flag("fuse_block", True)
    tflags.set_flag("fuse_block", True)
    try:
        main, startup, loss, grads, _ = build(pt, jtr, jtp)
        jscope = pt.Scope()
        jexe = pt.Executor(pt.CPUPlace(), scope=jscope)
        jexe.run(startup)
        init = {n: np.asarray(jscope.find_var(n))
                for n in persistables(main)}
        jax_run = _train(pt, jexe, lambda n: np.asarray(jscope.find_var(n)),
                         main, loss, grads)
        tmain, _, tloss, tgrads, _ = build(ptt, ttr, ttp)
    finally:
        jflags.set_flag("fuse_block", old[0])
        tflags.set_flag("fuse_block", old[1])
    assert persistables(tmain) == persistables(main) and tgrads == grads

    def port(prog, loss_var):
        scope = ptt.Scope()
        exe = ptt.Executor(ptt.CPUPlace(), scope=scope)
        ptt.io.params_from_numpy(scope, init, ptt.CPUPlace())
        return _train(ptt, exe, lambda n: scope.find_var(n).numpy(), prog,
                      loss_var, tgrads)

    umain, _, uloss, ugrads, n = build(ptt, ttr, ttp)   # flag off now
    assert n == 0 and ugrads == tgrads
    return dict(jax=jax_run, port=port(tmain, tloss),
                unfused=port(umain, uloss), main=main, init=init)


def test_fused_losses_match_jax_step_for_step(runs):
    j, t = runs["jax"]["loss"], runs["port"]["loss"]
    assert len(j) == len(t) == STEPS
    for a, b in zip(t, j):
        assert a.shape == b.shape == (1,)
        np.testing.assert_allclose(a, b, rtol=1e-5)
    assert t[-1][0] < t[0][0]


def test_fused_losses_match_the_unfused_program(runs):
    np.testing.assert_allclose(np.concatenate(runs["port"]["loss"]),
                               np.concatenate(runs["unfused"]["loss"]),
                               rtol=1e-4)


def test_every_fused_grad_matches_jax_at_step_1(runs):
    j, t = runs["jax"]["grads"], runs["port"]["grads"]
    assert sorted(j) == sorted(t) and len(j) == 1 + 12 * 2 + 2 + 1
    for name in j:
        assert t[name].shape == j[name].shape, name
        np.testing.assert_allclose(t[name], j[name], rtol=1e-4, atol=1e-6,
                                   err_msg=name)
        assert np.abs(t[name]).max() > 0, name


@pytest.mark.parametrize("kind", ["param", "moment1", "moment2", "pow_lr"])
def test_fused_state_after_three_steps_matches_jax(runs, kind):
    j, t = runs["jax"]["state"], runs["port"]["state"]
    params = {p.name for p in runs["main"].all_parameters()}
    if kind == "param":
        names, tol = sorted(params), dict(rtol=0, atol=2e-6)
    elif kind == "moment1":
        names, tol = [n for n in j if n.endswith(".moment1")], dict(
            rtol=1e-4, atol=1e-7)
    elif kind == "moment2":
        names, tol = [n for n in j if n.endswith(".moment2")], dict(
            rtol=2e-4, atol=1e-10)
    else:
        names, tol = [n for n in j if n.endswith("_pow")
                      or n.endswith(".lr")], dict(rtol=1e-6)
    assert names
    for n in names:
        assert t[n].shape == j[n].shape, n
        if kind == "param" and n + "@GRAD" in runs["jax"]["grads"]:
            g = np.minimum(np.abs(runs["jax"]["grads"][n + "@GRAD"]),
                           np.abs(runs["port"]["grads"][n + "@GRAD"]))
            residue = g < 1e-6
            np.testing.assert_allclose(t[n][residue], j[n][residue],
                                       rtol=0, atol=1e-5, err_msg=n)
            np.testing.assert_allclose(t[n][~residue], j[n][~residue],
                                       err_msg=n, **tol)
        else:
            np.testing.assert_allclose(t[n], j[n], err_msg=n, **tol)
    if kind == "param":
        moved = [n for n in names if not np.array_equal(
            t[n], runs["init"][n])]
        assert sorted(moved) == sorted(
            p.name for p in runs["main"].all_parameters() if p.trainable)
