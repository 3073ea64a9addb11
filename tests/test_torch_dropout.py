"""The dropout op, ``layers.dropout`` and the LM builds that use it, in the
port against the JAX package.

torch's Philox cannot draw JAX's threefry bits, so dropout in training is
held by its distribution: the keep share of 200,000 entries within 6
binomial standard deviations of 1 - p (6.7e-4 at p 0.1), ``Out`` equal to
``X * Mask / (1 - p)`` (upscale_in_train) or ``X * Mask``
(downgrade_in_infer) exactly, and one ``seed`` attr giving one mask.  At
``is_test`` and at rate 0 it is exact against JAX
(``tests/test_torch_ops.py``'s CASES).  The unfused LM (V 256, L 2, H 4,
d_model 64, d_inner 128, T 32, batch 2) with dropout 0.1 must serialize
like the JAX build, and train; at dropout 0 it takes 3 Adam steps from
the JAX initialisation at ``tests/test_torch_train.py``'s tolerances
(loss rtol 1e-5; every @GRAD of step 1 rtol 1e-4, atol 1e-6): its
backward runs through matmul, softmax, transpose and split.
"""
import json

import jax
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
from paddle_tpu_torch.models import transformer as ttr

T, BATCH, STEPS, LR = 32, 2, 3, 1e-3
P = 0.1
SHAPE = (500, 400)
KEEP_SIGMA = float(np.sqrt(P * (1 - P) / np.prod(SHAPE)))


def _drop(x, attrs, seed=0):
    ctx = TorchCtx(seed, torch.device("cpu"))
    outs = torch_op("dropout").lower(ctx, {"X": [x]}, attrs)
    return outs["Out"][0], outs["Mask"][0]


@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
def test_dropout_keeps_its_share_and_scales_exactly(impl):
    x = torch.from_numpy(np.random.RandomState(0).randn(*SHAPE)
                         .astype("float32"))
    attrs = {"dropout_prob": P, "is_test": False,
             "dropout_implementation": impl}
    out, mask = _drop(x, attrs)
    assert mask.dtype == torch.uint8 and out.dtype == x.dtype
    assert set(mask.unique().tolist()) == {0, 1}
    share = mask.double().mean().item()
    assert abs(share - (1 - P)) < 6 * KEEP_SIGMA, share
    want = x * mask / (1 - P) if impl == "upscale_in_train" else x * mask
    assert torch.equal(out, want)
    # JAX's draw: the same distribution, other bits
    jouts = jax_op("dropout").lower(JaxCtx(jax.random.PRNGKey(0)),
                                    {"X": [x.numpy()]}, attrs)
    jmask = np.asarray(jouts["Mask"][0])
    assert jmask.dtype == np.uint8
    assert abs(jmask.mean() - (1 - P)) < 6 * KEEP_SIGMA
    assert not np.array_equal(jmask, mask.numpy())


def test_dropout_seed_attr_gives_one_mask():
    x = torch.ones(64, 64)
    attrs = {"dropout_prob": 0.5, "is_test": False}
    seeded = dict(attrs, seed=1234)
    a, b = _drop(x, seeded, seed=1)[1], _drop(x, seeded, seed=2)[1]
    assert torch.equal(a, b)
    c, d = _drop(x, attrs, seed=1)[1], _drop(x, attrs, seed=2)[1]
    assert not torch.equal(c, d)
    assert torch.equal(c, _drop(x, attrs, seed=1)[1])
    assert not torch.equal(a, _drop(x, dict(attrs, seed=99), seed=1)[1])


def test_dropout_backward_is_the_mask_scaled():
    x = torch.randn(200, 50, requires_grad=True)
    out, mask = _drop(x, {"dropout_prob": P, "is_test": False,
                          "dropout_implementation": "upscale_in_train"})
    g, = torch.autograd.grad(out.sum(), x)
    assert torch.equal(g, mask.float() / (1 - P))


def test_dropout_draws_nothing_on_meta():
    ctx = TorchCtx(0, torch.device("meta"))
    x = torch.empty(3, 5, device="meta")
    outs = torch_op("dropout").lower(ctx, {"X": [x]}, {"dropout_prob": P})
    assert outs["Out"][0].shape == (3, 5)
    assert outs["Mask"][0].dtype == torch.uint8


def tiny_cfg(mod, dropout):
    return mod.TransformerConfig(src_vocab_size=256, max_length=T,
                                 n_layer=2, n_head=4, d_model=64,
                                 d_inner=128, dropout=dropout)


def build(pkg, tr, dropout):
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 17
    with pkg.program_guard(main, startup):
        _, loss, _ = tr.build_lm_net(tiny_cfg(tr, dropout), T,
                                     fused_attention=False, fused_head=True)
        _, pg = pkg.optimizer.Adam(learning_rate=LR).minimize(loss)
    return main, startup, loss, [g.name for _, g in pg]


def feeds(step):
    return ttr.make_fake_lm_batch(tiny_cfg(ttr, 0.0), BATCH, T,
                                  seed=500 + step)


@pytest.fixture(autouse=True)
def fresh_port_programs():
    ptt.reset_default_programs()
    yield
    ptt.reset_default_programs()


def _op_view(prog):
    return [(op.type, op.inputs, op.outputs,
             json.loads(json.dumps(op.to_dict()["attrs"])))
            for op in prog.global_block().ops]


def _var_view(prog):
    return {v.name: (tuple(v.shape or ()), v.persistable, v.stop_gradient,
                     type(v).__name__) for v in prog.list_vars()}


def test_unfused_dropout_training_program_serializes_like_jax():
    jmain, jstartup, _, _ = build(pt, jtr, P)
    tmain, tstartup, _, _ = build(ptt, ttr, P)
    for mine, theirs in ((tmain, jmain), (tstartup, jstartup)):
        assert _op_view(mine) == _op_view(theirs)
        assert _var_view(mine) == _var_view(theirs)
    for v in jmain.list_vars():
        if v.dtype.startswith("float") or v.dtype in ("bool", "uint8"):
            assert tmain.global_block().var(v.name).dtype == v.dtype, v.name
    types = [op.type for op in tmain.global_block().ops]
    assert types.count("dropout") == 1 + 4 * 2


@pytest.fixture(scope="module")
def unfused_runs():
    """Both packages' unfused LM at dropout 0, 3 steps from the JAX
    initialisation."""
    main, startup, loss, grads = build(pt, jtr, 0.0)
    jscope = pt.Scope()
    jexe = pt.Executor(pt.CPUPlace(), scope=jscope)
    jexe.run(startup)
    init = {v.name: np.asarray(jscope.find_var(v.name))
            for v in main.list_vars() if v.persistable}
    jl, jg = [], None
    for step in range(STEPS):
        out = jexe.run(main, feed=feeds(step), fetch_list=[loss] + grads)
        jl.append(np.asarray(out[0]))
        jg = jg or dict(zip(grads, map(np.asarray, out[1:])))
    tmain, _, tloss, tgrads = build(ptt, ttr, 0.0)
    assert tgrads == grads
    tscope = ptt.Scope()
    texe = ptt.Executor(ptt.CPUPlace(), scope=tscope)
    ptt.io.params_from_numpy(tscope, init, ptt.CPUPlace())
    tl, tg = [], None
    for step in range(STEPS):
        out = texe.run(tmain, feed=feeds(step), fetch_list=[tloss] + tgrads)
        tl.append(out[0])
        tg = tg or dict(zip(tgrads, out[1:]))
    return dict(jax_loss=jl, port_loss=tl, jax_grads=jg, port_grads=tg,
                main=tmain)


def test_unfused_build_trains_like_jax_losses(unfused_runs):
    j, t = unfused_runs["jax_loss"], unfused_runs["port_loss"]
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    assert t[-1][0] < t[0][0]


def test_unfused_build_trains_like_jax_grads(unfused_runs):
    """Every @GRAD of step 1: the backward of matmul, softmax, transpose,
    split, the causal bias's elementwise_add and the relu fc layers."""
    j, t = unfused_runs["jax_grads"], unfused_runs["port_grads"]
    ops = {op.type for op in unfused_runs["main"].global_block().ops}
    assert {"matmul", "softmax", "transpose", "split"} <= ops
    assert sorted(j) == sorted(t) and len(j) == 1 + 2 * 10 + 2 + 1
    for name in j:
        np.testing.assert_allclose(t[name], j[name], rtol=1e-4, atol=1e-6,
                                   err_msg=name)
        assert np.abs(t[name]).max() > 0, name


def test_unfused_build_trains_with_dropout():
    main, startup, loss, _ = build(ptt, ttr, P)
    main.random_seed = None        # each run draws new masks
    exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    exe.run(startup)
    losses = [exe.run(main, feed=feeds(0), fetch_list=[loss])[0][0]
              for _ in range(8)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    # at is_test (the for_test clone) the same weights give one answer
    test = main.clone(for_test=True).prune(["tokens", "labels"],
                                           [loss.name])
    a, = exe.run(test, feed=feeds(1), fetch_list=[loss])
    b, = exe.run(test, feed=feeds(1), fetch_list=[loss])
    np.testing.assert_array_equal(a, b)
