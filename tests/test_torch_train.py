"""The training slice end to end: the flagship LM's training program
(``build_lm_net(fused_head=True)`` + ``optimizer.Adam.minimize``) through
both packages, from the same weights.

A tiny LM (V 256, L 2, H 4, d_model 64, d_inner 128, T 128, batch 2, so
N = 256 tokens and the JAX package's Pallas LM head runs, in interpret
mode) is built and initialised in paddle_tpu on the CPU.  Its parameters
and its whole Adam state (moments, beta pows, the lr var) are carried into
the port with ``io.params_from_numpy``; both then take 3 Adam steps on the
same feeds.  Tolerances, each the same f32 math summed in another order:

- loss per step: rtol 1e-5 (a mean of 256 per-token losses near log 256);
- every ``@GRAD`` at step 1: rtol 1e-4, atol 1e-6 (sums of products over
  256 tokens; atol for entries that nearly cancel);
- params after step 3: atol 2e-6 (lr 1e-3 times Adam's m / sqrt(v), whose
  relative error follows the grads' 1e-4; |param| <= 1);
- moment1 after step 3: rtol 1e-4, atol 1e-7; moment2: rtol 2e-4,
  atol 1e-10 (squares of the grads); beta pows and lr: exact math, rtol
  1e-6.
"""
import json

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import transformer as jtr
from paddle_tpu_torch.models import transformer as ttr

T, BATCH, STEPS, LR = 128, 2, 3, 1e-3


def tiny_cfg(mod):
    return mod.TransformerConfig(src_vocab_size=256, max_length=128,
                                 n_layer=2, n_head=4, d_model=64,
                                 d_inner=128, dropout=0.0)


def build(pkg, tr):
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.program_guard(main, startup):
        _, loss, logits = tr.build_lm_net(tiny_cfg(tr), T,
                                          fused_attention=True,
                                          fused_head=True)
        _, param_grads = pkg.optimizer.Adam(
            learning_rate=LR).minimize(loss)
    assert logits is None
    return main, startup, loss, [g.name for _, g in param_grads]


def feeds(step):
    return ttr.make_fake_lm_batch(tiny_cfg(ttr), BATCH, T, seed=100 + step)


def persistables(prog):
    return sorted(v.name for v in prog.list_vars() if v.persistable)


@pytest.fixture(autouse=True)
def fresh_port_programs():
    ptt.reset_default_programs()
    yield
    ptt.reset_default_programs()


@pytest.fixture(scope="module")
def runs():
    """Both packages' 3-step trajectories from the JAX initialisation."""
    main, startup, loss, grads = build(pt, jtr)
    jscope = pt.Scope()
    jexe = pt.Executor(pt.CPUPlace(), scope=jscope)
    jexe.run(startup)
    names = persistables(main)
    init = {n: np.asarray(jscope.find_var(n)) for n in names}
    jax_run = {"loss": [], "grads": None}
    for step in range(STEPS):
        out = jexe.run(main, feed=feeds(step), fetch_list=[loss] + grads)
        jax_run["loss"].append(np.asarray(out[0]))
        if step == 0:
            jax_run["grads"] = dict(zip(grads, map(np.asarray, out[1:])))
    jax_run["state"] = {n: np.asarray(jscope.find_var(n)) for n in names}

    tmain, tstartup, tloss, tgrads = build(ptt, ttr)
    assert persistables(tmain) == names and tgrads == grads
    tscope = ptt.Scope()
    texe = ptt.Executor(ptt.CPUPlace(), scope=tscope)
    ptt.io.params_from_numpy(tscope, init, ptt.CPUPlace())
    port_run = {"loss": [], "grads": None}
    for step in range(STEPS):
        out = texe.run(tmain, feed=feeds(step), fetch_list=[tloss] + tgrads)
        port_run["loss"].append(out[0])
        if step == 0:
            port_run["grads"] = dict(zip(tgrads, out[1:]))
    port_run["state"] = {n: tscope.find_var(n).numpy() for n in names}
    return dict(jax=jax_run, port=port_run, main=main, startup=startup,
                init=init)


def test_losses_match_step_for_step(runs):
    j, t = runs["jax"]["loss"], runs["port"]["loss"]
    assert len(j) == len(t) == STEPS
    for a, b in zip(t, j):
        assert a.shape == b.shape == (1,)
        np.testing.assert_allclose(a, b, rtol=1e-5)
    assert t[-1][0] < t[0][0]


def test_every_grad_matches_at_step_1(runs):
    j, t = runs["jax"]["grads"], runs["port"]["grads"]
    # embedding, 12 per layer, the final layer norm, the head
    assert sorted(j) == sorted(t) and len(j) == 1 + 12 * 2 + 2 + 1
    for name in j:
        assert t[name].shape == j[name].shape, name
        np.testing.assert_allclose(t[name], j[name], rtol=1e-4, atol=1e-6,
                                   err_msg=name)
        assert np.abs(t[name]).max() > 0, name


@pytest.mark.parametrize("kind", ["param", "moment1", "moment2", "pow_lr"])
def test_state_after_three_steps_matches(runs, kind):
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
        np.testing.assert_allclose(t[n], j[n], err_msg=n, **tol)
    if kind == "param":
        # the trainable params moved; the position table did not
        moved = [n for n in names if not np.array_equal(
            t[n], runs["init"][n])]
        assert sorted(moved) == sorted(
            p.name for p in runs["main"].all_parameters() if p.trainable)


def _op_view(prog):
    return [(op.type, op.inputs, op.outputs,
             json.loads(json.dumps(op.to_dict()["attrs"])))
            for op in prog.global_block().ops]


def _var_view(prog):
    return {v.name: (tuple(v.shape or ()), v.persistable, v.stop_gradient,
                     type(v).__name__) for v in prog.list_vars()}


def test_training_program_serializes_like_jax(runs):
    main, startup, _, _ = build(ptt, ttr)
    for mine, theirs in ((main, runs["main"]), (startup, runs["startup"])):
        assert _op_view(mine) == _op_view(theirs)
        assert _var_view(mine) == _var_view(theirs)
    assert ({p.name: (tuple(p.shape), p.dtype)
             for p in main.all_parameters()}
            == {p.name: (tuple(p.shape), p.dtype)
                for p in runs["main"].all_parameters()})
    types = [op.type for op in main.global_block().ops]
    assert types.count("autodiff") == 1
    assert types.count("adam") == len(
        [p for p in main.all_parameters() if p.trainable])
    assert types[-types.count("adam") - 1] == "autodiff"
    # JAX computes int64 on its 32-bit plane; every float var agrees
    for v in runs["main"].list_vars():
        if v.dtype.startswith("float"):
            assert main.global_block().var(v.name).dtype == v.dtype


def test_training_program_round_trips_through_the_jax_format(runs):
    d = json.loads(json.dumps(runs["main"].to_dict()))
    back = ptt.Program.from_dict(d).to_dict()
    assert json.loads(json.dumps(back)) == d


def test_port_trains_from_its_own_startup():
    main, startup, loss, grads = build(ptt, ttr)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace(), scope=scope)
    exe.run(startup)
    # the startup run leaves inference tensors; training must not trip
    assert scope.find_var(grads[0][:-len("@GRAD")]).is_inference()
    losses = [exe.run(main, feed=feeds(0), fetch_list=[loss])[0][0]
              for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    name = main.all_parameters()[0].name
    assert not scope.find_var(name).requires_grad


def test_minimize_refuses_what_is_not_ported():
    """minimize refuses nothing now: gradient accumulation, a clip set on
    the program and regularization, each refused until it was ported,
    build what the JAX package builds (the same op list; their numerics
    are tests/test_torch_grad_accumulation.py's and test_torch_clip.py's).
    What both packages refuse stays refused: the fused attention build
    with attention-prob dropout raises its ValueError."""
    def op_types(pkg, tr, clip=None, reg=None, k=1):
        pkg.reset_default_programs()
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            _, loss, _ = tr.build_lm_net(tiny_cfg(tr), T, fused_head=True)
            if clip is not None:
                pkg.clip.set_gradient_clip(clip(pkg))
            pkg.optimizer.Adam(
                1e-3, regularization=reg and reg(pkg)).minimize(
                loss, accumulate_steps=k)
        return [op.type for op in main.global_block().ops]

    for kw, extra in [
            ({"k": 2}, {"increment", "elementwise_mod", "equal", "assign",
                        "elementwise_sub", "elementwise_mul"}),
            ({"reg": lambda pkg: pkg.regularizer.L2Decay(1e-4)}, {"sum"}),
            ({"clip": lambda pkg: pkg.clip.GradientClipByGlobalNorm(1.0)},
             {"squared_l2_norm", "sqrt", "elementwise_max",
              "elementwise_div"})]:
        theirs, mine = op_types(pt, jtr, **kw), op_types(ptt, ttr, **kw)
        assert mine == theirs
        assert extra <= set(mine)
    for tr, pkg in ((jtr, pt), (ttr, ptt)):
        cfg = tiny_cfg(tr)
        cfg.dropout = 0.1
        with pytest.raises(ValueError, match="attention-prob dropout"):
            with pkg.program_guard(pkg.Program(), pkg.Program()):
                tr.build_lm_net(cfg, T, fused_head=True)


def _small_program():
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data("x", [4], dtype="float32")
        y = ptt.layers.fc(x, size=3)
        unused = ptt.layers.fc(x, size=2)
        loss = ptt.layers.mean(y)
    return main, startup, loss, unused


def test_unused_param_gets_zero_grad_and_grads_are_fetchable():
    main, startup, loss, _ = _small_program()
    with ptt.program_guard(main, startup):
        _, pg = ptt.optimizer.Adam(0.1).minimize(loss)
    exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    exe.run(startup)
    x = np.arange(8, dtype="float32").reshape(2, 4)
    out = exe.run(main, feed={"x": x}, fetch_list=[g for _, g in pg])
    by_name = {g.name: o for (_, g), o in zip(pg, out)}
    w0, b0, w1, b1 = [p.name for p, _ in pg]
    np.testing.assert_allclose(by_name[w0 + "@GRAD"],
                               np.repeat(x.mean(0)[:, None] / 3, 3, 1),
                               rtol=1e-6)
    np.testing.assert_allclose(by_name[b0 + "@GRAD"], np.full(3, 1 / 3),
                               rtol=1e-6)
    assert not by_name[w1 + "@GRAD"].any()
    assert not by_name[b1 + "@GRAD"].any()


def test_at_most_one_autodiff_op():
    main, startup, loss, _ = _small_program()
    with ptt.program_guard(main, startup):
        ptt.optimizer.Adam(0.1).minimize(loss)
        ptt.optimizer.Adam(0.1).minimize(loss)
    exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    exe.run(startup)
    with pytest.raises(Exception, match="at most one autodiff"):
        exe.run(main, feed={"x": np.ones((2, 4), "float32")})


def test_adam_state_names_match_jax_letter_for_letter(runs):
    jax_names = [n for n in persistables(runs["main"]) if "Adam_0" in n]
    assert "Adam_0.lr" in jax_names
    main, _, _, _ = build(ptt, ttr)
    assert [n for n in persistables(main) if "Adam_0" in n] == jax_names
    assert len(jax_names) == 1 + 4 * len(
        [p for p in main.all_parameters() if p.trainable])
    # beta pows start at beta (the Paddle convention), shape [1]
    init = runs["init"]
    some = [n for n in jax_names if n.endswith("beta1_pow")][0]
    assert init[some].shape == (1,)
    np.testing.assert_allclose(init[some], [0.9], rtol=1e-7)
