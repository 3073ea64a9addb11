"""``minimize`` with gradient clipping and regularization, and ``fc`` over
several inputs, in the port against the JAX package.

A tiny LM (V 256, L 2, H 4, d_model 64, d_inner 128, T 32, batch 2,
dropout 0, the fused attention build with the streamed head; Adam 1e-3)
is built in both packages under each clip (``GradientClipByValue``,
``ByNorm``, ``ByGlobalNorm`` with a ``clip_norm`` that bites) and each
regularizer (``L2Decay``, ``L1Decay``, a per-parameter regularizer over
the optimizer's), and with ``accumulate_steps`` 2 under the global clip.
The programs must serialize alike (op lists, slots, attrs, var names).
From the JAX initialisation both take 3 steps (4 micro-steps with k 2);
the losses are held at rtol 1e-5 and the state at
``tests/test_torch_train.py``'s tolerances: params atol 2e-6, moment1
rtol 1e-4 atol 1e-7, moment2 rtol 2e-4 atol 1e-10, pows and lr rtol
1e-6.  Where a step's effective grad (after the clip and the
regularizer) lies within 1e-5 of zero, not 0, a first Adam step moves an
entry by lr * g / (|g| + 3.2e-7), steep there: those entries are held to
lr, as ``tests/test_torch_grad_accumulation.py`` holds them.

The global norm is a sum of per-parameter ``squared_l2_norm`` reductions
whose summation order differs between XLA and torch: the clip factor of
the two packages is held at rtol 1e-6 (the observed gap is in
CHANGES.md).
"""
import json

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import transformer as jtr
from paddle_tpu_torch.models import transformer as ttr

T, BATCH, STEPS, LR = 32, 2, 3, 1e-3
NEAR_ZERO = 1e-5
# the flattened FFN weight of layer 0 and the final layer norm's scale
# take their own regularizer in the per-parameter case
OWN_REG = ("fc_0.w_0", "layer_norm_4.w_0")


def tiny_cfg(mod):
    return mod.TransformerConfig(src_vocab_size=256, max_length=T,
                                 n_layer=2, n_head=4, d_model=64,
                                 d_inner=128, dropout=0.0)


def _setup(pkg, case):
    """(set_gradient_clip arg, optimizer regularization, per-param
    regularizers, accumulate_steps) of a case, in package `pkg`."""
    c, r = pkg.clip, pkg.regularizer
    return {
        "by_value": (c.GradientClipByValue(2e-3), None, None, 1),
        "by_norm": (c.GradientClipByNorm(0.02), None, None, 1),
        "by_global_norm": (c.GradientClipByGlobalNorm(0.05), None, None,
                           1),
        "l2_decay": (None, r.L2Decay(0.1), None, 1),
        "l1_decay": (None, r.L1Decay(1e-3), None, 1),
        "per_param": (None, r.L2Decay(0.1), r.L1Decay(1e-3), 1),
        "accumulate_global_norm": (c.GradientClipByGlobalNorm(0.05), None,
                                   None, 2),
    }[case]


CASES = ("by_value", "by_norm", "by_global_norm", "l2_decay", "l1_decay",
         "per_param", "accumulate_global_norm")


def build(pkg, tr, case):
    clip, reg, own, k = _setup(pkg, case)
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 13
    with pkg.program_guard(main, startup):
        _, loss, _ = tr.build_lm_net(tiny_cfg(tr), T, fused_attention=True,
                                     fused_head=True)
        if own is not None:
            for n in OWN_REG:
                main.global_block().var(n).regularizer = own
        if clip is not None:
            pkg.clip.set_gradient_clip(clip)
        _, pg = pkg.optimizer.Adam(learning_rate=LR,
                                   regularization=reg).minimize(
            loss, accumulate_steps=k)
    return main, startup, loss, k, [(p.name, g.name) for p, g in pg]


def feeds(step):
    return ttr.make_fake_lm_batch(tiny_cfg(ttr), BATCH, T, seed=700 + step)


def persistables(prog):
    return sorted(v.name for v in prog.list_vars() if v.persistable)


@pytest.fixture(autouse=True)
def fresh_port_programs():
    ptt.reset_default_programs()
    yield
    ptt.reset_default_programs()


def _trajectory(exe, scope, main, loss, k, pg, names, extra=()):
    """Losses, the effective grads of every update step and the final
    state of 3 steps (3 * k micro-steps)."""
    losses, grads, extras = [], [], []
    for step in range(STEPS * k):
        out = exe.run(main, feed=feeds(step),
                      fetch_list=[loss] + [g for _, g in pg] + list(extra))
        losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
        if step % k == k - 1:
            grads.append({p: np.asarray(g)
                          for (p, _), g in zip(pg, out[1:1 + len(pg)])})
        extras.append([np.asarray(e) for e in out[1 + len(pg):]])
    state = {n: np.asarray(scope.find_var(n)) for n in names}
    return dict(loss=losses, grads=grads, state=state, extra=extras)


def _extra_fetches(case, pg):
    """The var that shows each case at work: the global clip's factor, or
    the decay term one regularizer adds to its param's grad."""
    if "global_norm" in case:
        return ["global_norm.factor"]
    grad = dict(pg)
    if case == "per_param":
        return [grad[OWN_REG[0]] + ".l1decay", grad[pg[0][0]] + ".l2decay"]
    if case in ("l2_decay", "l1_decay"):
        return [grad[pg[0][0]] + "." + case.replace("_", "")]
    return []


@pytest.fixture(scope="module", params=CASES)
def runs(request):
    case = request.param
    main, startup, loss, k, pg = build(pt, jtr, case)
    extra = _extra_fetches(case, pg)
    jscope = pt.Scope()
    jexe = pt.Executor(pt.CPUPlace(), scope=jscope)
    jexe.run(startup)
    names = persistables(main)
    init = {n: np.asarray(jscope.find_var(n)) for n in names}
    jax_run = _trajectory(jexe, jscope, main, loss, k, pg, names, extra)

    tmain, _, tloss, _, tpg = build(ptt, ttr, case)
    assert persistables(tmain) == names and tpg == pg
    tscope = ptt.Scope()
    texe = ptt.Executor(ptt.CPUPlace(), scope=tscope)
    ptt.io.params_from_numpy(tscope, init, ptt.CPUPlace())
    port_run = _trajectory(texe, tscope, tmain, tloss, k, pg, names, extra)
    return dict(case=case, jax=jax_run, port=port_run, main=main,
                startup=startup, init=init, pg=pg)


def _op_view(prog):
    return [(op.type, op.inputs, op.outputs,
             json.loads(json.dumps(op.to_dict()["attrs"])))
            for op in prog.global_block().ops]


def _var_view(prog):
    return {v.name: (tuple(v.shape or ()), v.persistable, v.stop_gradient,
                     type(v).__name__) for v in prog.list_vars()}


def test_program_serializes_like_jax(runs):
    main, startup, _, _, _ = build(ptt, ttr, runs["case"])
    for mine, theirs in ((main, runs["main"]), (startup, runs["startup"])):
        assert _op_view(mine) == _op_view(theirs)
        assert _var_view(mine) == _var_view(theirs)
    types = [op.type for op in main.global_block().ops]
    want = {"by_value": {"clip"}, "by_norm": {"clip_by_norm"},
            "by_global_norm": {"squared_l2_norm", "sum", "sqrt",
                               "elementwise_max", "elementwise_div"},
            "l2_decay": {"sum"}, "l1_decay": {"sign", "sum"},
            "per_param": {"sign", "sum"},
            "accumulate_global_norm": {"squared_l2_norm", "elementwise_mod"}
            }[runs["case"]]
    assert want <= set(types)
    # the clip runs between autodiff and the first update, a param's
    # regularizer between autodiff and that param's update
    ops = main.global_block().ops
    ad, first_adam = types.index("autodiff"), types.index("adam")
    clips = [i for i, t in enumerate(types)
             if t in ("clip", "clip_by_norm", "squared_l2_norm")]
    assert all(ad < i < first_adam for i in clips)
    update_of = {op.inputs["Grad"][0]: i for i, op in enumerate(ops)
                 if op.type == "adam"}
    regs = [(i, op.outputs["Out"][0]) for i, op in enumerate(ops)
            if op.type == "sum" and op.outputs["Out"][0] in update_of]
    assert bool(clips) != bool(regs)
    assert all(ad < i < update_of[g] for i, g in regs)


def test_losses_match_step_for_step(runs):
    j, t = runs["jax"]["loss"], runs["port"]["loss"]
    np.testing.assert_allclose(t, j, rtol=1e-5)
    assert np.isfinite(t).all()


def test_effective_grads_match(runs):
    """The grads the updates see, after the clip and the regularizer."""
    for j, t in zip(runs["jax"]["grads"], runs["port"]["grads"]):
        assert sorted(j) == sorted(t)
        for n in j:
            np.testing.assert_allclose(t[n], j[n], rtol=1e-4, atol=1e-6,
                                       err_msg=n)


def test_the_clip_and_the_regularizer_act(runs):
    """Each case changes what the updates see: by value every grad stays
    in its bounds and some sit on them; by norm every param's grad norm
    is at most clip_norm and some equal it; the global norm is clip_norm
    (the raw one was larger: factor < 1); a regularizer adds
    coeff * param (L2) or coeff * sign(param) (L1) to its param's grad,
    read at step 1 against the initial params."""
    case = runs["case"]
    grads = runs["port"]["grads"]
    first = runs["pg"][0][0]
    if case == "by_value":
        top = max(np.abs(g).max() for s in grads for g in s.values())
        assert top == pytest.approx(2e-3)
    elif case == "by_norm":
        norms = [np.linalg.norm(g.astype("float64"))
                 for s in grads for g in s.values()]
        assert max(norms) == pytest.approx(0.02, rel=1e-5)
        assert min(norms) < 0.02
    elif "global_norm" in case:
        for s in grads:
            gn = np.sqrt(sum((g.astype("float64") ** 2).sum()
                             for g in s.values()))
            assert gn == pytest.approx(0.05, rel=1e-5)
        factors = [e[0] for e in runs["port"]["extra"]]
        jfactors = [e[0] for e in runs["jax"]["extra"]]
        np.testing.assert_allclose(factors, jfactors, rtol=1e-6)
        assert max(np.max(f) for f in factors) < 1
    else:
        got = runs["port"]["extra"][0]
        init = runs["init"]
        if case == "l2_decay":
            want = [0.1 * init[first]]
        elif case == "l1_decay":
            want = [1e-3 * np.sign(init[first])]
        else:
            want = [1e-3 * np.sign(init[OWN_REG[0]]), 0.1 * init[first]]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
            assert np.abs(w).max() > 0


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
    near = {}
    for step in runs["port"]["grads"]:
        for n, g in step.items():
            near[n] = near.get(n, False) | ((g != 0)
                                            & (np.abs(g) < NEAR_ZERO))
    for n in names:
        assert t[n].shape == j[n].shape, n
        if kind == "param" and n in near and near[n].any():
            far = ~near[n]
            np.testing.assert_allclose(t[n][far], j[n][far], err_msg=n,
                                       **tol)
            np.testing.assert_allclose(t[n][near[n]], j[n][near[n]],
                                       rtol=0, atol=LR, err_msg=n)
        elif kind in ("moment1", "moment2"):
            p = n.split(".", 1)[1].rsplit(".", 1)[0]
            far = ~near.get(p, np.zeros(t[n].shape, bool))
            np.testing.assert_allclose(t[n][far], j[n][far], err_msg=n,
                                       **tol)
        else:
            np.testing.assert_allclose(t[n], j[n], err_msg=n, **tol)
    if kind == "param":
        moved = [n for n in names if not np.array_equal(
            t[n], runs["init"][n])]
        assert sorted(moved) == sorted(
            p.name for p in runs["main"].all_parameters() if p.trainable)


def test_per_parameter_regularizer_wins_over_the_optimizers():
    main, _, _, _, _ = build(ptt, ttr, "per_param")
    ops = main.global_block().ops
    signs = sorted(op.inputs["X"][0] for op in ops if op.type == "sign")
    assert signs == sorted(OWN_REG)
    l2 = [op for op in ops if op.type == "scale"
          and op.outputs["Out"][0].endswith(".l2decay")]
    trainable = [p.name for p in main.all_parameters() if p.trainable]
    assert sorted(op.inputs["X"][0] for op in l2) == sorted(
        set(trainable) - set(OWN_REG))


def test_param_attr_regularizer_rides_on_the_parameter():
    """ParamAttr(regularizer=...) reaches the Parameter in both packages,
    and minimize applies it: the same ops."""
    views = []
    for pkg in (pt, ptt):
        pkg.reset_default_programs()
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = pkg.layers.data("x", [8], dtype="float32")
            reg = pkg.regularizer.L1Decay(0.5)
            y = pkg.layers.fc(x, size=4,
                              param_attr=pkg.ParamAttr(regularizer=reg))
            loss = pkg.layers.mean(y)
            pkg.optimizer.Adam(0.1).minimize(loss)
        w, b = main.all_parameters()
        assert w.name == "fc_0.w_0" and w.regularizer is reg
        assert b.regularizer is None
        views.append(_op_view(main))
    assert views[0] == views[1]
    assert [t for t, *_ in views[1]].count("sign") == 1


def _two_input_fc(pkg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup):
        a = pkg.layers.data("a", [6], dtype="float32")
        b = pkg.layers.data("b", [3, 4], dtype="float32")
        y = pkg.layers.fc([a, pkg.layers.reshape(b, [-1, 12])], size=5,
                          act="relu")
    return main, startup, y


def test_fc_over_two_inputs_matches_jax():
    pt.reset_default_programs()
    jmain, jstartup, jy = _two_input_fc(pt)
    jscope = pt.Scope()
    jexe = pt.Executor(pt.CPUPlace(), scope=jscope)
    jexe.run(jstartup)
    rng = np.random.RandomState(0)
    feed = {"a": rng.randn(7, 6).astype("float32"),
            "b": rng.randn(7, 3, 4).astype("float32")}
    want, = jexe.run(jmain, feed=feed, fetch_list=[jy])

    tmain, tstartup, ty = _two_input_fc(ptt)
    assert _op_view(tmain) == _op_view(jmain)
    assert _var_view(tmain) == _var_view(jmain)
    assert [op.type for op in tmain.global_block().ops].count("sum") == 1
    tscope = ptt.Scope()
    ptt.io.params_from_numpy(
        tscope, {n: np.asarray(jscope.find_var(n))
                 for n in persistables(jmain)}, ptt.CPUPlace())
    got, = ptt.Executor(ptt.CPUPlace(), scope=tscope).run(
        tmain, feed=feed, fetch_list=[ty])
    assert got.shape == (7, 5) and (got > 0).any()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
