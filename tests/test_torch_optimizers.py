"""The optimizer family (optimizer.py: LarsMomentum to ProximalAdagrad,
and ModelAverage) and ``ParamAttr.learning_rate`` through both packages.

Each class trains the small DeepFM of ``tests/test_torch_deepfm.py``
(F 4, V 50, K 4, towers (8, 8), batch 8, the dense build) for 3 steps in
both packages from the JAX initialisation, carried over with
``io.params_from_numpy`` with every accumulator at its start value.  The
programs serialize alike (accumulator names, start values, op order), so
the state binds by name.  Tolerances, each the same f32 math summed in
another order:

- loss per step: rtol 1e-5;
- after step 3, every param: atol 2e-3 of the class's lr (Adam's 2e-6 at
  lr 1e-3 in ``tests/test_torch_train.py``), a param entry whose grad
  came within 1e-5 of zero (not 0) on some step held to lr instead: the
  adaptive classes move it by about lr * g / (|g| + eps), a steep
  function of a grad that the summation order moves;
- every accumulator: rtol 1e-4, atol 1e-6 (moments, squared sums,
  velocities; the pows and lr exact math, the same; the atol for FTRL's
  linear sum, whose entries g - sigma * p cancel toward 0: one entry of
  128 read 4.6e-7 off).

Gradient accumulation (k 2, Adagrad) runs 4 micro-steps, and a
``ParamAttr(learning_rate=0.5)`` tower takes its ``scale`` op; both are
held at the same tolerances.  ModelAverage is held to JAX's apply and
restore programs op for op, and on the port: apply right after startup
is a no-op, apply after 5 Adagrad steps gives the mean of the 5
post-step values (atol 1e-6: a sum of 5 f32 values divided by 5), past
the window cap JAX's sliding sum, and restore is bit-equal.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import deepfm as jdfm
from paddle_tpu_torch.models import deepfm as tdfm
from test_torch_train import _op_view, _var_view

F, V, K, FC, BATCH, STEPS = 4, 50, 4, (8, 8), 8, 3
LOSS_RTOL = 1e-5
PARAM_ATOL_OF_LR = 2e-3
STATE_TOL = dict(rtol=1e-4, atol=1e-6)
NEAR_ZERO = 1e-5
AVG_ATOL = 1e-6
TOWER = ("fc_0.w_0", "fc_1.b_0")     # the first tower's weight and bias

# case -> (class, its arguments); the lr is the class's lr var
OPTIMIZERS = {
    "lars_momentum": ("LarsMomentum", dict(learning_rate=0.1,
                                           momentum=0.9)),
    "adamw": ("AdamW", dict(learning_rate=0.01, weight_decay=0.01)),
    "adamax": ("Adamax", dict(learning_rate=0.01)),
    "adagrad": ("Adagrad", dict(learning_rate=0.05)),
    "decayed_adagrad": ("DecayedAdagrad", dict(learning_rate=0.05)),
    "adadelta": ("Adadelta", dict(learning_rate=1.0)),
    "rmsprop": ("RMSProp", dict(learning_rate=0.01, momentum=0.9)),
    "rmsprop_centered": ("RMSProp", dict(learning_rate=0.01,
                                         centered=True)),
    "ftrl": ("Ftrl", dict(learning_rate=0.05, l1=0.01, l2=0.01)),
    # l2 > 0: FTRL divides by sqrt(sum g^2) / lr + 2 * l2, and a dead
    # unit's sum of squared grads stays 0
    "ftrl_lr_power": ("Ftrl", dict(learning_rate=0.05, l2=0.01,
                                   lr_power=-0.7)),
    "lamb": ("Lamb", dict(learning_rate=0.01)),
    "proximal_gd": ("ProximalGD", dict(learning_rate=0.05, l1=1e-3,
                                       l2=1e-3)),
    "proximal_adagrad": ("ProximalAdagrad", dict(learning_rate=0.05,
                                                 l1=1e-3, l2=1e-3)),
}


def tiny_cfg(mod):
    return mod.DeepFMConfig(num_field=F, vocab_size=V, embed_dim=K,
                            fc_sizes=FC)


@pytest.fixture(autouse=True)
def fresh_port_programs():
    ptt.reset_default_programs()
    yield
    ptt.reset_default_programs()


def build(pkg, opt, kw, accumulate=1, tower_lr=None, average=None):
    """(main, startup, loss, grad names, ModelAverage or None) of the
    small DeepFM with `opt`(**kw).minimize in fresh programs of `pkg`;
    `tower_lr` sets the first tower's ParamAttr.learning_rate (as the
    layer's ParamAttr would), `average` appends ModelAverage(max window
    `average`)."""
    mod = jdfm if pkg is pt else tdfm
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 17
    with pkg.program_guard(main, startup):
        _, loss, _ = mod.build_train_net(tiny_cfg(mod))
        if tower_lr is not None:
            for n in TOWER:
                main.global_block().var(n).optimize_attr = {
                    "learning_rate": tower_lr}
        _, pg = getattr(pkg.optimizer, opt)(**kw).minimize(
            loss, accumulate_steps=accumulate)
        ma = (pkg.optimizer.ModelAverage(max_average_window=average)
              if average else None)
    return main, startup, loss, [g.name for _, g in pg], ma


def feed(step):
    return tdfm.make_fake_batch(tiny_cfg(tdfm), BATCH, seed=600 + step)


def persistables(prog):
    return sorted(v.name for v in prog.list_vars() if v.persistable)


def serializes_alike(mine, theirs):
    for t, j in ((mine[0], theirs[0]), (mine[1], theirs[1])):
        assert _op_view(t) == _op_view(j)
        assert _var_view(t) == _var_view(j)


def trajectories(opt, kw, steps=STEPS, **build_kw):
    """Both packages' runs over `steps` feeds from the JAX
    initialisation: losses, the grads of every step, the final states."""
    theirs = build(pt, opt, kw, **build_kw)
    mine = build(ptt, opt, kw, **build_kw)
    serializes_alike(mine, theirs)
    jscope = pt.Scope()
    jexe = pt.Executor(pt.CPUPlace(), scope=jscope)
    jexe.run(theirs[1])
    names = persistables(theirs[0])
    assert persistables(mine[0]) == names
    init = {n: np.asarray(jscope.find_var(n)) for n in names}
    tscope = ptt.Scope()
    texe = ptt.Executor(ptt.CPUPlace(), scope=tscope)
    ptt.io.params_from_numpy(tscope, init, ptt.CPUPlace())
    out = {"jax": {"loss": [], "grads": []}, "port": {"loss": [],
                                                      "grads": []}}
    for step in range(steps):
        for side, exe, (prog, _, loss, grads, _) in (("jax", jexe, theirs),
                                                     ("port", texe, mine)):
            res = exe.run(prog, feed=feed(step), fetch_list=[loss] + grads)
            out[side]["loss"].append(float(np.asarray(res[0])))
            # by param name (under accumulation a grad is the mean var)
            out[side]["grads"].append(dict(zip(
                [p.name for p in prog.all_parameters()],
                map(np.asarray, res[1:]))))
    out["jax"]["state"] = {n: np.asarray(jscope.find_var(n)) for n in names}
    out["port"]["state"] = {n: tscope.find_var(n).numpy() for n in names}
    out.update(init=init, main=theirs[0], names=names)
    return out


def check(out, lr):
    """The losses and every persistable at the module's tolerances."""
    np.testing.assert_allclose(out["port"]["loss"], out["jax"]["loss"],
                               rtol=LOSS_RTOL)
    params = {p.name for p in out["main"].all_parameters()}
    moved = []
    for n in out["names"]:
        got, want = out["port"]["state"][n], out["jax"]["state"][n]
        assert got.shape == want.shape, n
        if n in params:
            near = np.any([(g[n] != 0) & (abs(g[n]) < NEAR_ZERO)
                           for side in ("jax", "port")
                           for g in out[side]["grads"]], 0)
            assert near.sum() <= max(1, 0.05 * near.size), n
            np.testing.assert_allclose(got[near], want[near], rtol=0,
                                       atol=lr, err_msg=n)
            np.testing.assert_allclose(
                np.where(near, 0, got), np.where(near, 0, want), rtol=0,
                atol=PARAM_ATOL_OF_LR * lr, err_msg=n)
            moved.append(not np.array_equal(got, out["init"][n]))
        else:
            np.testing.assert_allclose(got, want, err_msg=n, **STATE_TOL)
    assert all(moved)


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_optimizer_three_steps_match_jax(case):
    opt, kw = OPTIMIZERS[case]
    check(trajectories(opt, kw), kw["learning_rate"])


def test_accumulators_bind_by_name():
    """Every class's accumulators: JAX's names and start values (the
    startup programs serialize alike in every case above), e.g.
    Adamax's beta1 pow starts at beta1 and FTRL's two sums at 0."""
    _, startup, _, _, _ = build(ptt, "Adamax", dict(learning_rate=0.01))
    fills = {op.outputs["Out"][0]: op.attrs["value"]
             for op in startup.global_block().ops
             if op.type == "fill_constant"}
    assert fills["Adamax_0.fm_emb.beta1_pow"] == pytest.approx(0.9)
    assert fills["Adamax_0.fm_emb.inf_norm"] == 0.0
    _, startup, _, _, _ = build(ptt, "Ftrl", dict(learning_rate=0.05))
    names = {op.outputs["Out"][0] for op in startup.global_block().ops}
    assert {"Ftrl_0.fm_w1.squared", "Ftrl_0.fm_w1.linear"} <= names


def test_gradient_accumulation_matches_jax():
    """Adagrad with accumulate_steps=2: 4 micro-steps, two updates, each
    of the mean of two micro-batch grads (the gated update ops)."""
    out = trajectories("Adagrad", dict(learning_rate=0.05), steps=4,
                       accumulate=2)
    check(out, 0.05)
    assert any(n.endswith(".grad_acc") for n in out["names"])


def test_param_lr_scales_the_update_like_jax():
    """A tower at ParamAttr learning_rate 0.5: a ``scale`` op of the lr
    var into ``Adagrad_0.<param>.lr`` just before that param's update
    op, which reads it; the steps match JAX's."""
    main, _, _, _, _ = build(ptt, "Adagrad", dict(learning_rate=0.05),
                             tower_lr=0.5)
    ops = main.global_block().ops
    for p in TOWER:
        i = next(i for i, op in enumerate(ops) if op.type == "adagrad"
                 and op.inputs["Param"] == [p])
        assert ops[i - 1].type == "scale"
        assert ops[i - 1].inputs["X"] == ["Adagrad_0.lr"]
        assert ops[i - 1].attrs["scale"] == 0.5
        assert ops[i].inputs["LearningRate"] == [f"Adagrad_0.{p}.lr"]
    assert sum(op.type == "scale" and op.inputs["X"] == ["Adagrad_0.lr"]
               for op in ops) == 2
    check(trajectories("Adagrad", dict(learning_rate=0.05), tower_lr=0.5),
          0.05)
    with ptt.program_guard(ptt.Program(), ptt.Program()):
        x = ptt.layers.data("x", [3])
        ptt.layers.fc(x, 2, param_attr=ptt.ParamAttr(name="w",
                                                     learning_rate=0.25))
        assert ptt.default_main_program().global_block().var(
            "w").optimize_attr == {"learning_rate": 0.25}


# =====================================================================
# ModelAverage
# =====================================================================

def test_model_average_programs_serialize_like_jax():
    theirs = build(pt, "Adagrad", dict(learning_rate=0.05), average=10)
    mine = build(ptt, "Adagrad", dict(learning_rate=0.05), average=10)
    serializes_alike(mine, theirs)
    for prog in ("apply_program", "restore_program"):
        t, j = getattr(mine[4], prog), getattr(theirs[4], prog)
        assert _op_view(t) == _op_view(j)
        assert _var_view(t) == _var_view(j)
    types = [op.type for op in mine[0].global_block().ops]
    n = len([p for p in mine[0].all_parameters()])
    assert types[-n:] == ["average_accumulates"] * n


@pytest.mark.parametrize("window", [10, 3])
def test_model_average_apply_and_restore(window):
    """On the port: apply right after startup leaves every param as it
    is; after 5 Adagrad steps apply gives the mean of the 5 post-step
    values (window 10), or JAX's sliding sum past the cap (window 3), and
    equals JAX's apply; restore gives back the trained values bit for
    bit.  The running sums and counts equal JAX's after every step."""
    kw = dict(learning_rate=0.05)
    jmain, jstart, jloss, _, jma = build(pt, "Adagrad", kw, average=window)
    tmain, _, tloss, _, tma = build(ptt, "Adagrad", kw, average=window)
    jscope = pt.Scope()
    jexe = pt.Executor(pt.CPUPlace(), scope=jscope)
    jexe.run(jstart)
    names = persistables(jmain)
    init = {n: np.asarray(jscope.find_var(n)) for n in names}
    tscope = ptt.Scope()
    texe = ptt.Executor(ptt.CPUPlace(), scope=tscope)
    ptt.io.params_from_numpy(tscope, init, ptt.CPUPlace())
    params = [p.name for p in tmain.all_parameters()]

    def port_params():
        return {n: tscope.find_var(n).numpy().copy() for n in params}

    with tma.apply(texe):
        for n, a in port_params().items():
            np.testing.assert_array_equal(a, init[n], err_msg=n)
    after = []
    for step in range(5):
        jexe.run(jmain, feed=feed(step), fetch_list=[jloss])
        texe.run(tmain, feed=feed(step), fetch_list=[tloss])
        after.append(port_params())
        for n in names:
            if ".sum_1" in n or ".num_accumulates" in n:
                np.testing.assert_allclose(
                    tscope.find_var(n).numpy().reshape(-1),
                    np.asarray(jscope.find_var(n)).reshape(-1),
                    err_msg=n, **STATE_TOL)
    trained = port_params()
    with tma.apply(texe), jma.apply(jexe):
        for n in params:
            got = tscope.find_var(n).numpy()
            np.testing.assert_allclose(got, np.asarray(jscope.find_var(n)),
                                       rtol=0, atol=AVG_ATOL, err_msg=n)
            if window >= 5:
                mean = np.mean([a[n] for a in after], 0)
                np.testing.assert_allclose(got, mean, rtol=0,
                                           atol=AVG_ATOL, err_msg=n)
            else:
                assert not np.allclose(got, trained[n], rtol=0, atol=0)
    for n, a in port_params().items():
        np.testing.assert_array_equal(a, trained[n], err_msg=n)
