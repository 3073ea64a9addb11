"""The in-graph learning-rate schedules (layers/learning_rate_scheduler.py)
through both packages.

Each of the eight schedules (with ``staircase``, ``cycle`` and
linear_lr_warmup's ``After`` schedule) is built in fresh programs of both
packages and run 12 times from its startup program: the lr each run
fetches, steps 1..12, is held to JAX's at rtol 1e-6 (f32 math in another
order), and the programs serialize alike (the ``@lr_global_step@``
counter, its startup fill, the increment and the ``lr_schedule`` op).

A schedule driving an optimizer: ``noam_decay`` under Adam for 3 steps of
a small NMT (``tests/test_torch_nmt.py``'s L 2, d_model 32, batch 4) from
the JAX initialisation, at ``tests/test_torch_optimizers.py``'s
tolerances (loss rtol 1e-5; trainable params atol 2e-3 of the largest
lr, an entry whose grad came within 1e-5 of zero held to that lr; every
accumulator rtol 1e-4, atol 1e-6; the counter exact).  Noam's lr
(0.022-0.066 over the three steps, 22-66x the optimizer tests' Adam
1e-3) leaves 6 % of one projection's entries with a grad within 1e-5 of
zero on some step, so the optimizer tests' 5 % cap on that share is not
kept here.  ``piecewise_decay`` drives Momentum for 3 steps of ResNet-18
on 3x32x32 at batch 4, each step from JAX's state before it at
``tests/test_torch_resnet.py``'s tolerances and its first lr, 0.01 (a
free-running batch-4 ResNet trajectory parts even in f32: loss rtol
1e-4, each velocity's, param's and running stat's change within 2e-3 of
max |JAX|), the boundaries at steps 2 and 3 so that the three steps take
three lrs.  ``run_steps(4)`` gives the counter and the lrs of 4 ``run``
calls bit for bit, under FLAGS_amp_bf16 the schedule stays f32, and the
counter saved with the persistables resumes at the next lr.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.models import transformer as jtr
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models import transformer as ttr
from test_torch_nmt import nmt_feed, tiny_cfg
from test_torch_train import _op_view, _var_view

STEP = "@lr_global_step@"
RUNS = 12
LR_RTOL = 1e-6
LOSS_RTOL = 1e-5
PARAM_ATOL_OF_LR = 2e-3
STATE_TOL = dict(rtol=1e-4, atol=1e-6)
NEAR_ZERO = 1e-5
RESNET_LOSS_RTOL = 1e-4
RESNET_STATE_RTOL = 2e-3

# case -> (schedule, args, kwargs); a callable arg builds a schedule var
SCHEDULES = {
    "noam": ("noam_decay", (64, 4), {}),
    "exponential": ("exponential_decay", (0.1, 3, 0.5), {}),
    "exponential_staircase": ("exponential_decay", (0.1, 3, 0.5),
                              {"staircase": True}),
    "natural_exp": ("natural_exp_decay", (0.1, 4, 0.3), {}),
    "natural_exp_staircase": ("natural_exp_decay", (0.1, 4, 0.3),
                              {"staircase": True}),
    "inverse_time": ("inverse_time_decay", (0.1, 2, 0.5), {}),
    "inverse_time_staircase": ("inverse_time_decay", (0.1, 2, 0.5),
                               {"staircase": True}),
    "polynomial": ("polynomial_decay", (0.1, 8),
                   {"end_learning_rate": 0.01, "power": 2.0}),
    "polynomial_cycle": ("polynomial_decay", (0.1, 5),
                         {"end_learning_rate": 0.01, "power": 1.5,
                          "cycle": True}),
    "piecewise": ("piecewise_decay", ([3, 7, 10], [0.1, 0.05, 0.01, 0.002]),
                  {}),
    "cosine": ("cosine_decay", (0.1, 2, 6), {}),
    "linear_warmup": ("linear_lr_warmup", (0.1, 5, 0.0, 0.1), {}),
    "linear_warmup_after": (
        "linear_lr_warmup",
        (lambda L: L.exponential_decay(0.1, 2, 0.8), 4, 0.01, 0.1), {}),
}


@pytest.fixture(autouse=True)
def fresh_port_programs():
    ptt.reset_default_programs()
    yield
    ptt.reset_default_programs()
    pt.core.flags.set_flag("amp_bf16", False)
    ptt.flags.set_flag("amp_bf16", False)


def build_schedule(pkg, case):
    name, args, kw = SCHEDULES[case]
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        args = [a(pkg.layers) if callable(a) else a for a in args]
        lr = getattr(pkg.layers, name)(*args, **kw)
    return main, startup, lr


def lrs_of(pkg, case, runs=RUNS):
    main, startup, lr = build_schedule(pkg, case)
    exe = pkg.Executor(pkg.CPUPlace(), scope=pkg.Scope())
    exe.run(startup)
    out = []
    for _ in range(runs):
        v, = exe.run(main, fetch_list=[lr])
        out.append(np.asarray(v))
    return np.stack(out), (main, startup)


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_schedule_matches_jax_steps_1_to_12(case):
    got, mine = lrs_of(ptt, case)
    want, theirs = lrs_of(pt, case)
    assert got.shape == want.shape == (RUNS, 1)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=LR_RTOL)
    assert len(np.unique(got)) > 1            # the schedule moved
    for t, j in zip(mine, theirs):
        assert _op_view(t) == _op_view(j)
        assert _var_view(t) == _var_view(j)


def test_noam_matches_the_transformer_papers_closed_form():
    """d^-0.5 * min(s^-0.5, s * w^-1.5) at s = 1..12: the first run takes
    step 1 (the counter starts at 0 and is incremented before the read)."""
    got, _ = lrs_of(ptt, "noam")
    want = [64 ** -0.5 * min(s ** -0.5, s * 4 ** -1.5)
            for s in range(1, RUNS + 1)]
    np.testing.assert_allclose(got.ravel(), want, rtol=LR_RTOL)


def test_one_counter_however_many_schedules():
    """linear_lr_warmup over an exponential schedule: two lr_schedule ops,
    one counter, one increment a run."""
    main, startup, _ = build_schedule(ptt, "linear_warmup_after")
    types = [op.type for op in main.global_block().ops]
    assert types == ["increment_loop_counter", "lr_schedule", "lr_schedule"]
    assert [op.outputs["Out"] for op in startup.global_block().ops] == [
        [STEP]]


def test_schedule_stays_f32_under_amp():
    ptt.flags.set_flag("amp_bf16", True)
    got, _ = lrs_of(ptt, "noam", runs=3)
    ptt.flags.set_flag("amp_bf16", False)
    want, _ = lrs_of(ptt, "noam", runs=3)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------
# a schedule driving Adam (NMT) and Momentum (ResNet)
# ---------------------------------------------------------------------

def build_nmt(pkg):
    mod = jtr if pkg is pt else ttr
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup):
        _, loss, _ = mod.build_train_net(tiny_cfg(mod), 12, 10)
        lr = pkg.layers.noam_decay(32, 4)
        _, pg = pkg.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss, lr, [g.name for _, g in pg]


def persistables(prog):
    return sorted(v.name for v in prog.list_vars() if v.persistable)


@pytest.fixture(scope="module")
def nmt_runs():
    theirs, mine = build_nmt(pt), build_nmt(ptt)
    ptt.reset_default_programs()
    for t, j in zip(mine[:2], theirs[:2]):
        assert _op_view(t) == _op_view(j)
    jscope = pt.Scope()
    jexe = pt.Executor(pt.CPUPlace(), scope=jscope)
    jexe.run(theirs[1])
    names = persistables(theirs[0])
    assert persistables(mine[0]) == names and STEP in names
    init = {n: np.asarray(jscope.find_var(n)) for n in names}
    tscope = ptt.Scope()
    texe = ptt.Executor(ptt.CPUPlace(), scope=tscope)
    ptt.io.params_from_numpy(tscope, init, ptt.CPUPlace())
    out = {side: {"loss": [], "lr": [], "grads": []}
           for side in ("jax", "port")}
    for step in range(3):
        feed = nmt_feed(step)
        for side, exe, (main, _, loss, lr, grads) in (
                ("jax", jexe, theirs), ("port", texe, mine)):
            res = exe.run(main, feed=feed, fetch_list=[loss, lr] + grads)
            out[side]["loss"].append(float(np.asarray(res[0])))
            out[side]["lr"].append(float(np.asarray(res[1]).ravel()[0]))
            out[side]["grads"].append(dict(zip(
                [n[:-len("@GRAD")] for n in grads], map(np.asarray,
                                                        res[2:]))))
    out["jax"]["state"] = {n: np.asarray(jscope.find_var(n)) for n in names}
    out["port"]["state"] = {n: tscope.find_var(n).numpy() for n in names}
    out.update(init=init, main=theirs[0], names=names)
    return out


def test_noam_drives_adam_like_jax(nmt_runs):
    out = nmt_runs
    np.testing.assert_allclose(out["port"]["loss"], out["jax"]["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(out["port"]["lr"], out["jax"]["lr"],
                               rtol=LR_RTOL)
    want_lr = [32 ** -0.5 * min(s ** -0.5, s * 4 ** -1.5) for s in (1, 2, 3)]
    np.testing.assert_allclose(out["port"]["lr"], want_lr, rtol=LR_RTOL)
    lr = max(want_lr)
    params = {p.name for p in out["main"].all_parameters() if p.trainable}
    for n in out["names"]:
        got, want = out["port"]["state"][n], out["jax"]["state"][n]
        assert got.shape == want.shape, n
        if n == STEP:
            assert int(got.ravel()[0]) == int(want.ravel()[0]) == 3
        elif n in params:
            near = np.any([(g[n] != 0) & (abs(g[n]) < NEAR_ZERO)
                           for side in ("jax", "port")
                           for g in out[side]["grads"]], 0)
            np.testing.assert_allclose(got[near], want[near], rtol=0,
                                       atol=lr, err_msg=n)
            np.testing.assert_allclose(
                np.where(near, 0, got), np.where(near, 0, want), rtol=0,
                atol=PARAM_ATOL_OF_LR * lr, err_msg=n)
            assert not np.array_equal(got, out["init"][n]), n
        else:
            np.testing.assert_allclose(got, want, err_msg=n, **STATE_TOL)


RESNET_BOUNDS, RESNET_VALUES = [2, 3], [0.01, 0.005, 0.001]


def build_resnet(pkg):
    mod = jresnet if pkg is pt else tresnet
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup):
        _, loss, _, _ = mod.build_train_net(class_dim=10,
                                            img_shape=(3, 32, 32), depth=18)
        lr = pkg.layers.piecewise_decay(RESNET_BOUNDS, RESNET_VALUES)
        pkg.optimizer.Momentum(learning_rate=lr, momentum=0.9).minimize(loss)
    return main, startup, loss, lr


def rel_of_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_piecewise_drives_momentum_like_jax():
    """Each of 3 steps from JAX's state before it (the counter among it):
    the loss, the lr (one of the three values a step) and every
    velocity's, param's and running stat's change."""
    jmain, jstartup, jloss, jlr = build_resnet(pt)
    tmain, _, tloss, tlr = build_resnet(ptt)
    assert _op_view(tmain) == _op_view(jmain)
    jscope = pt.Scope()
    jexe = pt.Executor(pt.CPUPlace(), scope=jscope)
    jexe.run(jstartup)
    names = persistables(jmain)
    assert persistables(tmain) == names
    tscope = ptt.Scope()
    texe = ptt.Executor(ptt.CPUPlace(), scope=tscope)
    state = {n: np.asarray(jscope.find_var(n)) for n in names}
    r = np.random.RandomState(0)
    lrs = []
    for step in range(3):
        feed = {"img": r.randn(4, 3, 32, 32).astype("float32"),
                "label": r.randint(0, 10, (4, 1)).astype("int64")}
        for n, a in state.items():
            jscope.set_var(n, a)
        jl, jv = jexe.run(jmain, feed=feed, fetch_list=[jloss, jlr])
        jafter = {n: np.asarray(jscope.find_var(n)) for n in names}
        ptt.io.params_from_numpy(tscope, state, ptt.CPUPlace())
        tl, tv = texe.run(tmain, feed=feed, fetch_list=[tloss, tlr])
        tafter = {n: tscope.find_var(n).numpy() for n in names}
        np.testing.assert_allclose(float(tl), float(jl),
                                   rtol=RESNET_LOSS_RTOL)
        np.testing.assert_allclose(tv, jv, rtol=LR_RTOL)
        lrs.append(float(tv.ravel()[0]))
        assert int(tafter[STEP].ravel()[0]) == step + 1
        for n in names:
            if n == STEP:
                continue
            base = 0 if n.endswith(".velocity") else state[n]
            change = jafter[n] - base
            if np.abs(change).max() == 0:
                np.testing.assert_array_equal(tafter[n], jafter[n],
                                              err_msg=n)
                continue
            assert rel_of_max(tafter[n] - base, change) \
                <= RESNET_STATE_RTOL, (step, n)
        state = jafter
    np.testing.assert_allclose(lrs, RESNET_VALUES, rtol=LR_RTOL)


# ---------------------------------------------------------------------
# the counter as state: run_steps, save and reload
# ---------------------------------------------------------------------

def build_fc(pkg=ptt):
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [4])
        y = pkg.layers.data("y", [1])
        pred = pkg.layers.fc(x, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        lr = pkg.layers.exponential_decay(0.1, decay_steps=2,
                                          decay_rate=0.5)
        pkg.optimizer.SGD(learning_rate=lr).minimize(loss)
    return main, startup, loss, lr


def fc_feeds(steps):
    r = np.random.RandomState(1)
    return {"x": r.randn(steps, 8, 4).astype("float32"),
            "y": r.randn(steps, 8, 1).astype("float32")}


def test_run_steps_matches_runs_in_counter_and_lrs():
    main, startup, loss, lr = build_fc()
    feeds = fc_feeds(4)
    exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    exe.run(startup)
    losses, lrs = exe.run_steps(main, feed=feeds, fetch_list=[loss, lr],
                                steps=4, per_step_feeds=("x", "y"))
    ref = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    ref.run(startup)
    runs = [ref.run(main, feed={k: v[i] for k, v in feeds.items()},
                    fetch_list=[loss, lr]) for i in range(4)]
    np.testing.assert_array_equal(lrs, np.stack([r[1] for r in runs]))
    np.testing.assert_array_equal(losses, np.stack([r[0] for r in runs]))
    np.testing.assert_allclose(lrs.ravel(),
                               [0.1 * 0.5 ** (s / 2) for s in range(1, 5)],
                               rtol=LR_RTOL)
    for e in (exe, ref):
        counter = e.scope.find_var(STEP)
        assert counter.dtype == torch.int64 and int(counter) == 4


def test_counter_saved_and_reloaded_resumes_at_the_next_lr(tmp_path):
    main, startup, loss, lr = build_fc()
    feeds = fc_feeds(5)
    exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    exe.run(startup)
    lrs = [exe.run(main, feed={k: v[i] for k, v in feeds.items()},
                   fetch_list=[lr])[0] for i in range(3)]
    ptt.io.save_persistables(exe, str(tmp_path), main_program=main)
    fresh = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    fresh.run(startup)
    ptt.io.load_persistables(fresh, str(tmp_path), main_program=main)
    assert int(fresh.scope.find_var(STEP)) == 3
    nxt = [fresh.run(main, feed={k: v[i] for k, v in feeds.items()},
                     fetch_list=[lr])[0] for i in (3, 4)]
    np.testing.assert_allclose(np.concatenate(lrs + nxt),
                               [0.1 * 0.5 ** (s / 2) for s in range(1, 6)],
                               rtol=LR_RTOL)
    assert math.isfinite(float(
        fresh.run(main, feed={k: v[0] for k, v in feeds.items()},
                  fetch_list=[loss])[0]))
