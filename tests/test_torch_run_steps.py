"""Executor.run_steps in the port: N training steps in one call, against
the JAX package's run_steps and against N sequential runs.

The flagship's training program at smoke shapes (V 256, L 2, H 4,
d_model 64, d_inner 128, T 32, batch 2, dropout 0; the fused attention
build with the streamed head) takes 3 steps through JAX's run_steps and
the port's from the same JAX initialisation, with per-step token slabs:
the stacked losses at rtol 1e-5, and params, moments, pows and lr at
``tests/test_torch_train.py``'s tolerances (params atol 2e-6, moment1
rtol 1e-4 atol 1e-7, moment2 rtol 2e-4 atol 1e-10, pows and lr rtol
1e-6), the params where each step's grad is 0 or at least 1e-5 from
zero (nearer zero, held to lr: Adam's step there is a steep function of
a grad that summation order moves, ``tests/test_torch_grad_accumulation.py``
has the arithmetic).  JAX's test of the RNG stream (``tests/test_run_steps.py``) cannot
carry over: torch's Philox draws other bits than threefry.  In the port
alone, the unfused build at dropout 0.1 gives the same bits through
run_steps(4) as through 4 runs, with constant feeds and with slabs.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import transformer as jtr
from paddle_tpu_torch.core.enforce import EnforceNotMet, InvalidArgumentError
from paddle_tpu_torch.framework.executor import check_slabs
from paddle_tpu_torch.models import transformer as ttr

T, BATCH, STEPS, LR = 32, 2, 3, 1e-3
PER_STEP = ("tokens", "labels")


def tiny_cfg(mod, dropout=0.0):
    return mod.TransformerConfig(src_vocab_size=256, max_length=T,
                                 n_layer=2, n_head=4, d_model=64,
                                 d_inner=128, dropout=dropout)


def build(pkg, tr, dropout=0.0, fused_attention=True, seed=13):
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = seed
    startup.random_seed = 13
    with pkg.program_guard(main, startup):
        _, loss, _ = tr.build_lm_net(tiny_cfg(tr, dropout), T,
                                     fused_attention=fused_attention,
                                     fused_head=True)
        pkg.optimizer.Adam(learning_rate=LR).minimize(loss)
    return main, startup, loss


def slabs(n, seed=400):
    bs = [ttr.make_fake_lm_batch(tiny_cfg(ttr), BATCH, T, seed=seed + i)
          for i in range(n)]
    return {k: np.stack([b[k] for b in bs]) for k in PER_STEP}


def persistables(prog):
    return sorted(v.name for v in prog.list_vars() if v.persistable)


@pytest.fixture(autouse=True)
def fresh_port_programs():
    ptt.reset_default_programs()
    yield
    ptt.reset_default_programs()


@pytest.fixture(scope="module")
def runs():
    main, startup, loss = build(pt, jtr)
    jscope = pt.Scope()
    jexe = pt.Executor(pt.CPUPlace(), scope=jscope)
    jexe.run(startup)
    names = persistables(main)
    init = {n: np.asarray(jscope.find_var(n)) for n in names}
    feed = slabs(STEPS)
    jloss, = jexe.run_steps(main, feed=feed, fetch_list=[loss],
                            steps=STEPS, per_step_feeds=PER_STEP)
    jstate = {n: np.asarray(jscope.find_var(n)) for n in names}

    tmain, _, tloss = build(ptt, ttr)
    assert persistables(tmain) == names
    tscope = ptt.Scope()
    texe = ptt.Executor(ptt.CPUPlace(), scope=tscope)
    ptt.io.params_from_numpy(tscope, init, ptt.CPUPlace())
    params = [p.name for p in tmain.all_parameters() if p.trainable]
    out = texe.run_steps(tmain, feed=feed, fetch_list=[tloss] + [
        n + "@GRAD" for n in params], steps=STEPS, per_step_feeds=PER_STEP)
    tstate = {n: tscope.find_var(n).numpy() for n in names}
    near_zero = {n: ((g != 0) & (abs(g) < 1e-5)).any(0)
                 for n, g in zip(params, out[1:])}
    return dict(jax_loss=np.asarray(jloss), port_loss=out[0], main=main,
                jax=jstate, port=tstate, init=init, near_zero=near_zero)


def test_run_steps_losses_match_jax(runs):
    j, t = runs["jax_loss"], runs["port_loss"]
    assert j.shape == t.shape == (STEPS, 1)
    np.testing.assert_allclose(t, j, rtol=1e-5)
    assert len(set(t.ravel().tolist())) == STEPS


@pytest.mark.parametrize("kind", ["param", "moment1", "moment2", "pow_lr"])
def test_run_steps_state_matches_jax(runs, kind):
    j, t = runs["jax"], runs["port"]
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
        if kind == "param" and n in runs["near_zero"]:
            near_zero = runs["near_zero"][n]
            assert near_zero.mean() < 0.05, n
            np.testing.assert_allclose(t[n][near_zero], j[n][near_zero],
                                       rtol=0, atol=LR, err_msg=n)
            t, j = ({**d, n: np.where(near_zero, 0, d[n])} for d in (t, j))
        np.testing.assert_allclose(t[n], j[n], err_msg=n, **tol)
    if kind == "pow_lr":   # three steps advanced the pows
        b1 = [n for n in names if n.endswith("beta1_pow")][0]
        np.testing.assert_allclose(t[b1], [0.9 ** (STEPS + 1)], rtol=1e-6)


def _dropout_run(per_step, use_run_steps, steps=4):
    """The unfused build at dropout 0.1 from one startup: losses, the
    embedding dropout's masks and the final state, through run_steps or
    one run per step.  The main program is unseeded, so each run folds
    the run counter into its seed and draws new masks."""
    main, startup, loss = build(ptt, ttr, dropout=0.1,
                                fused_attention=False, seed=None)
    mask = next(op.outputs["Mask"][0] for op in main.global_block().ops
                if op.type == "dropout")
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace(), scope=scope)
    exe.run(startup)
    feed = slabs(steps) if per_step else {
        k: v[0] for k, v in slabs(1).items()}
    if use_run_steps:
        out = exe.run_steps(main, feed=feed, fetch_list=[loss, mask],
                            steps=steps,
                            per_step_feeds=PER_STEP if per_step else ())
    else:
        outs = [exe.run(main, feed={k: v[i] if per_step else v
                                    for k, v in feed.items()},
                        fetch_list=[loss, mask]) for i in range(steps)]
        out = [np.stack([o[j] for o in outs]) for j in range(2)]
    state = {n: scope.find_var(n).numpy() for n in persistables(main)}
    return out, state


@pytest.mark.parametrize("per_step", [False, True],
                         ids=["constant", "slabs"])
def test_run_steps_is_bit_equal_to_sequential_runs_with_dropout(per_step):
    (loss, masks), state = _dropout_run(per_step, True)
    (want_loss, want_masks), want_state = _dropout_run(per_step, False)
    assert loss.shape == (4, 1) and masks.shape == (4, BATCH, T, 64)
    assert masks.dtype == np.uint8
    np.testing.assert_array_equal(loss, want_loss)
    np.testing.assert_array_equal(masks, want_masks)
    assert sorted(state) == sorted(want_state)
    for n in state:
        np.testing.assert_array_equal(state[n], want_state[n], err_msg=n)
    # each step drew its own masks, each keeping about 0.9
    assert not np.array_equal(masks[0], masks[1])
    assert abs(masks.mean() - 0.9) < 0.01


def test_run_steps_returns_tensors_and_refuses_bad_slabs():
    main, startup, loss = build(ptt, ttr)
    exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    exe.run(startup)
    feed = slabs(2)
    got, = exe.run_steps(main, feed=feed, fetch_list=[loss], steps=2,
                         per_step_feeds=PER_STEP, return_numpy=False)
    assert isinstance(got, torch.Tensor) and got.shape == (2, 1)
    with pytest.raises(InvalidArgumentError, match="leading dim 2"):
        exe.run_steps(main, feed=feed, fetch_list=[loss], steps=3,
                      per_step_feeds=PER_STEP)
    with pytest.raises(InvalidArgumentError, match="not in feed"):
        exe.run_steps(main, feed={"tokens": feed["tokens"]},
                      fetch_list=[loss], steps=2, per_step_feeds=PER_STEP)
    with pytest.raises(InvalidArgumentError, match="steps must be"):
        exe.run_steps(main, feed=feed, fetch_list=[loss], steps=0)


def test_slab_check_reads_the_shape_without_a_copy():
    """A meta tensor has no data: np.asarray of it raises.  The check
    reads its .shape, so a meta slab of the right leading dim passes and
    one of another names its dim."""
    meta = {k: torch.empty(4, BATCH, T, dtype=torch.int64, device="meta")
            for k in PER_STEP}
    with pytest.raises(Exception):
        np.asarray(meta["tokens"])
    check_slabs(meta, frozenset(PER_STEP), 4)
    with pytest.raises(InvalidArgumentError, match="leading dim 4 != steps 3"):
        check_slabs(meta, frozenset(PER_STEP), 3)
    main, startup, loss = build(ptt, ttr)
    exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    with pytest.raises(InvalidArgumentError, match="leading dim"):
        exe.run_steps(main, feed=meta, fetch_list=[loss], steps=5,
                      per_step_feeds=PER_STEP)


def _nan_net():
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data("x", [4], dtype="float32")
        h = ptt.layers.fc(x, size=3)
        loss = ptt.layers.mean(h)
        ptt.optimizer.Adam(0.1).minimize(loss)
    exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    exe.run(startup)
    x = np.ones((2, 4), "float32")
    x[1, 2] = np.nan
    return main, exe, loss, x


@pytest.mark.parametrize("flag,match", [
    ("check_nan_inf", "NaN/Inf detected in fetch 'mean"),
    ("check_nan_inf_per_op", "NaN/Inf produced by op 'mul' in output "
                             "Out:'fc"),
])
def test_nan_inf_checks_name_the_fetch_or_the_op(flag, match):
    main, exe, loss, x = _nan_net()
    ptt.flags.set_flag(flag, True)
    try:
        clean = np.ones((2, 4), "float32")
        out, = exe.run_steps(main, feed={"x": clean}, fetch_list=[loss],
                             steps=2)
        assert out.shape[0] == 2 and np.isfinite(out).all()
        with pytest.raises(EnforceNotMet, match=match):
            exe.run_steps(main, feed={"x": np.stack([clean, x])},
                          fetch_list=[loss], steps=2, per_step_feeds=("x",))
        with pytest.raises(EnforceNotMet, match=match):
            exe.run(main, feed={"x": x}, fetch_list=[loss])
    finally:
        ptt.flags.set_flag(flag, False)
    # off (the default): the NaN goes through unreported
    out, = exe.run(main, feed={"x": x}, fetch_list=[loss])
    assert np.isnan(out).all()


def test_per_op_check_names_the_first_op_that_made_one():
    """An Inf fed into the product is blamed on the product; an Inf fed
    into the bias add on the add, not on the mean after it."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data("x", [4], dtype="float32")
        y = ptt.layers.data("y", [3], dtype="float32")
        h = ptt.layers.fc(x, size=3)
        loss = ptt.layers.mean(ptt.layers.elementwise_add(h, y))
        ptt.optimizer.Adam(0.1).minimize(loss)
    exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    exe.run(startup)
    x = np.ones((2, 4), "float32")
    x[0, 0] = np.inf
    y = np.full((2, 3), -np.inf, "float32")
    ptt.flags.set_flag("check_nan_inf_per_op", True)
    try:
        with pytest.raises(EnforceNotMet, match="op 'mul'"):
            exe.run(main, feed={"x": x, "y": np.zeros((2, 3), "float32")})
        x[0, 0] = 1.0
        with pytest.raises(EnforceNotMet, match="op 'elementwise_add'"):
            exe.run(main, feed={"x": x, "y": y})
    finally:
        ptt.flags.set_flag("check_nan_inf_per_op", False)
