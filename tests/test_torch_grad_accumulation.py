"""Gradient accumulation (``minimize(accumulate_steps=k)``) in the port,
against the JAX package's program rewrite.

The accumulating program must serialize like the JAX package's (op list,
slots, attrs, var names), so a JAX-saved accumulating program and its
persistables bind by name.  A tiny LM (V 256, L 2, H 4, d_model 64,
d_inner 128, T 32, batch 2, dropout 0) built with k 2 in both packages
takes 4 micro-steps from the JAX initialisation; the state after
micro-steps 3 and 4 is held to JAX's at ``tests/test_torch_train.py``'s
tolerances (moment1 rtol 1e-4 atol 1e-7, moment2 rtol 2e-4 atol 1e-10,
pows and lr rtol 1e-6, the accumulated grads at the grads' rtol 1e-4
atol 1e-6; the counter exactly), and the params at that file's atol
2e-6 where the mean grad of each boundary is 0 or at least 1e-5 from
zero.  Nearer zero a first Adam step moves an entry by lr * g / (|g| + 3.2e-7)
(eps over sqrt(1 - beta2)), whose slope there turns a summation-order
difference of 1e-9 in g into 3e-3 of lr: those entries are held to lr.  The contract of JAX's
``tests/test_grad_accumulation.py`` (:63, :69, :165) is held in the port
alone: params frozen until the boundary, k micro-steps equal to one
big-batch Adam step, and the counter wrapping.
"""
import json

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import transformer as jtr
from paddle_tpu_torch.models import transformer as ttr

T, BATCH, K, STEPS, LR = 32, 2, 2, 4, 1e-3


def tiny_cfg(mod):
    return mod.TransformerConfig(src_vocab_size=256, max_length=T,
                                 n_layer=2, n_head=4, d_model=64,
                                 d_inner=128, dropout=0.0)


def build(pkg, tr, k=K):
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup):
        _, loss, _ = tr.build_lm_net(tiny_cfg(tr), T, fused_attention=True,
                                     fused_head=True)
        pkg.optimizer.Adam(learning_rate=LR).minimize(
            loss, accumulate_steps=k)
    return main, startup, loss


def feeds(step):
    return ttr.make_fake_lm_batch(tiny_cfg(ttr), BATCH, T, seed=300 + step)


def persistables(prog):
    return sorted(v.name for v in prog.list_vars() if v.persistable)


@pytest.fixture(autouse=True)
def fresh_port_programs():
    ptt.reset_default_programs()
    yield
    ptt.reset_default_programs()


@pytest.fixture(scope="module")
def runs():
    """Both packages' states after micro-steps 3 and 4 from the JAX
    initialisation, and the port's params after every micro-step."""
    main, startup, loss = build(pt, jtr)
    jscope = pt.Scope()
    jexe = pt.Executor(pt.CPUPlace(), scope=jscope)
    jexe.run(startup)
    names = persistables(main)
    init = {n: np.asarray(jscope.find_var(n)) for n in names}
    jax_states = []
    for step in range(STEPS):
        jexe.run(main, feed=feeds(step), fetch_list=[loss])
        if step >= 2:
            jax_states.append({n: np.asarray(jscope.find_var(n))
                               for n in names})

    tmain, _, tloss = build(ptt, ttr)
    assert persistables(tmain) == names
    tscope = ptt.Scope()
    texe = ptt.Executor(ptt.CPUPlace(), scope=tscope)
    ptt.io.params_from_numpy(tscope, init, ptt.CPUPlace())
    params = [p.name for p in tmain.all_parameters() if p.trainable]
    # each param's mean grad, the input of its gated Adam update
    gavg = {op.inputs["X"][0].split(".", 1)[1][:-len(".grad_acc")]:
            op.outputs["Out"][0] for op in tmain.global_block().ops
            if op.type == "scale" and ".grad_avg" in op.outputs["Out"][0]}
    assert sorted(gavg) == sorted(params)
    port_states, port_params = [], [{n: init[n] for n in params}]
    near_zero = {n: False for n in params}
    for step in range(STEPS):
        out = texe.run(tmain, feed=feeds(step),
                       fetch_list=[tloss] + [gavg[n] for n in params])
        if step % K == K - 1:
            for n, g in zip(params, out[1:]):
                near_zero[n] = near_zero[n] | ((g != 0) & (abs(g) < 1e-5))
        state = {n: tscope.find_var(n).numpy().copy() for n in names}
        port_params.append({n: state[n] for n in params})
        if step >= 2:
            port_states.append(state)
    return dict(jax=jax_states, port=port_states, port_params=port_params,
                main=main, startup=startup, names=names, near_zero=near_zero)


def _op_view(prog):
    return [(op.type, op.inputs, op.outputs,
             json.loads(json.dumps(op.to_dict()["attrs"])))
            for op in prog.global_block().ops]


def _var_view(prog):
    return {v.name: (tuple(v.shape or ()), v.persistable, v.stop_gradient,
                     type(v).__name__) for v in prog.list_vars()}


def test_accumulating_program_serializes_like_jax(runs):
    main, startup, _ = build(ptt, ttr)
    for mine, theirs in ((main, runs["main"]), (startup, runs["startup"])):
        assert _op_view(mine) == _op_view(theirs)
        assert _var_view(mine) == _var_view(theirs)
    # JAX computes int64 on its 32-bit plane; every float and bool var
    # agrees (the counter is f32, the boundary test bool)
    for v in runs["main"].list_vars():
        if v.dtype.startswith("float") or v.dtype == "bool":
            assert main.global_block().var(v.name).dtype == v.dtype, v.name
    types = [op.type for op in main.global_block().ops]
    n_param = len([p for p in main.all_parameters() if p.trainable])
    assert types.count("adam") == n_param
    # five vars a gated Adam update writes: a snapshot, sub, mul, add each
    assert types.count("assign") == 5 * n_param
    counter, = [n for n in persistables(main) if n.endswith(".acc_counter")]
    assert main.global_block().var(counter).dtype == "float32"
    assert len([n for n in persistables(main)
                if n.endswith(".grad_acc")]) == n_param


def _kind_names(runs, kind):
    names = runs["names"]
    params = {p.name for p in runs["main"].all_parameters()}
    if kind == "param":
        return sorted(params), dict(rtol=0, atol=2e-6)
    if kind == "moment1":
        return [n for n in names if n.endswith(".moment1")], dict(
            rtol=1e-4, atol=1e-7)
    if kind == "moment2":
        return [n for n in names if n.endswith(".moment2")], dict(
            rtol=2e-4, atol=1e-10)
    if kind == "pow_lr":
        return [n for n in names if n.endswith("_pow")
                or n.endswith(".lr")], dict(rtol=1e-6)
    if kind == "grad_acc":
        return [n for n in names if n.endswith(".grad_acc")], dict(
            rtol=1e-4, atol=1e-6)
    return [n for n in names if n.endswith(".acc_counter")], dict(rtol=0)


@pytest.mark.parametrize("kind", ["param", "moment1", "moment2", "pow_lr",
                                  "grad_acc", "counter"])
def test_four_micro_steps_match_jax(runs, kind):
    names, tol = _kind_names(runs, kind)
    assert names
    for after, j, t in zip((3, 4), runs["jax"], runs["port"]):
        for n in names:
            assert t[n].shape == j[n].shape, n
            if kind == "param" and n in runs["near_zero"]:
                near_zero = runs["near_zero"][n]
                assert near_zero.mean() < 0.05, n
                np.testing.assert_allclose(t[n][near_zero], j[n][near_zero],
                                           rtol=0, atol=LR, err_msg=n)
                t, j = ({**d, n: np.where(near_zero, 0, d[n])}
                        for d in (t, j))
            np.testing.assert_allclose(t[n], j[n], err_msg=f"{n} @{after}",
                                       **tol)
    if kind == "grad_acc":
        # micro-step 3 holds its own grads, the boundary 4 clears them
        assert all(np.abs(runs["port"][0][n]).max() > 0 for n in names)
        assert not any(runs["port"][1][n].any() for n in names)
    if kind == "counter":
        assert [s[names[0]][0] for s in runs["port"]] == [1.0, 0.0]


def test_params_frozen_until_the_boundary(runs):
    """Bit-equal to their previous values after the odd micro-steps (1,
    3), moved after the boundaries (2, 4)."""
    snaps = runs["port_params"]
    for step in range(1, STEPS + 1):
        same = [n for n in snaps[0]
                if np.array_equal(snaps[step][n], snaps[step - 1][n])]
        if step % K:
            assert len(same) == len(snaps[0]), step
        else:
            assert not same, (step, same)


def _small(k, seed=5):
    """A two-layer regression net: fc(relu) -> fc(1) -> mean."""
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = seed
    with ptt.program_guard(main, startup):
        x = ptt.layers.data("x", [6], dtype="float32")
        h = ptt.layers.fc(x, size=8, act="relu")
        loss = ptt.layers.mean(ptt.layers.fc(h, size=1))
        ptt.optimizer.Adam(learning_rate=0.05).minimize(
            loss, accumulate_steps=k)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace(), scope=scope)
    exe.run(startup)
    return main, exe, scope, loss


def test_k_micro_steps_equal_one_big_batch_step():
    """Adam over the mean of k micro-batch grads = Adam over the k-times
    batch's grad (equal micro-batches), twice over."""
    x = np.random.RandomState(3).randn(16, 6).astype("float32")
    micro = [x[i::4] for i in range(4)]
    main, exe, scope, loss = _small(4)
    for _ in range(2):
        for m in micro:
            exe.run(main, feed={"x": m}, fetch_list=[loss])
    big_main, big_exe, big_scope, big_loss = _small(1)
    for _ in range(2):
        big_exe.run(big_main, feed={"x": np.concatenate(micro)},
                    fetch_list=[big_loss])
    params = [p.name for p in main.all_parameters()]
    assert len(params) == 4
    for n in params:
        np.testing.assert_allclose(scope.find_var(n).numpy(),
                                   big_scope.find_var(n).numpy(),
                                   rtol=0, atol=1e-5, err_msg=n)


def test_accumulation_counter_wraps():
    """The f32 counter stays in [0, k): it reads 1, 0, 1, 0, ... and the
    gate still fires every k-th run after many runs."""
    x = np.random.RandomState(4).randn(8, 6).astype("float32")
    main, exe, scope, loss = _small(2)
    counter, = [v.name for v in main.list_vars()
                if v.name.endswith(".acc_counter")]
    seen = []
    for i in range(10):
        exe.run(main, feed={"x": x[i % 2::2]}, fetch_list=[loss])
        c = scope.find_var(counter)
        assert c.dtype == ptt.core.dtypes.to_torch_dtype("float32")
        seen.append(float(c[0]))
    assert seen == [1.0, 0.0] * 5
