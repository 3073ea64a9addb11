"""The stacked LSTM (models/stacked_lstm.py, bench.py's ``bench_lstm``
row) and the recurrent layers (layers/rnn.py) through both packages.

A small stacked LSTM (dict 200, T 16, emb 16, h 16, 2 layers, batch 4,
ragged masks from ``make_fake_batch``) is built and initialised in
paddle_tpu on the CPU; its parameters (the [H, 4H] recurrent weights and
[4H] gate biases among them, the same layout in both packages) and the
whole Adam state are carried into the port by name with
``io.params_from_numpy``.  Tolerances are tests/test_torch_nmt.py's (its
check helpers are used), each the same f32 math summed in another order:
loss rtol 1e-5; every @GRAD at step 1 rtol 1e-4, atol 1e-6; after step 3
every param entry atol 2e-6, moment1 rtol 1e-4 atol 1e-7, moment2 rtol
2e-4 atol 1e-10, pows rtol 1e-6.  Under FLAGS_amp_bf16 (programs built with the flag off) each of 3
steps is taken from JAX's AMP state, and the port's AMP gradient is held
to JAX's f32 one as JAX's AMP one is, its bf16 loss within 2e-2.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.analysis import lint as jlint
from paddle_tpu.models import stacked_lstm as jsl
from paddle_tpu_torch.analysis import lint as tlint
from paddle_tpu_torch.models import stacked_lstm as tsl
from test_torch_nmt import (amp_steps, check_amp_rows, check_losses,
                            check_serializes_like_jax, check_state,
                            check_step1_grads, persistables, three_steps)

DICT, T, EMB, HID, LAYERS, BATCH, STEPS, LR = 200, 16, 16, 16, 2, 4, 3, 1e-3
FWD_TOL = dict(rtol=1e-5, atol=1e-7)
PARAM_ATOL = 2e-6
LAYER_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def fresh_port_programs():
    ptt.reset_default_programs()
    yield
    ptt.reset_default_programs()
    pt.core.flags.set_flag("amp_bf16", False)
    ptt.flags.set_flag("amp_bf16", False)


def build_lstm(pkg, opt=True, **kw):
    """(main, startup, loss, grad names, prediction) of the stacked LSTM
    in fresh programs of `pkg`; `opt` attaches Adam(LR)."""
    mod = jsl if pkg is pt else tsl
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 13
    cfg = dict(dict_dim=DICT, seq_len=T, emb_dim=EMB, hidden_dim=HID,
               num_layers=LAYERS)
    cfg.update(kw)
    with pkg.program_guard(main, startup):
        _, loss, _, pred = mod.build_train_net(**cfg)
        grads = []
        if opt:
            _, pg = pkg.optimizer.Adam(learning_rate=LR).minimize(loss)
            grads = [g.name for _, g in pg]
    return main, startup, loss, grads, pred


def lstm_feed(step, batch=BATCH):
    return tsl.make_fake_batch(batch, dict_dim=DICT, seq_len=T,
                               seed=50 + step)


@pytest.fixture(scope="module")
def runs():
    return three_steps(build_lstm, [lstm_feed(i) for i in range(STEPS)])


# =====================================================================
# the build and the weights across
# =====================================================================

def test_build_serializes_like_jax():
    """Op list, slots, attrs, var names and shapes, and the params, of the
    Adam training program and its startup program."""
    theirs, mine = build_lstm(pt), build_lstm(ptt)
    check_serializes_like_jax(mine, theirs)
    types = [op.type for op in mine[0].global_block().ops]
    assert types.count("lstm") == LAYERS
    assert types.count("adam") == len(mine[3])
    for op in mine[0].global_block().ops:
        if op.type == "lstm":
            assert sorted(op.inputs) == ["Input", "Mask", "Weight"]
            assert sorted(op.outputs) == ["Hidden", "LastC", "LastH"]


def test_bench_lstm_builds_like_jax_at_full_width():
    """bench_lstm's shapes (T 100, V 30000, emb 512, h 512, 2 layers):
    JAX's op count, var shapes and param shapes."""
    kw = dict(dict_dim=30000, seq_len=100, emb_dim=512, hidden_dim=512)
    views = []
    for pkg in (pt, ptt):
        main = build_lstm(pkg, opt=False, **kw)[0]
        views.append((len(main.global_block().ops),
                      sorted((v.name, tuple(v.shape or ()))
                             for v in main.list_vars()),
                      sorted((p.name, tuple(p.shape))
                             for p in main.all_parameters())))
    assert views[0] == views[1]
    shapes = dict(views[1][2])
    assert sorted(s for n, s in shapes.items() if n.startswith(
        "dynamic_lstm")) == [(512, 2048)] * 2 + [(2048,)] * 2


def test_jax_initialised_lstm_binds_by_name():
    """Every persistable of the JAX-initialised Adam program binds into
    the port's scope by name with JAX's shape, dtype and values (the
    recurrent weights [H, 4H], the gate biases [4H]); the forward on the
    bound params gives JAX's loss and prediction at FWD_TOL."""
    main, startup, _, _, _ = build_lstm(pt)
    jscope = pt.Scope()
    pt.Executor(pt.CPUPlace(), scope=jscope).run(startup)
    names = persistables(main)
    init = {n: np.asarray(jscope.find_var(n)) for n in names}
    tmain = build_lstm(ptt)[0]
    assert persistables(tmain) == names
    tscope = ptt.Scope()
    ptt.io.params_from_numpy(tscope, init, ptt.CPUPlace())
    for n, a in init.items():
        t = tscope.find_var(n)
        assert tuple(t.shape) == a.shape, n
        assert str(t.dtype).split(".")[-1] == str(a.dtype), n
        np.testing.assert_array_equal(t.numpy(), a, err_msg=n)
    recurrent = [n for n in names if n.startswith("dynamic_lstm")]
    assert sorted(init[n].shape for n in recurrent) == \
        [(HID, HID * 4)] * LAYERS + [(HID * 4,)] * LAYERS
    # the forward alone (no optimizer) on the same params
    main, _, loss, _, pred = build_lstm(pt, opt=False)
    tmain, _, tloss, _, tpred = build_lstm(ptt, opt=False)
    feed = lstm_feed(9)
    jl, jp = pt.Executor(pt.CPUPlace(), scope=jscope).run(
        main, feed=feed, fetch_list=[loss, pred])
    tl, tp = ptt.Executor(ptt.CPUPlace(), scope=tscope).run(
        tmain, feed=feed, fetch_list=[tloss, tpred])
    np.testing.assert_allclose(tp, np.asarray(jp), **FWD_TOL)
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-5)


# =====================================================================
# training: Adam, f32 and AMP
# =====================================================================

def test_losses_match_step_for_step(runs):
    check_losses(runs)


def test_every_grad_matches_at_step_1(runs):
    check_step1_grads(runs)


@pytest.mark.parametrize("kind", ["param", "moment1", "moment2", "pows"])
def test_state_after_three_steps_matches(runs, kind):
    """Every param entry at PARAM_ATOL with no near-zero carve-out
    (readings up to 1.5e-7: no grad here is small enough for Adam's
    epsilon to amplify its rounding), the moments and pows at
    tests/test_torch_nmt.py's tolerances; every param moved."""
    if kind != "param":
        check_state(runs, kind)
        return
    j, t = runs["jax"]["state"], runs["port"]["state"]
    params = [p.name for p in runs["main"].all_parameters()]
    assert params
    for n in params:
        assert t[n].shape == j[n].shape, n
        np.testing.assert_allclose(t[n], j[n], rtol=0, atol=PARAM_ATOL,
                                   err_msg=n)
        assert not np.array_equal(t[n], runs["init"][n]), n


def test_amp_step_is_as_close_to_f32_as_jax_amp():
    """Each of 3 steps from JAX's AMP state: the port's bf16 loss within
    2e-2 of JAX's (AMP and f32), its AMP gradient no further from JAX's
    f32 one than 1.5x JAX's AMP distance plus 0.01, the master grads
    f32."""
    check_amp_rows(amp_steps(build_lstm, [lstm_feed(i) for i in
                                          range(STEPS)]))


# =====================================================================
# the recurrent layers
# =====================================================================

def build_layers(pkg):
    """Every layer of layers/rnn.py in one program: lstm_layer (reverse,
    with h_0 and c_0) and dynamic_gru over a masked [B, T, 8] sequence,
    and one lstm_unit and gru_unit step; returns (main, startup, fetch
    vars)."""
    L = pkg.layers
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.program_guard(main, startup):
        x = L.data("x", [6, 8])
        mask = L.data("mask", [6])
        h0 = L.data("h0", [5])
        c0 = L.data("c0", [5])
        hid, last_c = L.lstm_layer(x, 5, h_0=h0, c_0=c0, mask=mask,
                                   is_reverse=True)
        proj = L.fc(x, size=3 * 4, num_flatten_dims=2, bias_attr=False)
        gru = L.dynamic_gru(proj, 4, mask=mask, is_reverse=False)
        xt = L.data("xt", [8])
        h_unit, c_unit = L.lstm_unit(xt, h0, c0, forget_bias=1.0)
        g_in = L.fc(xt, size=3 * 5, bias_attr=False)
        g_h, g_gate, g_reset = L.gru_unit(g_in, h0, 3 * 5)
    return main, startup, [hid, last_c, gru, h_unit, c_unit, g_h, g_gate,
                           g_reset]


def test_rnn_layers_serialize_and_run_like_jax():
    """layers/rnn.py's five layers: the program serializes like JAX's, and
    from JAX's initialisation the port's outputs match at LAYER_TOL on a
    padded batch."""
    jmain, jstartup, jfetch = build_layers(pt)
    tmain, tstartup, tfetch = build_layers(ptt)
    check_serializes_like_jax((tmain, tstartup), (jmain, jstartup))
    types = [op.type for op in tmain.global_block().ops]
    assert {t: types.count(t) for t in ("lstm", "gru", "lstm_unit",
                                        "gru_unit", "concat")} == \
        {"lstm": 1, "gru": 1, "lstm_unit": 1, "gru_unit": 1, "concat": 1}
    jscope = pt.Scope()
    jexe = pt.Executor(pt.CPUPlace(), scope=jscope)
    jexe.run(jstartup)
    init = {n: np.asarray(jscope.find_var(n)) for n in persistables(jmain)}
    r = np.random.RandomState(4)
    feed = {"x": r.randn(3, 6, 8).astype("float32"),
            "mask": (np.arange(6)[None] < np.array([[6], [3], [5]])).astype(
                "float32"),
            "h0": r.randn(3, 5).astype("float32"),
            "c0": r.randn(3, 5).astype("float32"),
            "xt": r.randn(3, 8).astype("float32")}
    want = jexe.run(jmain, feed=feed, fetch_list=jfetch)
    tscope = ptt.Scope()
    ptt.io.params_from_numpy(tscope, init, ptt.CPUPlace())
    got = ptt.Executor(ptt.CPUPlace(), scope=tscope).run(
        tmain, feed=feed, fetch_list=tfetch)
    for v, a, b in zip(tfetch, got, want):
        assert a.shape == np.asarray(b).shape, v.name
        np.testing.assert_allclose(a, np.asarray(b), err_msg=v.name,
                                   **LAYER_TOL)
    # the reverse LSTM meets a row's pad steps first: they carry h0 in,
    # so the hidden state of a row of length 3 is h0 from step 3 on
    np.testing.assert_array_equal(got[0][1, 3:], np.broadcast_to(
        feed["h0"][1], (3, 5)))


def test_masked_steps_carry_the_state():
    """dynamic_lstm and dynamic_gru forward over a right-padded batch: a
    row's hidden state at every pad step equals its last real step's, bit
    for bit, in both packages."""
    outs = []
    for pkg in (pt, ptt):
        L = pkg.layers
        pkg.reset_default_programs()
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 8
        with pkg.program_guard(main, startup):
            x = L.data("x", [7, 12])
            mask = L.data("mask", [7])
            hid, _ = L.dynamic_lstm(x, 12, mask=mask)
            gru = L.dynamic_gru(L.fc(x, size=9, num_flatten_dims=2), 3,
                                mask=mask)
        scope = pkg.Scope()
        exe = pkg.Executor(pkg.CPUPlace(), scope=scope)
        if pkg is pt:
            exe.run(startup)
            init = {n: np.asarray(scope.find_var(n))
                    for n in persistables(main)}
        else:
            ptt.io.params_from_numpy(scope, init, ptt.CPUPlace())
        r = np.random.RandomState(2)
        lens = np.array([7, 2, 5, 4])
        feed = {"x": r.randn(4, 7, 12).astype("float32"),
                "mask": (np.arange(7)[None] < lens[:, None]).astype(
                    "float32")}
        outs.append([np.asarray(a) for a in exe.run(
            main, feed=feed, fetch_list=[hid, gru])])
        for a in outs[-1]:
            for row, n in enumerate(lens):
                np.testing.assert_array_equal(
                    a[row, n:], np.broadcast_to(a[row, n - 1],
                                                a[row, n:].shape))
    for a, b in zip(outs[1], outs[0]):
        np.testing.assert_allclose(a, b, **LAYER_TOL)


def test_lint_counts_match_the_jax_cli():
    mine = tlint.lint_model("stacked_lstm",
                            tlint.model_builders()["stacked_lstm"])
    theirs = jlint.lint_model("stacked_lstm",
                              jlint.model_builders()["stacked_lstm"])
    assert mine == theirs == (0, 0)
