"""Transformer-base NMT (models/transformer.py ``build_train_net``, the
encoder-decoder of bench.py's ``bench_nmt`` row) through both packages.

A small NMT (source V 96, target V 80, L 2, H 4, d_model 32, d_inner 64,
source T 12, target T 10, batch 4, dropout 0, label smoothing 0.1) is
built and initialised in paddle_tpu on the CPU; its parameters and whole
Adam state are carried into the port with ``io.params_from_numpy``.  The
masks are ragged (every other sequence right-padded in src_mask and
tgt_mask), so the pad biases, the causal constant, the label-smoothed
soft-label loss and the token-count division all act.  Tolerances are
``tests/test_torch_train.py``'s, each the same f32 math summed in
another order:

- loss per step: rtol 1e-5 (a 0-d tensor in both packages);
- every ``@GRAD`` at step 1: rtol 1e-4, atol 1e-6;
- after step 3: params atol 2e-6, moment1 rtol 1e-4 atol 1e-7, moment2
  rtol 2e-4 atol 1e-10, pows and lr rtol 1e-6; a param entry whose grad
  came within 1e-5 of zero (not 0) on some step is held to lr instead
  (Adam moves it by lr * g / (|g| + 3.2e-7), a steep function of a grad
  that the summation order moves; ``tests/test_torch_run_steps.py``).

Under FLAGS_amp_bf16 (each program built with the flag off: the JAX
build would declare bf16 params, ROADMAP queue C) each of 3 steps is
taken from JAX's AMP state before it by JAX in f32, JAX under AMP and
the port under AMP; the port's AMP gradient is held to JAX's f32 one as
JAX's AMP one is (AMP_GRAD_SLACK on the distance ||AMP - f32|| / ||f32||
over all the @GRADs), its bf16 loss to JAX's AMP loss within the
reference's bf16 tolerance 2e-2.  The ``is_test`` build saved by JAX is
served by the port's Predictor at rtol 1e-4 (atol 1e-6) in f32.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.analysis import lint as jlint
from paddle_tpu.inference import predictor as jpred
from paddle_tpu.models import transformer as jtr
from paddle_tpu_torch.analysis import lint as tlint
from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
from paddle_tpu_torch.models import transformer as ttr
from test_torch_train import _op_view, _var_view

SRC_T, TGT_T, BATCH, STEPS, LR = 12, 10, 4, 3, 1e-3
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
NEAR_ZERO = 1e-5
AMP_LOSS_RTOL = 2e-2        # the reference's bf16 tolerance
AMP_GRAD_SLACK = (1.5, 0.01)
PRED_TOL = dict(rtol=1e-4, atol=1e-6)
AMP_PRED_RTOL = 2e-2        # of max |JAX|
SERVE_FEEDS = ["src_ids", "tgt_ids", "src_mask", "tgt_mask"]


def tiny_cfg(mod, eps=0.1):
    return mod.TransformerConfig(src_vocab_size=96, tgt_vocab_size=80,
                                 max_length=16, n_layer=2, n_head=4,
                                 d_model=32, d_inner=64, dropout=0.0,
                                 label_smooth_eps=eps)


@pytest.fixture(autouse=True)
def fresh_port_programs():
    ptt.reset_default_programs()
    yield
    ptt.reset_default_programs()
    pt.core.flags.set_flag("amp_bf16", False)
    ptt.flags.set_flag("amp_bf16", False)


def build_nmt(pkg, is_test=False, eps=0.1, opt=True):
    """(main, startup, loss, grad names, logits) of the small NMT in fresh
    programs of `pkg`; `opt` attaches Adam(LR)."""
    mod = jtr if pkg is pt else ttr
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup):
        _, loss, logits = mod.build_train_net(tiny_cfg(mod, eps), SRC_T,
                                              TGT_T, is_test=is_test)
        grads = []
        if opt and not is_test:
            _, pg = pkg.optimizer.Adam(learning_rate=LR).minimize(loss)
            grads = [g.name for _, g in pg]
    return main, startup, loss, grads, logits


def ragged(feed, masks, seed):
    """Every other sequence of `feed` right-padded past a seeded length in
    each mask of `masks` (0 there)."""
    rng = np.random.RandomState(seed)
    for k in masks:
        T = feed[k].shape[1]
        for i in range(0, feed[k].shape[0], 2):
            feed[k][i, rng.randint(1, T):] = 0
    return feed


def nmt_feed(step, batch=BATCH):
    feed = ttr.make_fake_batch(tiny_cfg(ttr), batch, SRC_T, TGT_T,
                               seed=200 + step)
    return ragged(feed, ("src_mask", "tgt_mask"), 300 + step)


def persistables(prog):
    return sorted(v.name for v in prog.list_vars() if v.persistable)


def scalar(a):
    return float(np.asarray(a, np.float32).reshape(()))


def three_steps(build, feeds):
    """Both packages' Adam trajectories over `feeds` from the JAX
    initialisation of build(pkg) = (main, startup, loss, grads, ...):
    losses, step-1 grads, the final states, and where a grad came near
    zero."""
    main, startup, loss, grads, *_ = build(pt)
    jscope = pt.Scope()
    jexe = pt.Executor(pt.CPUPlace(), scope=jscope)
    jexe.run(startup)
    names = persistables(main)
    init = {n: np.asarray(jscope.find_var(n)) for n in names}
    tmain, _, tloss, tgrads, *_ = build(ptt)
    assert persistables(tmain) == names and tgrads == grads
    tscope = ptt.Scope()
    texe = ptt.Executor(ptt.CPUPlace(), scope=tscope)
    ptt.io.params_from_numpy(tscope, init, ptt.CPUPlace())
    out = {"jax": {"loss": [], "grads": []}, "port": {"loss": [],
                                                      "grads": []}}
    for feed in feeds:
        for side, exe, prog, fetch in (("jax", jexe, main, [loss] + grads),
                                       ("port", texe, tmain,
                                        [tloss] + tgrads)):
            res = exe.run(prog, feed=feed, fetch_list=fetch)
            out[side]["loss"].append(np.asarray(res[0]))
            out[side]["grads"].append(dict(zip(grads, map(np.asarray,
                                                          res[1:]))))
    out["jax"]["state"] = {n: np.asarray(jscope.find_var(n)) for n in names}
    out["port"]["state"] = {n: tscope.find_var(n).numpy() for n in names}
    params = [p.name for p in main.all_parameters() if p.trainable]
    out["near_zero"] = {
        n: np.any([(g[n + "@GRAD"] != 0) & (abs(g[n + "@GRAD"]) < NEAR_ZERO)
                   for g in out["jax"]["grads"] + out["port"]["grads"]], 0)
        for n in params}
    out.update(main=main, startup=startup, init=init, grads=grads)
    return out


def check_losses(runs):
    j, t = runs["jax"]["loss"], runs["port"]["loss"]
    assert len(j) == len(t) == STEPS
    for a, b in zip(t, j):
        assert a.shape == b.shape == ()
        np.testing.assert_allclose(a, b, rtol=LOSS_RTOL)


def check_step1_grads(runs):
    j, t = runs["jax"]["grads"][0], runs["port"]["grads"][0]
    assert sorted(j) == sorted(t) == sorted(runs["grads"])
    for name in j:
        assert t[name].shape == j[name].shape, name
        np.testing.assert_allclose(t[name], j[name], err_msg=name,
                                   **GRAD_TOL)
        assert np.abs(t[name]).max() > 0, name


def check_state(runs, kind):
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
        got, want = t[n], j[n]
        assert got.shape == want.shape, n
        if kind == "param" and n in runs["near_zero"]:
            near = runs["near_zero"][n]
            assert near.mean() < 0.05, n
            np.testing.assert_allclose(got[near], want[near], rtol=0,
                                       atol=LR, err_msg=n)
            got, want = np.where(near, 0, got), np.where(near, 0, want)
        np.testing.assert_allclose(got, want, err_msg=n, **tol)
    if kind == "param":   # the trainable params moved, the tables did not
        moved = sorted(n for n in names
                       if not np.array_equal(t[n], runs["init"][n]))
        assert moved == sorted(p.name for p in runs["main"].all_parameters()
                               if p.trainable)


def check_serializes_like_jax(mine, theirs):
    for t, j in ((mine[0], theirs[0]), (mine[1], theirs[1])):
        assert _op_view(t) == _op_view(j)
        assert _var_view(t) == _var_view(j)
    assert ({p.name: (tuple(p.shape), p.dtype, p.trainable)
             for p in mine[0].all_parameters()}
            == {p.name: (tuple(p.shape), p.dtype, p.trainable)
                for p in theirs[0].all_parameters()})
    for v in theirs[0].list_vars():
        if v.dtype.startswith("float"):
            assert mine[0].global_block().var(v.name).dtype == v.dtype, \
                v.name


def amp_steps(build, feeds):
    """Each step from JAX's AMP state before it (programs built with the
    flag off): JAX f32, JAX AMP and port AMP from the same state; per
    step (JAX f32 loss, JAX AMP loss, port AMP loss, port loss dtype,
    d_jax, d_port, the port's grad dtypes), d = ||AMP grads - f32
    grads|| / ||f32 grads|| over every @GRAD."""
    main, startup, loss, grads, *_ = build(pt)
    jscope = pt.Scope()
    jexe = pt.Executor(pt.CPUPlace(), scope=jscope)
    jexe.run(startup)
    names = persistables(main)
    state = {n: np.asarray(jscope.find_var(n)) for n in names}
    tmain, _, tloss, tgrads, *_ = build(ptt)
    tscope = ptt.Scope()
    texe = ptt.Executor(ptt.CPUPlace(), scope=tscope)

    def flat(arrays):
        return np.concatenate([np.asarray(a, np.float64).ravel()
                               for a in arrays])

    rows = []
    for feed in feeds:
        def jax_step(amp):
            for n, a in state.items():
                jscope.set_var(n, a)
            pt.core.flags.set_flag("amp_bf16", amp)
            try:
                out = jexe.run(main, feed=feed, fetch_list=[loss] + grads)
            finally:
                pt.core.flags.set_flag("amp_bf16", False)
            return scalar(out[0]), flat(out[1:])

        fl, fg = jax_step(False)
        al, ag = jax_step(True)
        after = {n: np.asarray(jscope.find_var(n)) for n in names}
        ptt.io.params_from_numpy(tscope, state, ptt.CPUPlace())
        ptt.flags.set_flag("amp_bf16", True)
        try:
            out = texe.run(tmain, feed=feed, fetch_list=[tloss] + tgrads,
                           return_numpy=False)
        finally:
            ptt.flags.set_flag("amp_bf16", False)
        tg = flat([g.float().numpy() for g in out[1:]])
        norm = np.linalg.norm(fg)
        rows.append((fl, al, float(out[0].float()), out[0].dtype,
                     float(np.linalg.norm(ag - fg) / norm),
                     float(np.linalg.norm(tg - fg) / norm),
                     {g.dtype for g in out[1:]}))
        state = after
    return rows


def check_amp_rows(rows):
    k, c = AMP_GRAD_SLACK
    for step, (fl, al, tl, dtype, d_jax, d_port, gdtypes) in enumerate(rows):
        # the forward ran on bf16 activations, its loss among them; the
        # master params' grads are f32
        assert dtype == torch.bfloat16 and gdtypes == {torch.float32}
        assert abs(tl - al) <= AMP_LOSS_RTOL * abs(al), (step, tl, al)
        assert abs(tl - fl) <= AMP_LOSS_RTOL * abs(fl), (step, tl, fl)
        assert 0 < d_port <= k * d_jax + c, (step, d_port, d_jax)


# =====================================================================
# the build
# =====================================================================

@pytest.mark.parametrize("variant", ["train", "is_test", "hard_labels"])
def test_build_serializes_like_jax(variant):
    """Op list, slots, attrs, var names and shapes (the 0-d loss among
    them), and the params, of the Adam training program (label-smoothed,
    or eps 0: the hard-label loss) and of the is_test build, with their
    startup programs."""
    kw = {"train": {}, "is_test": {"is_test": True},
          "hard_labels": {"eps": 0.0}}[variant]
    theirs, mine = build_nmt(pt, **kw), build_nmt(ptt, **kw)
    check_serializes_like_jax(mine, theirs)
    types = [op.type for op in mine[0].global_block().ops]
    smoothed = variant == "train"
    assert ("one_hot" in types) == smoothed
    assert types.count("layer_norm") == 2 * 2 + 1 + 3 * 2 + 1
    assert types.count("assign_value") == 1          # the causal constant
    assert tuple(mine[2].shape) == ()
    assert types.count("adam") == (0 if variant == "is_test" else
                                   len(mine[3]))


def test_bench_nmt_builds_like_jax_at_full_width():
    """bench_nmt's configuration (V 8000, L 6, d 512, d_inner 2048, S 64):
    the same op list and parameter shapes in both packages."""
    views = []
    for pkg, mod in ((pt, jtr), (ptt, ttr)):
        pkg.reset_default_programs()
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            cfg = mod.TransformerConfig(src_vocab_size=8000,
                                        tgt_vocab_size=8000, n_layer=6,
                                        n_head=8, d_model=512, d_inner=2048,
                                        dropout=0.0)
            _, loss, logits = mod.build_train_net(cfg, 64, 64)
        views.append(([op.type for op in main.global_block().ops],
                      sorted((p.name, tuple(p.shape))
                             for p in main.all_parameters()),
                      tuple(loss.shape), tuple(logits.shape)))
    assert views[0] == views[1]
    assert views[1][0].count("layer_norm") == 32
    assert views[1][2:] == ((), (-1, 64, 8000))


# =====================================================================
# training: Adam, f32, from JAX's initial state
# =====================================================================

@pytest.fixture(scope="module")
def runs():
    return three_steps(build_nmt, [nmt_feed(s) for s in range(STEPS)])


def test_losses_match_step_for_step(runs):
    check_losses(runs)


def test_every_grad_matches_at_step_1(runs):
    # 2 embeddings; the encoder 10 a layer; the decoder 16 a layer; two
    # final layer norms and the head
    assert len(runs["grads"]) == 2 + 10 * 2 + 16 * 2 + 4 + 1
    check_step1_grads(runs)


@pytest.mark.parametrize("kind", ["param", "moment1", "moment2", "pow_lr"])
def test_state_after_three_steps_matches(runs, kind):
    check_state(runs, kind)


def test_pads_and_their_labels_change_nothing():
    """What a pad holds (its source or target token, its label) reaches
    neither the loss nor any gradient: the -1e9 bias gives its key a
    weight of exactly 0, causal attention keeps a right pad out of
    earlier queries, and its cost is weighted 0."""
    main, startup, loss, grads, _ = build_nmt(ptt)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace(), scope=scope)
    exe.run(startup)
    feed = nmt_feed(0)
    state = {n: scope.find_var(n).numpy().copy()
             for n in persistables(main)}
    rng = np.random.RandomState(5)
    other = {k: v.copy() for k, v in feed.items()}
    for ids, mask, V in (("src_ids", "src_mask", 96),
                         ("tgt_ids", "tgt_mask", 80),
                         ("lbl_ids", "tgt_mask", 80)):
        pad = feed[mask] == 0
        assert pad.any()
        other[ids][pad] = rng.randint(1, V, int(pad.sum()))
    outs = []
    for f in (feed, other):
        ptt.io.params_from_numpy(scope, state, ptt.CPUPlace())
        outs.append(exe.run(main, feed=f, fetch_list=[loss] + grads))
    assert not np.array_equal(other["src_ids"], feed["src_ids"])
    for name, a, b in zip(["loss"] + grads, *outs):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9,
                                   err_msg=name)


def test_run_steps_stacks_the_0d_loss():
    """run_steps over per-step slabs of all five feeds gives the 0-d loss
    of each step, stacked to [steps], bit-equal to as many runs."""
    main, startup, loss, _, _ = build_nmt(ptt)
    feeds = [nmt_feed(s) for s in range(STEPS)]
    slabs = {k: np.stack([f[k] for f in feeds]) for k in feeds[0]}
    out = []
    for steps in (False, True):
        scope = ptt.Scope()
        exe = ptt.Executor(ptt.CPUPlace(), scope=scope)
        exe.run(startup)
        if steps:
            got, = exe.run_steps(main, feed=slabs, fetch_list=[loss],
                                 steps=STEPS, per_step_feeds=list(slabs))
        else:
            got = np.stack([exe.run(main, feed=f, fetch_list=[loss])[0]
                            for f in feeds])
        out.append((got, {n: scope.find_var(n).numpy()
                          for n in persistables(main)}))
    assert out[0][0].shape == out[1][0].shape == (STEPS,)
    np.testing.assert_array_equal(out[1][0], out[0][0])
    for n in out[0][1]:
        np.testing.assert_array_equal(out[1][1][n], out[0][1][n], n)


# =====================================================================
# AMP
# =====================================================================

def test_amp_step_is_as_close_to_f32_as_jax_amp():
    check_amp_rows(amp_steps(build_nmt, [nmt_feed(s)
                                         for s in range(STEPS)]))


# =====================================================================
# serving: the Predictor on a JAX-saved is_test build
# =====================================================================

@pytest.fixture(scope="module")
def jax_saved(tmp_path_factory):
    """The is_test build from its JAX startup, saved for inference with
    the logits as its fetch; JAX's Predictor's logits, f32 and AMP."""
    main, startup, _, _, logits = build_nmt(pt, is_test=True)
    exe = pt.Executor(pt.CPUPlace(), scope=pt.Scope())
    exe.run(startup)
    d = str(tmp_path_factory.mktemp("nmt_infer"))
    pt.io.save_inference_model(d, SERVE_FEEDS, [logits], exe,
                               main_program=main)
    feed = {k: v for k, v in nmt_feed(9).items() if k in SERVE_FEEDS}
    p = jpred.create_predictor(jpred.AnalysisConfig(d, use_tpu=False))
    want = {}
    for amp in (False, True):
        pt.core.flags.set_flag("amp_bf16", amp)
        want[amp] = np.asarray(p.run(feed)[0], np.float32)
    pt.core.flags.set_flag("amp_bf16", False)
    return dict(dir=d, feed=feed, want=want)


@pytest.mark.parametrize("amp", [False, True])
def test_port_predictor_serves_the_jax_saved_nmt(jax_saved, amp):
    p = create_predictor(AnalysisConfig(jax_saved["dir"], use_gpu=False))
    ops = [op.type for op in p.program.global_block().ops]
    assert "adam" not in ops and "softmax_with_cross_entropy" not in ops
    assert sorted(p.get_input_names()) == sorted(SERVE_FEEDS)
    ptt.flags.set_flag("amp_bf16", amp)
    got, = p.run(jax_saved["feed"])
    raw, = p.run(jax_saved["feed"], return_numpy=False)
    ptt.flags.set_flag("amp_bf16", False)
    want = jax_saved["want"][amp]
    assert got.shape == want.shape == (BATCH, TGT_T, 80)
    assert raw.dtype == (torch.bfloat16 if amp else torch.float32)
    if amp:
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= AMP_PRED_RTOL, err
    else:
        np.testing.assert_allclose(got, want, **PRED_TOL)


# =====================================================================
# the lint CLI
# =====================================================================

def test_lint_counts_match_the_jax_cli():
    """The port's CLI builds the JAX CLI's `transformer` (the NMT build at
    dropout 0.1) with SGD(0.01) and finds the same (errors, warnings)."""
    mine = tlint.lint_model("transformer",
                            tlint.model_builders()["transformer"])
    theirs = jlint.lint_model("transformer",
                              jlint.model_builders()["transformer"])
    assert mine == theirs == (0, 0)
