"""The GRU machine-translation model (models/machine_translation.py) and
its beam decode through both packages, and StaticRNN, the sub-block
plumbing under them.

At the lint CLI's sizes (V 50, source and target T 8, embedding and GRU
width 32, batch 4) the train program is built and initialised in
paddle_tpu on the CPU and its parameters and Adam state are carried into
the port with ``io.params_from_numpy``; three Adam steps on the copy task
(``make_copy_task_batch``) are held at ``tests/test_torch_nmt.py``'s
tolerances, in f32 and under FLAGS_amp_bf16 by its flag rule.  The decode
program built after those steps in each package's trained scope (beam 3,
max_len 6, batch 8) gives JAX's SentenceIds exactly and its
SentenceScores at rtol 1e-5; the same program saved by the port's
``io.save_inference_model`` and served by the port's Predictor equals
JAX's ``Executor.run`` of the unpruned program (the prune keeps what the
decoder step reads inside its sub-block: ROADMAP queue C).
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import layers as jlayers
from paddle_tpu.models import machine_translation as jmt
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
from paddle_tpu_torch.models import machine_translation as tmt
from test_torch_nmt import (STEPS, LR, amp_steps, check_amp_rows,
                            check_losses, check_state, check_step1_grads,
                            three_steps)

V, T, WIDTH, BATCH = 50, 8, 32, 4
BEAM, MAX_LEN, DEC_BATCH = 3, 6, 8
SCORE_RTOL = 1e-5


@pytest.fixture(autouse=True)
def fresh_programs():
    ptt.reset_default_programs()
    yield
    ptt.reset_default_programs()
    pt.core.flags.set_flag("amp_bf16", False)
    ptt.flags.set_flag("amp_bf16", False)


def blocks_view(prog):
    """Every block's parent, ops (type, slots, attrs) and vars (shape, a
    float's dtype or 'int', flags): JAX keeps int32 where the port
    computes int64 (ROADMAP, the x32 plane).  An unknown shape reads as
    (), as the JSON writes both."""
    def kind(dtype):
        return dtype if dtype.startswith(("float", "bfloat")) else "int"
    return [(b.idx, b.parent_idx,
             [(op.type, op.inputs, op.outputs,
               json.loads(json.dumps(op.to_dict()["attrs"])))
              for op in b.ops],
             {v.name: (tuple(v.shape or ()),
                       kind(v.dtype), v.persistable, v.stop_gradient,
                       type(v).__name__) for v in b.vars.values()})
            for b in prog.blocks]


def check_serializes_like_jax(mine, theirs):
    """test_torch_nmt's check over every block: the main and startup
    programs' blocks alike (blocks_view), and the params' names, shapes,
    dtypes and trainable flags."""
    for t, j in zip(mine[:2], theirs[:2]):
        assert blocks_view(t) == blocks_view(j)
    assert ({p.name: (tuple(p.shape), p.dtype, p.trainable)
             for p in mine[0].all_parameters()}
            == {p.name: (tuple(p.shape), p.dtype, p.trainable)
                for p in theirs[0].all_parameters()})


def build_mt(pkg, opt=True):
    """(main, startup, loss, grad names) of the small MT train program in
    fresh programs of `pkg`; `opt` attaches Adam(LR)."""
    mod = jmt if pkg is pt else tmt
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup):
        _, loss = mod.build_train_net(V, V, T, T, emb_dim=WIDTH,
                                      hidden_dim=WIDTH)
        grads = []
        if opt:
            _, pg = pkg.optimizer.Adam(learning_rate=LR).minimize(loss)
            grads = [g.name for _, g in pg]
    return main, startup, loss, grads


def build_decode(pkg):
    """(main, startup, sentence ids, scores) of the decode program, its
    names counted from 0 (its parameters are named: a scope trained by
    build_mt's program binds to it)."""
    mod = jmt if pkg is pt else tmt
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        _, sent, scores = mod.build_decode_net(
            V, V, T, beam_size=BEAM, max_len=MAX_LEN, emb_dim=WIDTH,
            hidden_dim=WIDTH)
    return main, startup, sent, scores


def mt_feed(step, batch=BATCH):
    return tmt.make_copy_task_batch(batch, T, V, seed=100 + step)


def dec_src():
    return tmt.make_copy_task_batch(DEC_BATCH, T, V, seed=77)["src"]


# =====================================================================
# the builds
# =====================================================================

@pytest.mark.parametrize("which", ["train", "decode"])
def test_build_serializes_like_jax_sub_block_included(which):
    """Both blocks of each program (ops, slots, attrs with sub_block and
    the carry lists, var names, shapes and dtypes), the params, and the
    startup programs; the train program with Adam."""
    if which == "train":
        theirs, mine = build_mt(pt), build_mt(ptt)
    else:
        theirs, mine = build_decode(pt), build_decode(ptt)
    check_serializes_like_jax(mine, theirs)
    main = mine[0]
    assert len(main.blocks) == 2 and main.blocks[1].parent_idx == 0
    scan, = [op for op in main.global_block().ops
             if op.type == "static_rnn_scan"]
    assert scan.attrs["sub_block"] == 1
    sub = [op.type for op in main.blocks[1].ops]
    n_mem = 1 if which == "train" else 3
    assert sub[-n_mem:] == ["assign"] * n_mem
    if which == "decode":
        assert "beam_search" in sub
        for v in (mine[2], main.global_block().var(
                scan.inputs["Init"][2])):
            assert v.dtype == "int32"


@pytest.mark.parametrize("which", ["train", "decode"])
def test_program_round_trips_through_json(which):
    """to_dict / from_dict keep the sub-block, its parent and the
    sub_block attr, and the result writes the same JSON again; the JAX
    package reads the port's JSON into the same blocks."""
    main = (build_mt(ptt) if which == "train" else build_decode(ptt))[0]
    d = main.to_dict()
    again = ptt.Program.from_dict(json.loads(json.dumps(d)))
    assert again.to_dict() == d
    assert blocks_view(again) == blocks_view(main)
    jprog = pt.Program.from_dict(json.loads(json.dumps(d)))
    assert blocks_view(jprog) == blocks_view(again)


def test_create_block_and_rollback():
    prog = ptt.Program()
    b1 = prog.create_block()
    assert prog.current_block() is b1 and b1.parent_idx == 0
    b2 = prog.create_block()
    assert b2.parent is b1
    prog.rollback()
    assert prog.current_block() is b1
    prog.rollback()
    assert prog.current_block() is prog.global_block()
    b3 = prog.create_block(parent_idx=0)
    assert (b3.idx, b3.parent_idx) == (3, 0)


# =====================================================================
# training: Adam, f32 and AMP, from JAX's initial state
# =====================================================================

@pytest.fixture(scope="module")
def runs():
    return three_steps(build_mt, [mt_feed(s) for s in range(STEPS)])


def test_losses_match_step_for_step(runs):
    check_losses(runs)


def test_every_grad_matches_at_step_1(runs):
    # the two embeddings, the encoder's fc and GRU (w, b), the decoder's
    # fc and GRU cell (w, b) inside the sub-block, the output fc (w, b)
    assert len(runs["grads"]) == 2 + 3 + 3 + 2
    check_step1_grads(runs)


@pytest.mark.parametrize("kind", ["param", "moment1", "moment2", "pow_lr"])
def test_state_after_three_steps_matches(runs, kind):
    """check_state, with every param entry held at atol 2e-6: none needs
    the near-zero-grad allowance here (a fifth of dec_fc.w's step-1
    grads lie under 1e-5, more than that allowance admits, and its
    entries agree to 4e-8 all the same)."""
    check_state(dict(runs, near_zero={}), kind)


def test_amp_step_is_as_close_to_f32_as_jax_amp():
    check_amp_rows(amp_steps(build_mt, [mt_feed(s) for s in range(STEPS)]))


# =====================================================================
# the beam decode after training, and its Predictor
# =====================================================================

@pytest.fixture(scope="module")
def trained():
    """Each package's scope after three Adam steps from JAX's
    initialisation, the decode programs built after them, and JAX's
    Executor.run of its (unpruned) decode program."""
    main, startup, loss, _ = build_mt(pt)
    jscope = pt.Scope()
    jexe = pt.Executor(pt.CPUPlace(), scope=jscope)
    jexe.run(startup)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    init = {n: np.asarray(jscope.find_var(n)) for n in names}
    tmain, _, tloss, _ = build_mt(ptt)
    tscope = ptt.Scope()
    texe = ptt.Executor(ptt.CPUPlace(), scope=tscope)
    ptt.io.params_from_numpy(tscope, init, ptt.CPUPlace())
    for s in range(STEPS):
        jexe.run(main, feed=mt_feed(s), fetch_list=[loss])
        texe.run(tmain, feed=mt_feed(s), fetch_list=[tloss])
    jdec = build_decode(pt)
    want = jexe.run(jdec[0], feed={"src": dec_src()},
                    fetch_list=[jdec[2], jdec[3]])
    return dict(jexe=jexe, texe=texe, jdec=jdec, tdec=build_decode(ptt),
                want=[np.asarray(w) for w in want])


def test_decode_gives_jax_ids_and_scores(trained):
    main, _, sent, scores = trained["tdec"]
    ids, sc = trained["texe"].run(main, feed={"src": dec_src()},
                                  fetch_list=[sent, scores])
    want_ids, want_sc = trained["want"]
    assert ids.shape == want_ids.shape == (DEC_BATCH, BEAM, MAX_LEN)
    assert ids.dtype == np.int32
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(sc, want_sc, rtol=SCORE_RTOL)
    # the beams of a row are distinct hypotheses, best first
    assert np.all(np.diff(sc, axis=1) <= 0)
    assert len({tuple(h) for h in ids.reshape(-1, MAX_LEN)}) > DEC_BATCH


def test_saved_decode_served_by_the_predictor_equals_jax(trained, tmp_path):
    """save_inference_model's prune keeps the producers of what the
    decoder step reads inside its sub-block (the beam-tiled encoder
    states), so the port's Predictor serves the saved program; its
    outputs equal JAX's Executor.run of the unpruned program."""
    main, _, sent, scores = trained["tdec"]
    ptt.io.save_inference_model(str(tmp_path), ["src"], [sent, scores],
                                trained["texe"], main_program=main)
    p = create_predictor(AnalysisConfig(str(tmp_path), use_gpu=False))
    ops = [op.type for op in p.program.global_block().ops]
    assert ops.count("static_rnn_scan") == 1 and "expand" in ops
    ids, sc = p.run({"src": dec_src()})
    want_ids, want_sc = trained["want"]
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(sc, want_sc, rtol=SCORE_RTOL)


def test_prune_keeps_the_producers_a_sub_block_reads():
    """The decode program pruned to its outputs keeps every op that
    makes a var its sub-block reads: the encoder, the tiling of its
    states (never read by a global op), and the parameters."""
    main, _, sent, scores = build_decode(ptt)
    pruned = main.prune(["src"], [sent.name, scores.name])
    sub_reads = main._sub_block_reads(
        [op for op in main.global_block().ops
         if op.type == "static_rnn_scan"][0])
    made = {n for op in pruned.global_block().ops
            for n in op.output_names()}
    outer = {n for n in sub_reads if not main.global_block().var(n)
             .persistable}
    assert outer and outer <= made
    assert [op.type for op in pruned.global_block().ops] == [
        op.type for op in main.global_block().ops]


# =====================================================================
# StaticRNN against numpy and JAX
# =====================================================================

def _tanh_rnn(layers, B, T, D, H):
    x = layers.data("x", [T, D], dtype="float32")
    h0 = layers.data("h0", [H], dtype="float32")
    rnn = layers.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        h_prev = rnn.memory(init=h0)
        cat = layers.concat([x_t, h_prev], axis=1)
        h = layers.fc(cat, size=H, act="tanh", bias_attr=False)
        rnn.update_memory(h_prev, h)
        rnn.step_output(h)
    return rnn(), rnn.outputs()[0]


def test_static_rnn_matches_numpy_and_jax():
    """h_t = tanh([x_t, h_{t-1}] W) through the port's StaticRNN against
    numpy in f64 and JAX's StaticRNN on the same weights: the stacked
    [B, T, H] output, the [T, B, H] Ys and the last carry."""
    B, T_, D, H = 2, 5, 3, 4
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(B, T_, D).astype("float32") * 0.5,
            "h0": rng.randn(B, H).astype("float32") * 0.5}
    got = {}
    for pkg, layers in ((pt, jlayers), (ptt, tlayers)):
        pkg.reset_default_programs()
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            out, ys = _tanh_rnn(layers, B, T_, D, H)
        carry = [op for op in main.global_block().ops
                 if op.type == "static_rnn_scan"][0].outputs["CarryOut"][0]
        scope = pkg.Scope()
        exe = pkg.Executor(pkg.CPUPlace(), scope=scope)
        exe.run(startup)
        w_name, = [p.name for p in main.all_parameters()]
        if pkg is pt:
            w = np.asarray(scope.find_var(w_name))
        else:
            ptt.io.params_from_numpy(scope, {w_name: w}, ptt.CPUPlace())
        got[pkg.__name__] = [np.asarray(a) for a in exe.run(
            main, feed=feed, fetch_list=[out, ys, carry])]
    h = feed["h0"].astype("float64")
    expect = np.zeros((B, T_, H))
    for t in range(T_):
        h = np.tanh(np.concatenate([feed["x"][:, t], h], -1) @ w)
        expect[:, t] = h
    mine, theirs = got["paddle_tpu_torch"], got["paddle_tpu"]
    assert mine[0].shape == (B, T_, H) and mine[1].shape == (T_, B, H)
    np.testing.assert_allclose(mine[0], expect, atol=1e-5)
    np.testing.assert_allclose(mine[1], expect.transpose(1, 0, 2),
                               atol=1e-5)
    np.testing.assert_allclose(mine[2], expect[:, -1], atol=1e-5)
    for a, b in zip(mine, theirs):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_static_rnn_gradient_matches_jax():
    """The loss mean(rnn()) and its gradient w.r.t. W, h0 and x through
    autograd over the port's loop against jax.vjp of JAX's scan."""
    B, T_, D, H = 3, 4, 2, 3
    rng = np.random.RandomState(1)
    feed = {"x": rng.randn(B, T_, D).astype("float32"),
            "h0": rng.randn(B, H).astype("float32")}
    got = {}
    for pkg, layers in ((pt, jlayers), (ptt, tlayers)):
        pkg.reset_default_programs()
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            out, _ = _tanh_rnn(layers, B, T_, D, H)
            loss = layers.mean(layers.square(out))
            _, pg = pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        scope = pkg.Scope()
        exe = pkg.Executor(pkg.CPUPlace(), scope=scope)
        exe.run(startup)
        w_name, = [p.name for p in main.all_parameters()]
        if pkg is pt:
            w = np.asarray(scope.find_var(w_name))
        else:
            ptt.io.params_from_numpy(scope, {w_name: w}, ptt.CPUPlace())
        got[pkg.__name__] = [np.asarray(a) for a in exe.run(
            main, feed=feed, fetch_list=[loss] + [g for _, g in pg])]
    for a, b in zip(got["paddle_tpu_torch"], got["paddle_tpu"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    assert np.abs(got["paddle_tpu_torch"][1]).max() > 0


def test_a_carry_that_changes_dtype_raises():
    """A memory starting f32 and updated with a bf16 value (an AMP fc
    output fed back into an f32 init): lax.scan refuses the carry in
    JAX, and the port raises EnforceNotMet naming the memory, with no
    quiet cast."""
    B, T_, D, H = 2, 3, 3, 3
    feed = {"x": np.ones((B, T_, D), "float32"),
            "h0": np.zeros((B, H), "float32")}
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = tlayers.data("x", [T_, D], dtype="float32")
        h0 = tlayers.data("h0", [H], dtype="float32")
        rnn = tlayers.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            h_prev = rnn.memory(init=h0)
            h = tlayers.fc(tlayers.concat([x_t, h_prev], axis=1), size=H,
                           bias_attr=False)
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        out = rnn()
    exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    exe.run(startup)
    got, = exe.run(main, feed=feed, fetch_list=[out])      # f32: fine
    assert got.shape == (B, T_, H)
    ptt.flags.set_flag("amp_bf16", True)
    with pytest.raises(EnforceNotMet, match=h_prev.name):
        exe.run(main, feed=feed, fetch_list=[out])
    ptt.flags.set_flag("amp_bf16", False)

    pt.reset_default_programs()
    jmain, jstart = pt.Program(), pt.Program()
    with pt.program_guard(jmain, jstart):
        jout, _ = _tanh_rnn(jlayers, B, T_, D, H)
    jexe = pt.Executor(pt.CPUPlace(), scope=pt.Scope())
    jexe.run(jstart)
    pt.core.flags.set_flag("amp_bf16", True)
    try:
        with pytest.raises(Exception, match="carry"):
            jexe.run(jmain, feed=feed, fetch_list=[jout])
    finally:
        pt.core.flags.set_flag("amp_bf16", False)


def test_static_rnn_scan_needs_a_run_context():
    """Outside an Executor or Predictor run (a meta evaluation) the op
    has no program and no env: it raises, and the verifier reports its
    shape unknown."""
    from paddle_tpu_torch.framework.registry import LowerContext, get_op_def
    ctx = LowerContext(0, torch.device("cpu"))
    with pytest.raises(EnforceNotMet, match="Executor"):
        get_op_def("static_rnn_scan").lower(
            ctx, {"Init": [torch.zeros(2, 3)], "X": [torch.zeros(4, 2, 3)]},
            {"sub_block": 1, "carry_vars": ["m"], "x_inner_vars": ["x"],
             "y_vars": ["m"]})
