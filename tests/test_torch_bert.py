"""BERT-base pretraining (models/bert.py ``build_pretrain_net``: the
masked-LM head over gathered positions and the next-sentence head)
through both packages.

A small BERT (V 100, hidden 32, 2 layers, 4 heads, intermediate 64,
max_position 32, T 16, batch 4, 5 predictions a sequence, dropout 0) is
built and initialised in paddle_tpu on the CPU and its whole state
carried into the port with ``io.params_from_numpy``; input_mask is
ragged (every other sequence right-padded) and the last two predictions
of every other sequence weigh 0.  The f32 trajectory of 3 Adam steps,
the AMP steps and the tolerances are ``tests/test_torch_nmt.py``'s (the
same helpers): loss rtol 1e-5, step-1 grads rtol 1e-4 atol 1e-6, the
state after 3 steps at ``tests/test_torch_train.py``'s tolerances with
its near-zero-gradient caveat; under AMP the port's gradient is held to
JAX's f32 one as JAX's AMP one is.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.analysis import lint as jlint
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.analysis import lint as tlint
from paddle_tpu_torch.models import bert as tbert
from test_torch_nmt import (STEPS, amp_steps, check_amp_rows, check_losses,
                            check_serializes_like_jax, check_state,
                            check_step1_grads, persistables, ragged,
                            three_steps)

T, BATCH, PREDS, LR = 16, 4, 5, 1e-3


def tiny_cfg(mod, dropout=0.0):
    return mod.BertConfig(vocab_size=100, hidden_size=32, num_layers=2,
                          num_heads=4, intermediate_size=64,
                          max_position=32, dropout=dropout)


@pytest.fixture(autouse=True)
def fresh_port_programs():
    ptt.reset_default_programs()
    yield
    ptt.reset_default_programs()
    pt.core.flags.set_flag("amp_bf16", False)
    ptt.flags.set_flag("amp_bf16", False)


def build_bert(pkg, is_test=False, dropout=0.0, opt=True):
    """(main, startup, total loss, grad names, (mlm loss, nsp loss)) of the
    small BERT in fresh programs of `pkg`; `opt` attaches Adam(LR)."""
    mod = jbert if pkg is pt else tbert
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 13
    with pkg.program_guard(main, startup):
        _, loss, heads = mod.build_pretrain_net(tiny_cfg(mod, dropout), T,
                                                is_test=is_test)
        grads = []
        if opt:
            _, pg = pkg.optimizer.Adam(learning_rate=LR).minimize(loss)
            grads = [g.name for _, g in pg]
    return main, startup, loss, grads, heads


def bert_feed(step, batch=BATCH):
    feed = tbert.make_fake_batch(tiny_cfg(tbert), batch, T, max_preds=PREDS,
                                 seed=400 + step)
    feed["mask_weight"].reshape(batch, PREDS)[::2, -2:] = 0
    return ragged(feed, ("input_mask",), 500 + step)


# =====================================================================
# the build
# =====================================================================

@pytest.mark.parametrize("variant", ["train", "is_test", "dropout"])
def test_build_serializes_like_jax(variant):
    """Op list, slots, attrs, var names and shapes, and the params, of the
    Adam pretraining program (at dropout 0 and 0.1, and is_test) and its
    startup program; the flattened masked-position feeds declare JAX's
    [-1] and [-1, 1], the 1e-6 constant is a 0-d assign_value."""
    kw = {"train": {}, "is_test": {"is_test": True},
          "dropout": {"dropout": 0.1}}[variant]
    theirs, mine = build_bert(pt, **kw), build_bert(ptt, **kw)
    check_serializes_like_jax(mine, theirs)
    block = mine[0].global_block()
    assert tuple(block.var("mask_pos").shape) == (-1,)
    assert tuple(block.var("mask_label").shape) == (-1, 1)
    assert tuple(block.var("nsp_label").shape) == (-1, 1)
    consts = [op for op in block.ops if op.type == "assign_value"]
    assert len(consts) == 1 and consts[0].attrs["shape"] == []
    types = [op.type for op in block.ops]
    assert {"gather", "slice", "gelu", "tanh", "reduce_sum"} <= set(types)
    assert types.count("layer_norm") == 1 + 2 * 2 + 1 + 1
    assert types.count("dropout") == (
        0 if variant != "dropout" else 1 + 2 * (1 + 1 + 2))
    assert all(tuple(v.shape) == () for v in [mine[2], *mine[4]])


def test_bert_base_builds_like_jax_at_full_width():
    """BertConfig() at its defaults (BERT-base) at seq 128: the same op
    list and parameter shapes in both packages."""
    views = []
    for pkg, mod in ((pt, jbert), (ptt, tbert)):
        pkg.reset_default_programs()
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            _, loss, _ = mod.build_pretrain_net(mod.BertConfig(), 128)
        views.append(([op.type for op in main.global_block().ops],
                      sorted((p.name, tuple(p.shape))
                             for p in main.all_parameters()),
                      tuple(loss.shape)))
    assert views[0] == views[1]
    assert views[1][0].count("layer_norm") == 1 + 2 * 12 + 1 + 1
    assert ("word_embedding", (30522, 768)) in views[1][1]
    assert views[1][2] == ()


# =====================================================================
# training: Adam, f32, from JAX's initial state
# =====================================================================

@pytest.fixture(scope="module")
def runs():
    return three_steps(build_bert, [bert_feed(s) for s in range(STEPS)])


def test_losses_match_step_for_step(runs):
    check_losses(runs)


def test_every_grad_matches_at_step_1(runs):
    # 3 embeddings and their layer norm; 10 a layer; the final layer
    # norm; the MLM head's fc, layer norm and fc; the NSP head's two fcs
    assert len(runs["grads"]) == 3 + 2 + 10 * 2 + 2 + 6 + 4
    check_step1_grads(runs)


@pytest.mark.parametrize("kind", ["param", "moment1", "moment2", "pow_lr"])
def test_state_after_three_steps_matches(runs, kind):
    check_state(runs, kind)


def test_unweighted_predictions_and_pads_change_nothing():
    """The label of a prediction weighted 0, and the token of a pad that
    no prediction picks, reach neither the loss nor any gradient; with
    every prediction weighted 0, the MLM loss is 0 and finite (the 1e-6
    in its denominator)."""
    main, startup, loss, grads, (mlm, nsp) = build_bert(ptt)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace(), scope=scope)
    exe.run(startup)
    state = {n: scope.find_var(n).numpy().copy()
             for n in persistables(main)}
    feed = bert_feed(0)
    other = {k: v.copy() for k, v in feed.items()}
    rng = np.random.RandomState(3)
    idle = feed["mask_weight"][:, 0] == 0
    other["mask_label"][idle, 0] = rng.randint(0, 100, int(idle.sum()))
    pad = feed["input_mask"] == 0
    pad.reshape(-1)[feed["mask_pos"]] = False
    other["input_ids"][pad] = rng.randint(0, 100, int(pad.sum()))
    assert idle.any() and pad.any()

    def run(f, fetch):
        ptt.io.params_from_numpy(scope, state, ptt.CPUPlace())
        return exe.run(main, feed=f, fetch_list=fetch)

    for name, a, b in zip(["loss"] + grads, run(feed, [loss] + grads),
                          run(other, [loss] + grads)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9,
                                   err_msg=name)
    none = dict(feed, mask_weight=np.zeros_like(feed["mask_weight"]))
    m, n, total = run(none, [mlm, nsp, loss])
    assert float(m) == 0.0 and np.isfinite(total)
    np.testing.assert_allclose(total, n, rtol=1e-6)


# =====================================================================
# AMP
# =====================================================================

def test_amp_step_is_as_close_to_f32_as_jax_amp():
    check_amp_rows(amp_steps(build_bert, [bert_feed(s)
                                          for s in range(STEPS)]))


# =====================================================================
# the lint CLI
# =====================================================================

def test_lint_counts_match_the_jax_cli():
    """The port's CLI builds the JAX CLI's `bert` (dropout 0.1) with
    SGD(0.01) and finds the same (errors, warnings)."""
    mine = tlint.lint_model("bert", tlint.model_builders()["bert"])
    theirs = jlint.lint_model("bert", jlint.model_builders()["bert"])
    assert mine == theirs == (0, 0)
