"""The five book models (models/book.py: fit_a_line, word2vec,
recommender_system, rnn_encoder_decoder, db_lstm) through both packages.

Each is built at the JAX builder's default sizes (word2vec at dict_size
50, the lint CLI's) with Adam(1e-3) and initialised in paddle_tpu on the
CPU; its parameters and Adam state are carried into the port with
``io.params_from_numpy``, and three steps on seeded batches of 4 are held
at ``tests/test_torch_nmt.py``'s tolerances (loss rtol 1e-5, step-1
@GRADs rtol 1e-4 atol 1e-6, the state after step 3).  db_lstm's
Viterbi path (``crf_decoding`` on the trained transitions) equals JAX's;
fit_a_line's inference program is saved and reloaded, by each package
from each package's directory, with the same predictions.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.inference import predictor as jpredictor
from paddle_tpu.models import book as jbook
from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
from paddle_tpu_torch.models import book as tbook
from test_torch_nmt import (STEPS, LR, check_losses, check_state,
                            check_step1_grads, three_steps)
from test_torch_seq2seq import check_serializes_like_jax

BATCH = 4
PRED_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_ATOL = 2e-6           # test_torch_nmt's param tolerance
NEAR_SHARE = 1e-3           # of a param's entries, beyond PARAM_ATOL


@pytest.fixture(autouse=True)
def fresh_programs():
    ptt.reset_default_programs()
    yield
    ptt.reset_default_programs()


def _ints(rng, hi, *shape):
    return rng.randint(0, hi, shape).astype("int64")


def _feed(model, step):
    """A seeded batch of `model`'s feeds at the builder's default sizes."""
    rng = np.random.RandomState(1000 * len(model) + step)
    B = BATCH
    if model == "fit_a_line":
        x = rng.randn(B, 13).astype("float32")
        return {"x": x, "y": (x[:, :1] * 2 + 1).astype("float32")}
    if model == "word2vec":
        return {f"word_{i}" if i < 4 else "next_word": _ints(rng, 50, B, 1)
                for i in range(5)}
    if model == "recommender_system":
        f = {k: _ints(rng, n, B, 1) for k, n in (
            ("user_id", 100), ("gender_id", 2), ("age_id", 7),
            ("job_id", 21), ("movie_id", 200))}
        f.update(category_id=_ints(rng, 10, B, 3),
                 movie_title=_ints(rng, 500, B, 8),
                 score=rng.uniform(1, 5, (B, 1)).astype("float32"))
        return f
    if model == "rnn_encoder_decoder":
        return {k: _ints(rng, 100, B, 8)
                for k in ("src_word", "tgt_word", "label")}
    f = {f"{s}_data": _ints(rng, 100, B, 8) for s in (
        "word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2")}
    f.update(verb_data=_ints(rng, 50, B, 8), mark_data=_ints(rng, 2, B, 8),
             target=_ints(rng, 10, B, 8))
    return f


MODELS = {"fit_a_line": {}, "word2vec": {"dict_size": 50},
          "recommender_system": {}, "rnn_encoder_decoder": {},
          "db_lstm": {}}


def builder(model):
    def build(pkg):
        """(main, startup, loss, grad names, prediction) of `model`."""
        mod = jbook if pkg is pt else tbook
        pkg.reset_default_programs()
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 5
        with pkg.program_guard(main, startup):
            _, loss, pred = getattr(mod, model)(**MODELS[model])
            _, pg = pkg.optimizer.Adam(learning_rate=LR).minimize(loss)
        return main, startup, loss, [g.name for _, g in pg], pred
    return build


@pytest.mark.parametrize("model", sorted(MODELS))
def test_build_serializes_like_jax(model):
    theirs, mine = builder(model)(pt), builder(model)(ptt)
    check_serializes_like_jax(mine, theirs)
    types = [op.type for op in mine[0].global_block().ops]
    assert types.count("adam") == len(mine[3])
    want = {"fit_a_line": "square_error_cost", "word2vec": "cross_entropy",
            "recommender_system": "cos_sim",
            "rnn_encoder_decoder": "expand",
            "db_lstm": "linear_chain_crf"}[model]
    assert want in types


_RUNS = {}


def runs(model):
    if model not in _RUNS:
        _RUNS[model] = three_steps(builder(model),
                                   [_feed(model, s) for s in range(STEPS)])
    return _RUNS[model]


@pytest.mark.parametrize("model", sorted(MODELS))
def test_losses_match_step_for_step(model):
    check_losses(runs(model))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_every_grad_matches_at_step_1(model):
    check_step1_grads(runs(model))


@pytest.mark.parametrize("kind", ["param", "moment1", "moment2", "pow_lr"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_state_after_three_steps_matches(model, kind):
    """check_state for the Adam moments, pows and lr.  The params: an
    entry whose grad came within 1e-5 of zero (not 0) on some step is
    held to lr, as check_state holds it, and every other at PARAM_ATOL;
    where check_state bounds the share of such entries (5 %), this bounds
    the share of entries beyond PARAM_ATOL at NEAR_SHARE.  The deep
    LSTMs' recurrent weights have 4-84 % of their grads near zero (db_lstm
    at most 1 entry in 4096 beyond PARAM_ATOL, every other entry within
    1.2e-7)."""
    r = runs(model)
    if kind != "param":
        check_state(r, kind)
        return
    j, t = r["jax"]["state"], r["port"]["state"]
    params = [p.name for p in r["main"].all_parameters()]
    for n in params:
        assert t[n].shape == j[n].shape, n
        err = np.abs(t[n].astype(np.float64) - j[n])
        near = r["near_zero"].get(n, np.zeros(err.shape, bool))
        assert err[~near].max(initial=0) <= PARAM_ATOL, n
        assert err[near].max(initial=0) <= LR, n
        assert (err > PARAM_ATOL).mean() < NEAR_SHARE, n
    moved = sorted(n for n in params
                   if not np.array_equal(t[n], r["init"][n]))
    assert moved == sorted(params)


def _trained(model):
    """Both packages' executors and programs after three steps from
    JAX's initialisation."""
    build = builder(model)
    main, startup, loss, _, pred = build(pt)
    jexe = pt.Executor(pt.CPUPlace(), scope=pt.Scope())
    jexe.run(startup)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    init = {n: np.asarray(jexe.scope.find_var(n)) for n in names}
    tmain, _, tloss, _, tpred = build(ptt)
    texe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    ptt.io.params_from_numpy(texe.scope, init, ptt.CPUPlace())
    for s in range(STEPS):
        jexe.run(main, feed=_feed(model, s), fetch_list=[loss])
        texe.run(tmain, feed=_feed(model, s), fetch_list=[tloss])
    return (jexe, main, pred), (texe, tmain, tpred)


def test_db_lstm_viterbi_path_equals_jax():
    """crf_decoding on the trained transitions ("crfw", shared by name
    with linear_chain_crf): the port's [B, T] int32 path is JAX's."""
    (jexe, jmain, jpred), (texe, tmain, tpred) = _trained("db_lstm")
    feed = _feed("db_lstm", 9)
    want, = jexe.run(jmain, feed=feed, fetch_list=[jpred])
    got, = texe.run(tmain, feed=feed, fetch_list=[tpred])
    assert got.shape == (BATCH, 8) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
    assert 0 <= got.min() and got.max() < 10


def test_fit_a_line_saved_and_reloaded(tmp_path):
    """After three steps each package saves the inference program (feed
    x, fetch the prediction); the port's Predictor serves its own
    directory and JAX's, and the port's load_inference_model reloads its
    own, each giving JAX's Predictor's predictions on its directory."""
    (jexe, jmain, jpred), (texe, tmain, tpred) = _trained("fit_a_line")
    x = _feed("fit_a_line", 9)["x"]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    pt.io.save_inference_model(jdir, ["x"], [jpred], jexe,
                               main_program=jmain)
    ptt.io.save_inference_model(tdir, ["x"], [tpred], texe,
                                main_program=tmain)
    want, = jpredictor.create_predictor(
        jpredictor.AnalysisConfig(jdir, use_tpu=False)).run({"x": x})
    for d in (jdir, tdir):
        p = create_predictor(AnalysisConfig(d, use_gpu=False))
        ops = [op.type for op in p.program.global_block().ops]
        assert "adam" not in ops and "square_error_cost" not in ops
        got, = p.run({"x": x})
        np.testing.assert_allclose(got, np.asarray(want), **PRED_TOL)
    exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    prog, feeds, fetches = ptt.io.load_inference_model(tdir, exe)
    assert feeds == ["x"]
    got, = exe.run(prog, feed={"x": x}, fetch_list=fetches)
    assert got.shape == (BATCH, 1)
    np.testing.assert_allclose(got, np.asarray(want), **PRED_TOL)
