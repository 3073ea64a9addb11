"""DeepFM CTR (models/deepfm.py, BASELINE config 4, bench.py's
``bench_deepfm`` row) through both packages, with the sparse plane's
host modules and the host metrics.

A small DeepFM (F 6, V 200, K 4, towers (8, 8), batch 8) is built and
initialised in paddle_tpu on the CPU, in its dense build
(``lookup_table``) and its hash-bucketed sparse build
(``sparse_embedding_lookup``); its parameters and Adagrad moments are
carried into the port with ``io.params_from_numpy``, and both take 3
Adagrad(0.05) steps on the same feeds.  The sparse build's raw ids are
drawn over [-2^40, 2^40), so they lie above 2^31, above 2^32 and below 0.
Tolerances are ``tests/test_torch_train.py``'s, each the same f32 math
summed in another order:

- loss per step: rtol 1e-5; prob per step: atol 1e-6;
- every ``@GRAD`` at step 1: rtol 1e-4, atol 1e-6;
- after step 3: params atol 2e-6, moments rtol 1e-4 atol 1e-7 (sums of
  squared grads), the lr exact; a param entry whose grad came within 1e-5
  of zero (not 0) on some step is held to lr instead (Adagrad's first
  step moves it by lr * g / (|g| + 1e-6), a steep function of a grad the
  summation order moves);
- every table row no id named in the 3 steps: bit-equal to its start
  value in both packages (its gradient is exactly 0, so Adagrad moves it
  by lr * 0 / (sqrt(m) + eps)).

Under FLAGS_amp_bf16 (both programs built with the flag off: the JAX
build would declare bf16 params, ROADMAP queue C) the forward's dtypes
(the bf16 towers, the f32 FM terms, the logit, loss and prob) equal
JAX's, and one step from the same state puts the port's AMP gradient as
near JAX's f32 gradient as JAX's AMP gradient is (AMP_GRAD_SLACK).  The
JAX-saved dense build serves ``prob`` through the port's Predictor at
rtol 1e-5, and ``metrics.Auc`` of it equals the JAX package's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import metrics as jmetrics
from paddle_tpu.analysis import lint as jlint
from paddle_tpu.inference import predictor as jpred
from paddle_tpu.models import deepfm as jdfm
from paddle_tpu.sparse import selected_rows as jsr
from paddle_tpu.sparse import table as jtable
from paddle_tpu_torch import metrics as tmetrics
from paddle_tpu_torch.analysis import lint as tlint
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
from paddle_tpu_torch.models import deepfm as tdfm
from paddle_tpu_torch.sparse import selected_rows as tsr
from paddle_tpu_torch.sparse import table as ttable
from test_torch_nmt import check_serializes_like_jax, persistables, scalar

F, V, K, FC, BATCH, STEPS, LR = 6, 200, 4, (8, 8), 8, 3, 0.05
LOSS_RTOL = 1e-5
PROB_ATOL = 1e-6
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_ATOL = 2e-6
MOMENT_TOL = dict(rtol=1e-4, atol=1e-7)
NEAR_ZERO = 1e-5
AMP_GRAD_SLACK = (1.5, 0.01)
PRED_TOL = dict(rtol=1e-5, atol=1e-7)
TABLES = ("fm_w1", "fm_emb")


def tiny_cfg(mod):
    return mod.DeepFMConfig(num_field=F, vocab_size=V, embed_dim=K,
                            fc_sizes=FC)


@pytest.fixture(autouse=True)
def fresh_port_programs():
    ptt.reset_default_programs()
    yield
    ptt.reset_default_programs()
    pt.core.flags.set_flag("amp_bf16", False)
    ptt.flags.set_flag("amp_bf16", False)


def build_deepfm(pkg, sparse=False, opt=True):
    """(main, startup, loss, grad names, prob) of the small DeepFM in
    fresh programs of `pkg` (the sparse build with `sparse`); `opt`
    attaches Adagrad(LR)."""
    mod = jdfm if pkg is pt else tdfm
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 13
    with pkg.program_guard(main, startup):
        f = mod.build_sparse_train_net if sparse else mod.build_train_net
        _, loss, prob = f(tiny_cfg(mod))
        grads = []
        if opt:
            _, pg = pkg.optimizer.Adagrad(learning_rate=LR).minimize(loss)
            grads = [g.name for _, g in pg]
    return main, startup, loss, grads, prob


def ctr_feed(step, sparse=False, batch=BATCH):
    feed = tdfm.make_fake_batch(tiny_cfg(tdfm), batch, seed=400 + step)
    if sparse:    # raw CTR ids: above 2^31, above 2^32 and below 0
        rng = np.random.RandomState(500 + step)
        feed["feat_ids"] = rng.randint(-2**40, 2**40, (batch, F),
                                       dtype=np.int64)
    return feed


def buckets(ids):
    """The table row each raw id takes in the sparse build."""
    return ttable.hash_bucket(np.asarray(ids, np.int64), V)


def three_steps(sparse):
    """Both packages' Adagrad trajectories over 3 feeds from the JAX
    initialisation: losses, probs, step-1 grads, the final states, where
    a grad came near zero, and the table rows some id named."""
    main, startup, loss, grads, prob = build_deepfm(pt, sparse)
    jscope = pt.Scope()
    jexe = pt.Executor(pt.CPUPlace(), scope=jscope)
    jexe.run(startup)
    names = persistables(main)
    init = {n: np.asarray(jscope.find_var(n)) for n in names}
    tmain, _, tloss, tgrads, tprob = build_deepfm(ptt, sparse)
    assert persistables(tmain) == names and tgrads == grads
    tscope = ptt.Scope()
    texe = ptt.Executor(ptt.CPUPlace(), scope=tscope)
    ptt.io.params_from_numpy(tscope, init, ptt.CPUPlace())
    out = {side: {"loss": [], "prob": [], "grads": []}
           for side in ("jax", "port")}
    touched = set()
    for step in range(STEPS):
        feed = ctr_feed(step, sparse)
        ids = feed["feat_ids"]
        touched |= set((buckets(ids) if sparse else ids).ravel().tolist())
        for side, exe, prog, fetch in (
                ("jax", jexe, main, [loss, prob] + grads),
                ("port", texe, tmain, [tloss, tprob] + tgrads)):
            res = exe.run(prog, feed=feed, fetch_list=fetch)
            out[side]["loss"].append(np.asarray(res[0]))
            out[side]["prob"].append(np.asarray(res[1]))
            out[side]["grads"].append(dict(zip(grads,
                                               map(np.asarray, res[2:]))))
    out["jax"]["state"] = {n: np.asarray(jscope.find_var(n)) for n in names}
    out["port"]["state"] = {n: tscope.find_var(n).numpy() for n in names}
    params = [p.name for p in main.all_parameters()]
    out["near_zero"] = {
        n: np.any([(g[n + "@GRAD"] != 0) & (abs(g[n + "@GRAD"]) < NEAR_ZERO)
                   for g in out["jax"]["grads"] + out["port"]["grads"]], 0)
        for n in params}
    out.update(main=main, init=init, grads=grads, touched=sorted(touched),
               params=params)
    return out


@pytest.fixture(scope="module", params=["dense", "sparse"])
def runs(request):
    return three_steps(request.param == "sparse")


# =====================================================================
# the builds
# =====================================================================

@pytest.mark.parametrize("build", ["dense", "sparse", "dense_is_infer"])
def test_build_serializes_like_jax(build):
    """Op list, slots, attrs, var names and shapes, and the params, of
    the Adagrad training program (dense or hash-bucketed tables) and of
    the build without an optimizer, with their startup programs."""
    sparse, opt = build == "sparse", build != "dense_is_infer"
    theirs = build_deepfm(pt, sparse, opt)
    mine = build_deepfm(ptt, sparse, opt)
    check_serializes_like_jax(mine, theirs)
    types = [op.type for op in mine[0].global_block().ops]
    lookup = "sparse_embedding_lookup" if sparse else "lookup_table"
    assert types.count(lookup) == 2
    assert types.count("adagrad") == (len(mine[3]) if opt else 0) == (
        2 + 2 * (len(FC) + 1) if opt else 0)
    assert [p.name for p in mine[0].all_parameters()][:2] == list(TABLES)
    assert tuple(mine[4].shape) == (-1, 1)


def test_bench_deepfm_builds_like_jax_at_full_width():
    """bench_deepfm's configuration (DeepFMConfig(): F 39, V 1,000,001,
    K 10, towers 400-400-400) with Adagrad(0.01): the same op list,
    parameter shapes and Adagrad moments in both packages (built only)."""
    views = []
    for pkg, mod in ((pt, jdfm), (ptt, tdfm)):
        pkg.reset_default_programs()
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            _, loss, prob = mod.build_train_net(mod.DeepFMConfig())
            pkg.optimizer.Adagrad(learning_rate=0.01).minimize(loss)
        views.append(([op.type for op in main.global_block().ops],
                      sorted((v.name, tuple(v.shape)) for v in
                             main.list_vars() if v.persistable),
                      tuple(prob.shape)))
    assert views[0] == views[1]
    shapes = dict(views[1][1])
    assert shapes["fm_w1"] == (1000001, 1) and shapes["fm_emb"] == (
        1000001, 10)
    assert shapes["Adagrad_0.fm_emb.moment"] == (1000001, 10)


def test_sharded_tables_are_refused():
    """A sharded parameter needs the parallel planes (ROADMAP A.7):
    ParamAttr(sharding=...) and DeepFMConfig(sparse_shard_axis=...)
    raise EnforceNotMet naming the queue."""
    with pytest.raises(EnforceNotMet, match="A.7"):
        ptt.ParamAttr(name="t", sharding=("model", None))
    main = ptt.Program()
    with ptt.program_guard(main, ptt.Program()):
        cfg = tdfm.DeepFMConfig(num_field=F, vocab_size=V, embed_dim=K,
                                fc_sizes=FC, sparse_shard_axis="model")
        with pytest.raises(EnforceNotMet, match="A.7"):
            tdfm.build_train_net(cfg)
    assert ptt.ParamAttr(name="t").sharding is None


# =====================================================================
# training: Adagrad, f32, from JAX's initial state
# =====================================================================

def test_losses_and_probs_match_step_for_step(runs):
    for side in ("jax", "port"):
        assert len(runs[side]["loss"]) == STEPS
    for t, j in zip(runs["port"]["loss"], runs["jax"]["loss"]):
        assert t.shape == j.shape == ()
        np.testing.assert_allclose(t, j, rtol=LOSS_RTOL)
    for t, j in zip(runs["port"]["prob"], runs["jax"]["prob"]):
        assert t.shape == j.shape == (BATCH, 1)
        np.testing.assert_allclose(t, j, rtol=0, atol=PROB_ATOL)


def test_every_grad_matches_at_step_1(runs):
    j, t = runs["jax"]["grads"][0], runs["port"]["grads"][0]
    assert sorted(j) == sorted(t) == sorted(runs["grads"])
    assert len(j) == 2 + 2 * (len(FC) + 1)
    for name in j:
        assert t[name].shape == j[name].shape, name
        np.testing.assert_allclose(t[name], j[name], err_msg=name,
                                   **GRAD_TOL)
        assert np.abs(t[name]).max() > 0, name


@pytest.mark.parametrize("kind", ["param", "moment", "lr"])
def test_state_after_three_steps_matches(runs, kind):
    j, t = runs["jax"]["state"], runs["port"]["state"]
    if kind == "param":
        names, tol = runs["params"], dict(rtol=0, atol=PARAM_ATOL)
    elif kind == "moment":
        names, tol = [n for n in j if n.endswith(".moment")], MOMENT_TOL
    else:
        names, tol = [n for n in j if n.endswith(".lr")], dict(rtol=0,
                                                                atol=0)
    assert names
    for n in names:
        got, want = t[n], j[n]
        assert got.shape == want.shape, n
        if kind == "param":
            near = runs["near_zero"][n]
            assert near.mean() < 0.05, n
            np.testing.assert_allclose(got[near], want[near], rtol=0,
                                       atol=LR, err_msg=n)
            got, want = np.where(near, 0, got), np.where(near, 0, want)
        np.testing.assert_allclose(got, want, err_msg=n, **tol)


def test_untouched_table_rows_stay_bit_equal(runs):
    """The rows some id named moved; every other row of both tables and
    of their moments is bit-equal to its start value in both packages."""
    rows = np.array(runs["touched"])
    other = np.setdiff1d(np.arange(V), rows)
    assert 0 < len(rows) < V and len(other) > V // 2
    for n in TABLES + tuple(f"Adagrad_0.{t}.moment" for t in TABLES):
        start = runs["init"][n]
        for side in ("jax", "port"):
            end = runs[side]["state"][n]
            np.testing.assert_array_equal(end[other], start[other],
                                          err_msg=f"{side} {n}")
            assert not np.array_equal(end[rows], start[rows]), (side, n)


def test_sparse_build_hashes_ids_as_jax_and_the_host_plane():
    """The sparse build reads the table row hash_bucket gives each raw id
    (above 2^31, above 2^32, below 0), in both packages: a table holding
    its row index as its value returns the buckets."""
    feed = ctr_feed(0, sparse=True)
    ids = feed["feat_ids"]
    assert (ids > 2**32).any() and (ids < 0).any()
    got = {}
    for pkg in (pt, ptt):
        main, startup, _, _, _ = build_deepfm(pkg, sparse=True, opt=False)
        lookup = [op for op in main.global_block().ops
                  if op.type == "sparse_embedding_lookup"][0]
        out = lookup.outputs["Out"][0]
        exe = pkg.Executor(pkg.CPUPlace(), scope=pkg.Scope())
        exe.run(startup)
        table = np.arange(V, dtype="float32").reshape(V, 1)
        if pkg is pt:
            exe.scope.set_var("fm_w1", table)
        else:
            ptt.io.params_from_numpy(exe.scope, {"fm_w1": table},
                                     ptt.CPUPlace())
        res, = exe.run(main, feed=feed, fetch_list=[out])
        got[pkg.__name__] = np.asarray(res).reshape(ids.shape)
    want = buckets(ids)
    np.testing.assert_array_equal(jtable.hash_bucket(ids, V), want)
    for name, rows in got.items():
        np.testing.assert_array_equal(rows.astype(np.int64), want,
                                      err_msg=name)


def test_run_steps_matches_as_many_runs():
    """run_steps over per-step slabs of the three feeds: the losses and
    the state bit-equal to three runs."""
    main, startup, loss, _, _ = build_deepfm(ptt, sparse=True)
    feeds = [ctr_feed(s, sparse=True) for s in range(STEPS)]
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
    np.testing.assert_array_equal(out[1][0], out[0][0])
    for n in out[0][1]:
        np.testing.assert_array_equal(out[1][1][n], out[0][1][n], n)


# =====================================================================
# AMP
# =====================================================================

def _amp_vars(main):
    """The vars whose dtype AMP decides: every tower's product and
    activation, the FM terms, the logit, the loss and prob."""
    return [n for op in main.global_block().ops
            if op.type in ("mul", "relu", "elementwise_add", "reduce_sum",
                           "scale", "sigmoid",
                           "sigmoid_cross_entropy_with_logits", "mean")
            for n in op.outputs["Out"]]


@pytest.mark.parametrize("build", ["dense", "sparse"])
def test_amp_dtypes_and_grads_match_jax(build):
    """One step from JAX's initial state under FLAGS_amp_bf16 in both
    packages and in f32 in JAX: every AMP-decided var's dtype equals
    JAX's (bf16 towers, f32 FM terms, a bf16 logit, an f32 loss), and
    ||port AMP grads - JAX f32 grads|| / ||JAX f32 grads|| is within
    AMP_GRAD_SLACK of JAX's own AMP distance."""
    sparse = build == "sparse"
    main, startup, loss, grads, prob = build_deepfm(pt, sparse)
    jscope = pt.Scope()
    jexe = pt.Executor(pt.CPUPlace(), scope=jscope)
    jexe.run(startup)
    names = persistables(main)
    state = {n: np.asarray(jscope.find_var(n)) for n in names}
    tmain, _, tloss, tgrads, _ = build_deepfm(ptt, sparse)
    watch = _amp_vars(main)
    assert watch == _amp_vars(tmain)
    feed = ctr_feed(0, sparse)

    def jax_step(amp):
        for n, a in state.items():
            jscope.set_var(n, a)
        pt.core.flags.set_flag("amp_bf16", amp)
        try:
            return jexe.run(main, feed=feed, fetch_list=grads + watch)
        finally:
            pt.core.flags.set_flag("amp_bf16", False)

    f32 = jax_step(False)
    amp = jax_step(True)
    tscope = ptt.Scope()
    texe = ptt.Executor(ptt.CPUPlace(), scope=tscope)
    ptt.io.params_from_numpy(tscope, state, ptt.CPUPlace())
    ptt.flags.set_flag("amp_bf16", True)
    try:
        tout = texe.run(tmain, feed=feed, fetch_list=tgrads + watch,
                        return_numpy=False)
    finally:
        ptt.flags.set_flag("amp_bf16", False)
    n = len(grads)
    jdt = [str(np.asarray(a).dtype) for a in amp[n:]]
    tdt = [str(t.dtype).split(".")[-1] for t in tout[n:]]
    assert tdt == jdt
    assert "bfloat16" in tdt and "float32" in tdt
    assert {t.dtype for t in tout[:n]} == {torch.float32}

    def flat(arrays):
        return np.concatenate([np.asarray(a, np.float64).ravel()
                               for a in arrays])

    fg = flat(f32[:n])
    d_jax = np.linalg.norm(flat(amp[:n]) - fg) / np.linalg.norm(fg)
    d_port = np.linalg.norm(flat([t.float().numpy() for t in tout[:n]])
                            - fg) / np.linalg.norm(fg)
    k, c = AMP_GRAD_SLACK
    assert 0 < d_port <= k * d_jax + c, (d_port, d_jax)
    loss_i = watch.index(tloss.name)
    assert abs(scalar(tout[n + loss_i].float()) - scalar(f32[n + loss_i])) \
        <= 2e-2 * abs(scalar(f32[n + loss_i]))


# =====================================================================
# serving and the host metric
# =====================================================================

def test_port_predictor_serves_the_jax_saved_deepfm(tmp_path):
    """The dense build from its JAX startup, saved with ``prob`` as the
    fetch (feeds feat_ids, feat_vals), served by the port's Predictor;
    metrics.Auc of the served probs against the labels equals JAX's."""
    main, startup, _, _, prob = build_deepfm(pt, opt=False)
    exe = pt.Executor(pt.CPUPlace(), scope=pt.Scope())
    exe.run(startup)
    d = str(tmp_path)
    pt.io.save_inference_model(d, ["feat_ids", "feat_vals"], [prob], exe,
                               main_program=main)
    batch = tdfm.make_fake_batch(tiny_cfg(tdfm), 64, seed=77)
    feed = {k: batch[k] for k in ("feat_ids", "feat_vals")}
    want, = jpred.create_predictor(
        jpred.AnalysisConfig(d, use_tpu=False)).run(feed)
    p = create_predictor(AnalysisConfig(d, use_gpu=False))
    assert sorted(p.get_input_names()) == ["feat_ids", "feat_vals"]
    got, = p.run(feed)
    assert got.shape == (64, 1)
    np.testing.assert_allclose(got, np.asarray(want), **PRED_TOL)
    aucs = []
    for mod, probs in ((tmetrics, got), (jmetrics, np.asarray(want))):
        m = mod.Auc()
        m.update(probs, batch["label"])
        aucs.append(m.eval())
    assert aucs[0] == aucs[1] and 0 < aucs[0] < 1


# =====================================================================
# the sparse plane's host modules and the metrics: the JAX copies
# =====================================================================

def test_hash_bucket_and_partition_rows_match_jax():
    ids = np.concatenate([np.random.RandomState(1).randint(
        -2**62, 2**62, 500, dtype=np.int64),
        np.array([0, 2**31, 2**32, -1, 2**63 - 1, -2**63], np.int64)])
    for n in (1, 7, 1 << 16, 1000001):
        np.testing.assert_array_equal(ttable.hash_bucket(ids, n),
                                      jtable.hash_bucket(ids, n))
    rows = ttable.hash_bucket(ids, 97)
    mine, theirs = (ttable.partition_rows(rows, 4),
                    jtable.partition_rows(rows, 4))
    assert sorted(mine) == sorted(theirs)
    for s in mine:
        np.testing.assert_array_equal(mine[s], theirs[s])


def test_selected_rows_match_jax():
    rng = np.random.RandomState(2)
    rows = np.array([5, 1, 5, 9, 1, 5], np.int64)
    vals = rng.randn(6, 3).astype("float32")
    mine, theirs = tsr.SelectedRows(rows, vals, 12), jsr.SelectedRows(
        rows, vals, 12)
    for a, b in ((mine.merged(), theirs.merged()),
                 (tsr.SelectedRows.from_wire(mine.to_wire()), theirs)):
        np.testing.assert_array_equal(a.rows, b.rows)
        np.testing.assert_array_equal(a.values, b.values)
        assert a.height == b.height
    np.testing.assert_array_equal(mine.to_dense(), theirs.to_dense())
    m = mine.merged()
    assert m.rows.tolist() == [1, 5, 9] and m.merged() is m
    dense = mine.to_dense()
    np.testing.assert_array_equal(
        tsr.SelectedRows.from_dense(dense).rows,
        jsr.SelectedRows.from_dense(dense).rows)
    for bad in ([12], [-1]):
        with pytest.raises(ValueError):
            tsr.SelectedRows(bad, np.zeros((1, 3)), 12)


@pytest.mark.parametrize("optimizer,int8", [("sgd", False),
                                            ("adagrad", False),
                                            ("adagrad", True)])
def test_embedding_shard_matches_jax(optimizer, int8):
    """Two shards of one table in both packages, the same SelectedRows
    pushes (duplicate ids among them): pulls, versions, counters and the
    state documents agree, and from_state restores."""
    rng = np.random.RandomState(3)
    for shard in (0, 1):
        cfgs = [m.TableConfig("t", rows=40, dim=4, seed=5,
                              learning_rate=0.1, optimizer=optimizer,
                              int8_rows=int8) for m in (ttable, jtable)]
        mine = ttable.EmbeddingShard(cfgs[0], shard, 2)
        theirs = jtable.EmbeddingShard(cfgs[1], shard, 2)
        owned = np.arange(shard, 40, 2)
        for _ in range(3):
            rows = rng.choice(owned, 6)
            vals = rng.randn(6, 4).astype("float32")
            assert mine.apply(tsr.SelectedRows(rows, vals, 40)) == \
                theirs.apply(jsr.SelectedRows(rows, vals, 40))
        np.testing.assert_array_equal(mine.pull(owned), theirs.pull(owned))
        np.testing.assert_array_equal(mine.dense(), theirs.dense())
        assert mine.state_doc() == theirs.state_doc()
        assert mine.state_bytes() == theirs.state_bytes()
        back = ttable.EmbeddingShard.from_state(mine.state_doc())
        np.testing.assert_array_equal(back.dense(), mine.dense())
        with pytest.raises(ValueError):
            mine.pull([owned[0] + 1])


def test_host_metrics_match_jax():
    rng = np.random.RandomState(4)
    probs = rng.rand(200, 1)
    labels = (rng.rand(200) < probs[:, 0]).astype("float32")
    out = []
    for mod in (tmetrics, jmetrics):
        auc = mod.Auc(num_thresholds=255)
        auc.update(probs[:120], labels[:120])
        auc.update(np.concatenate([1 - probs[120:], probs[120:]], 1),
                   labels[120:])
        acc = mod.Accuracy()
        acc.update(0.5, 10)
        acc.update(0.8, 30)
        comp = mod.CompositeMetric()
        comp.add_metric(mod.Accuracy())
        comp.add_metric(mod.EditDistance())
        comp.update((0.25, 4), (np.array([1.0, 2.0, 0.0]), 3))
        dm = mod.DetectionMAP()
        dm.update(np.array([[0, 0.9, 0, 0, 2, 2], [0, 0.6, 5, 5, 6, 6],
                            [1, 0.7, 1, 1, 3, 3]]),
                  np.array([[0, 0, 2, 2], [1, 1, 3, 3], [4, 4, 5, 5]]),
                  np.array([0, 1, 0]))
        out.append((auc.eval(), acc.eval(), comp.eval(), dm.eval()))
    assert out[0] == out[1]
    assert 0.5 < out[0][0] < 1


# =====================================================================
# the verifier's sparse rules and the lint CLI
# =====================================================================

def _sparse_rule_findings(pkg, case):
    """The error findings (code, message) of verify_program on one of
    the JAX package's sparse-rule programs
    (tests/test_sparse_plane.py::test_sparse_op_shape_infer_rules)."""
    from importlib import import_module
    analysis = import_module(pkg.__name__ + ".analysis")
    LayerHelper = import_module(
        pkg.__name__ + ".framework.layer_helper").LayerHelper
    layers = pkg.layers
    pkg.reset_default_programs()
    main = pkg.Program()
    with pkg.program_guard(main, pkg.Program()):
        if case in ("good", "float_ids"):
            dtype = "int64" if case == "good" else "float32"
            ids = layers.data("ids", [4], dtype=dtype)
            out = layers.sparse_embedding(ids, size=[32, 8])
            feed = ["ids"]
        else:
            w = layers.data("w", [8], dtype="float32")
            i = layers.data("i", [], dtype="int64")
            g = layers.data("g", [3 if case == "transposed_grad" else 8],
                            dtype="float32")
            h = LayerHelper("sparse_scatter_update")
            out = h.create_variable_for_type_inference("float32")
            h.append_op("sparse_scatter_update",
                        {"W": [w], "Ids": [i], "Grad": [g]},
                        {"Out": [out]}, {"learning_rate": 0.1})
            feed = ["w", "i", "g"]
    res = analysis.verify_program(main, feed=feed, fetch_list=[out])
    shape = None if out.shape is None else tuple(out.shape)
    return sorted((f.code, str(f)) for f in res.errors), shape


@pytest.mark.parametrize("case", ["good", "float_ids", "transposed_grad",
                                  "scatter_ok"])
def test_sparse_op_rules_find_what_jax_finds(case):
    mine = _sparse_rule_findings(ptt, case)
    theirs = _sparse_rule_findings(pt, case)
    assert mine == theirs
    errors = " ".join(m for _, m in mine[0])
    assert ("must be integer" in errors) == (case == "float_ids")
    assert ("trailing dim" in errors) == (case == "transposed_grad")


@pytest.mark.parametrize("model", ["deepfm", "deepfm_sparse"])
def test_lint_counts_match_the_jax_cli(model):
    """The port's CLI builds the JAX CLI's DeepFM (F 4, V 50, K 4, towers
    (8, 8)) with SGD(0.01) and finds the same (errors, warnings)."""
    mine = tlint.lint_model(model, tlint.model_builders()[model])
    theirs = jlint.lint_model(model, jlint.model_builders()[model])
    assert mine == theirs == (0, 0)
