"""The sequence plane's layers (layers/sequence.py's wrappers over the
sequence, LoD, CTC, sampling, selected-rows and vision ops, and
``nn.sequence_mask``) through both packages.

- Each family of layers builds the JAX package's program (op list,
  slots, attrs, var names and shapes, params) and, run by the Executor on
  the CPU from JAX's initial state, gives JAX's outputs: EXACT (1e-5)
  where a value is arithmetic, MATMUL (rtol 1e-4) through the LSTMs,
  bit for bit where it is an index, an integer or a copy; nce's and
  random_crop's draws by shape and dtype only (torch's Philox is not
  JAX's threefry).
- A CTC acoustic model (fc relu -> row_conv -> layers.lstm, 2 layers,
  bidirectional -> fc -> warpctc -> mean; ctc_greedy_decoder and
  edit_distance fetched) at B 4, T 30, 13 features, hidden 16 and 6
  classes trains 3 Adam steps from JAX's initialisation within
  ``tests/test_torch_train.py``'s tolerances: the loss rtol 1e-5, every
  @GRAD of step 1 rtol 1e-4 atol 1e-6, the params atol 2e-6; the greedy
  ids and the edit distances equal.
- models/book.py's word2vec with an nce head and an hsigmoid head on
  its hidden layer beside its softmax: 3 Adam steps from JAX's
  initialisation at the same tolerances, nce's negatives fed to both
  packages (JAX's randint and the port's ``nce_negatives`` return one
  seeded draw).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import book as jbook
from paddle_tpu_torch.models import book as tbook
from paddle_tpu_torch.ops import sampling_ops
from test_torch_nmt import check_serializes_like_jax, persistables

EXACT = dict(rtol=1e-5, atol=1e-5)
MATMUL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_ATOL = 2e-6
B = 4


@pytest.fixture(autouse=True)
def fresh_port_programs():
    ptt.reset_default_programs()
    yield
    ptt.reset_default_programs()


def _seq_net(pkg):
    L = pkg.layers
    x = L.data("x", [5, 4])
    y = L.data("y", [3, 4])
    mask = L.data("mask", [5])
    length = L.data("length", [1], dtype="int64")
    ids = L.data("ids", [5], dtype="int64")
    sids = L.data("sids", [3], dtype="int64")
    upd = L.data("upd", [3])
    padded, plen = L.sequence_pad(x, pad_value=0.5, maxlen=7, length=length)
    return [L.sequence_context(x, 3), L.sequence_context(x, 4, -1),
            L.sequence_softmax(L.reduce_sum(x, dim=2), mask=mask),
            L.sequence_concat([x, y]), L.sequence_slice(x, 1, 3),
            L.sequence_expand(L.reduce_mean(y, dim=1), x),
            L.sequence_expand_as(L.reduce_max(x, dim=1), y), padded, plen,
            L.sequence_unpad(x, length), L.sequence_reshape(x, 2),
            L.sequence_enumerate(ids, 3, pad_value=1),
            L.sequence_scatter(L.reduce_sum(x, dim=2), sids, upd),
            L.sequence_reverse(x, length), L.sequence_reverse(y),
            L.lod_reset(y), L.row_conv(x, 2, act="tanh"),
            L.add_position_encoding(x, alpha=0.5, beta=2.0),
            L.sequence_mask(length, 6), L.sequence_mask(length, 5,
                                                        dtype="float32")]


def _rnn_net(pkg):
    L = pkg.layers
    x = L.data("x", [5, 4])
    out, last_h, last_c = L.lstm(x, hidden_size=3, num_layers=2,
                                 is_bidirec=True)
    one, h1, c1 = L.lstm(x, hidden_size=2)
    proj, cell = L.dynamic_lstmp(L.fc(x, 8, num_flatten_dims=2), 8, 3)
    return [out, last_h, last_c, one, h1, c1, proj, cell]


def _ctc_family(pkg):
    L = pkg.layers
    x = L.data("x", [5, 4])
    label = L.data("lab", [3], dtype="int64")
    tags = L.data("tags", [5], dtype="int64")
    tag_lab = L.data("tag_lab", [5], dtype="int64")
    length = L.data("length", [1], dtype="int64")
    label_len = L.data("label_len", [1], dtype="int64")
    return [L.warpctc(x, label, input_length=length, label_length=label_len),
            L.warpctc(x, label, blank=3, norm_by_times=True),
            L.ctc_greedy_decoder(x, blank=0),
            *L.chunk_eval(tags, tag_lab, "IOB", 2, excluded_chunk_types=[1])]


def _sampling_net(pkg):
    L = pkg.layers
    h = L.data("h", [6])
    word = L.data("word", [1], dtype="int64")
    return [L.nce(h, word, 10, num_neg_samples=3),
            L.hsigmoid(h, word, 10), L.hsigmoid(h, word, 7)]


def _ids_net(pkg):
    L = pkg.layers
    rows = L.data("rows", [2], dtype="int64")
    rid = L.data("rid", [1], dtype="int64", append_batch_size=False)
    vals = L.data("vals", [3], append_batch_size=False)
    uids, summed = L.merge_selected_rows(L.reshape(rid, [-1]), vals)
    return [L.hash(rows, 1000, num_hash=3), uids, summed,
            L.get_tensor_from_selected_rows(L.reshape(rid, [-1]), vals, 5)]


def _vision_net(pkg):
    L = pkg.layers
    img = L.data("img", [3, 5, 4])
    grid = L.data("grid", [3, 2, 2])
    box = L.data("box", [6], dtype="int64")
    return [L.im2sequence(img, [2, 2], [1, 2], [1, 0, 0, 1]),
            L.im2sequence(img, 2, 1, 0, per_example=True),
            L.grid_sampler(img, grid), L.affine_channel(img),
            L.random_crop(img, [4, 3]), L.similarity_focus(img, 1, [0, 2]),
            L.scale_sub_region(img, box, 3.0)]


FAMILIES = {"seq": _seq_net, "rnn": _rnn_net, "ctc": _ctc_family,
            "sampling": _sampling_net, "ids": _ids_net,
            "vision": _vision_net}
RANDOM = {"sampling": [0], "vision": [4]}       # nce's cost, the crop


def _feed(r):
    return {"x": r.randn(B, 5, 4).astype("float32"),
            "y": r.randn(B, 3, 4).astype("float32"),
            "mask": (np.arange(5)[None] < np.array([[5], [2], [3], [1]])
                     ).astype("float32"),
            "length": np.array([[5], [2], [0], [3]], "int64"),
            "label_len": np.array([[3], [1], [0], [2]], "int64"),
            "ids": r.randint(0, 9, (B, 5)).astype("int64"),
            "sids": np.array([[0, 0, -1], [4, 5, 1], [2, 3, -6],
                              [1, 1, 1]], "int64"),
            "upd": r.randn(B, 3).astype("float32"),
            "lab": r.randint(1, 4, (B, 3)).astype("int64"),
            "tags": r.randint(0, 5, (B, 5)).astype("int64"),
            "tag_lab": r.randint(0, 5, (B, 5)).astype("int64"),
            "h": r.randn(B, 6).astype("float32"),
            "word": r.randint(0, 10, (B, 1)).astype("int64"),
            "rows": np.array([[3, 2**31 + 5], [-2, 7], [0, 0], [11, 12]],
                             "int64"),
            "rid": np.array([[4], [1], [4], [0], [7]], "int64"),
            "vals": r.randn(5, 3).astype("float32"),
            "img": r.randn(B, 3, 5, 4).astype("float32"),
            "grid": (r.randn(B, 3, 2, 2) * 0.7).astype("float32"),
            "box": np.array([[1, 2, 1, 3, 2, 4], [3, 3, 2, 5, 1, 1],
                             [1, 1, 1, 1, 1, 1], [2, 3, 4, 5, 3, 4]],
                            "int64")}


def _build(pkg, net):
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup):
        fetches = net(pkg)
    return main, startup, fetches


def _run_family(net, feed):
    """Both packages' programs of `net`, the port's run from JAX's
    initial state: {pkg: (main, startup, outputs)}."""
    res, init = {}, None
    for pkg in (pt, ptt):
        main, startup, fetches = _build(pkg, net)
        exe = pkg.Executor(pkg.CPUPlace(), scope=pkg.Scope())
        exe.run(startup)
        names = persistables(main)
        if pkg is pt:
            init = {n: np.asarray(exe.scope.find_var(n)) for n in names}
        else:
            ptt.io.params_from_numpy(exe.scope, init, ptt.CPUPlace())
        used = {n: v for n, v in feed.items()
                if main.global_block().has_var(n)}
        outs = exe.run(main, feed=used, fetch_list=fetches)
        res[pkg] = (main, startup, [np.asarray(o) for o in outs])
    return res


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_builds_and_runs_like_jax(family):
    res = _run_family(FAMILIES[family], _feed(np.random.RandomState(3)))
    check_serializes_like_jax(res[ptt][:2], res[pt][:2])
    mine, theirs = res[ptt][2], res[pt][2]
    assert len(mine) == len(theirs)
    tol = MATMUL if family == "rnn" else EXACT
    for i, (a, b) in enumerate(zip(mine, theirs)):
        assert a.shape == b.shape, i
        if i in RANDOM.get(family, ()):
            assert a.dtype.kind == b.dtype.kind, i
        elif a.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b, err_msg=str(i))
        else:
            np.testing.assert_allclose(a, b, err_msg=str(i), **tol)


def test_sequence_layers_are_exported_like_jax():
    """Every public function of JAX's layers/sequence.py but detection's
    four is in the port's, and in its ``layers`` package where JAX's
    exports it; ``nn.sequence_mask`` too."""
    import inspect
    from paddle_tpu.layers import sequence as jseq
    names = [n for n, f in inspect.getmembers(jseq, inspect.isfunction)
             if f.__module__ == jseq.__name__ and not n.startswith("_")]
    missing = sorted(n for n in names if not hasattr(ptt.layers.sequence, n))
    assert missing == ["affine_grid", "psroi_pool", "roi_align", "roi_pool"]
    for n in names:
        if hasattr(pt.layers, n) and n not in missing:
            assert getattr(ptt.layers, n) is getattr(ptt.layers.sequence, n), n
    assert ptt.layers.sequence_mask is ptt.layers.nn.sequence_mask


# ---------------------------------------------------------------------
# the CTC acoustic model, trained 3 Adam steps

CTC = dict(T=30, F=13, H=16, C=6, S=8)
CTC_LR = 1e-3
STEPS = 3


def build_ctc(pkg, T, F, H, C, S, lr):
    """(main, startup, loss, @GRAD names, greedy ids, edit distances) of
    the CTC model: fc(H, relu) -> row_conv(2) -> lstm(H, 2 layers,
    bidirectional) -> fc(C) -> warpctc (blank 0, input and label
    lengths) -> mean, Adam(lr); ctc_greedy_decoder and edit_distance
    (ignoring the blank) beside it."""
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    L = pkg.layers
    with pkg.program_guard(main, startup):
        x = L.data("x", [T, F])
        label = L.data("label", [S], dtype="int64")
        in_len = L.data("input_length", [1], dtype="int64")
        lab_len = L.data("label_length", [1], dtype="int64")
        h = L.fc(x, H, num_flatten_dims=2, act="relu")
        h = L.row_conv(h, 2)
        h, _, _ = L.lstm(h, hidden_size=H, num_layers=2, is_bidirec=True)
        logits = L.fc(h, C, num_flatten_dims=2)
        loss = L.mean(L.warpctc(logits, label, blank=0, input_length=in_len,
                                label_length=lab_len))
        decoded = L.ctc_greedy_decoder(logits, blank=0)
        dist, _ = L.edit_distance(decoded, label, ignored_tokens=[0])
        _, pg = pkg.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss, [g.name for _, g in pg], decoded, dist


def ctc_feed(r, batch, T, F, C, S, in_lo, lab_lo):
    """Seeded features, input lengths in [in_lo, T], labels over 1 ..
    C - 1 (0 the blank) padded with 0 past lengths in [lab_lo, S]."""
    lab_len = r.randint(lab_lo, S + 1, (batch, 1)).astype("int64")
    label = r.randint(1, C, (batch, S)).astype("int64")
    label[np.arange(S)[None, :] >= lab_len] = 0
    return {"x": r.randn(batch, T, F).astype("float32"),
            "label": label,
            "input_length": r.randint(in_lo, T + 1, (batch, 1)).astype(
                "int64"),
            "label_length": lab_len}


def _three_steps(build, feeds):
    """Both packages' trajectories from JAX's initialisation: per step
    (fetches, per side), and the final states."""
    main, startup, loss, grads, *extra = build(pt)
    jscope = pt.Scope()
    jexe = pt.Executor(pt.CPUPlace(), scope=jscope)
    jexe.run(startup)
    names = persistables(main)
    init = {n: np.asarray(jscope.find_var(n)) for n in names}
    tmain, _, tloss, tgrads, *textra = build(ptt)
    check_serializes_like_jax((tmain, _), (main, startup))
    assert tgrads == grads
    tscope = ptt.Scope()
    texe = ptt.Executor(ptt.CPUPlace(), scope=tscope)
    ptt.io.params_from_numpy(tscope, init, ptt.CPUPlace())
    steps = []
    for feed in feeds:
        j = jexe.run(main, feed=feed, fetch_list=[loss] + grads + extra)
        t = texe.run(tmain, feed=feed, fetch_list=[tloss] + tgrads + textra)
        steps.append(([np.asarray(a) for a in j], [np.asarray(a) for a in t]))
    state = ({n: np.asarray(jscope.find_var(n)) for n in names},
             {n: tscope.find_var(n).numpy() for n in names})
    params = [p.name for p in main.all_parameters()]
    return steps, state, grads, params


def _check_trajectory(steps, state, grads, params, n_extra):
    for i, (j, t) in enumerate(steps):
        np.testing.assert_allclose(t[0], j[0], rtol=LOSS_RTOL,
                                   err_msg=f"loss {i}")
        for a, b in zip(t[len(t) - n_extra:], j[len(j) - n_extra:]):
            np.testing.assert_array_equal(a, b, err_msg=f"step {i}")
    for name, a, b in zip(grads, steps[0][1][1:], steps[0][0][1:]):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)
        assert np.abs(a).max() > 0, name
    for n in params:
        np.testing.assert_allclose(state[1][n], state[0][n], rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)


def test_ctc_program_trains_like_jax():
    """The CTC model of chip_smoke.py's phase 5o at B 4, T 30, 13
    features, hidden 16 and 6 classes: 3 Adam(1e-3) steps, JAX's loss
    each step, its step-1 @GRADs and its params after step 3 within
    test_torch_train.py's tolerances, the greedy ids and the edit
    distances equal every step; the loss falls."""
    r = np.random.RandomState(2026)
    feed = ctc_feed(r, B, CTC["T"], CTC["F"], CTC["C"], CTC["S"], 20, 3)
    steps, state, grads, params = _three_steps(
        lambda pkg: build_ctc(pkg, lr=CTC_LR, **CTC), [feed] * STEPS)
    assert len(grads) == 6
    _check_trajectory(steps, state, grads, params, 2)
    losses = [float(t[0]) for _, t in steps]
    assert losses[2] < losses[0], losses


def test_ctc_program_lowers_to_the_expected_ops():
    """The op list of the CTC model: fc's mul and add with relu, row_conv,
    cudnn_lstm, the logits' mul and add, warpctc and mean, the decode's
    arg_max and ctc_align, edit_distance over sequence_erase, then the
    autodiff op and Adam's six updates."""
    main = build_ctc(ptt, lr=CTC_LR, **CTC)[0]
    ops = [op.type for op in main.global_block().ops]
    assert ops == ["mul", "elementwise_add", "relu", "row_conv", "cudnn_lstm",
                   "mul", "elementwise_add", "warpctc", "mean", "arg_max",
                   "ctc_align", "sequence_erase", "sequence_erase",
                   "edit_distance", "autodiff"] + ["adam"] * 6


# ---------------------------------------------------------------------
# word2vec with nce and hsigmoid heads

W2V = dict(dict_size=40, embed_size=8, hidden_size=16)
NEG = 5


def build_w2v(pkg):
    """models/book.py's word2vec, with an nce head and an hsigmoid head on
    its hidden (sigmoid) layer added to its cost."""
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    book = jbook if pkg is pt else tbook
    L = pkg.layers
    with pkg.program_guard(main, startup):
        feeds, avg_cost, _ = book.word2vec(**W2V)
        hidden = [op for op in main.global_block().ops
                  if op.type == "sigmoid"][0].outputs["Out"][0]
        hidden = main.global_block().var(hidden)
        nce = L.nce(hidden, feeds[-1], W2V["dict_size"],
                    num_neg_samples=NEG)
        hs = L.hsigmoid(hidden, feeds[-1], W2V["dict_size"])
        loss = L.sums([avg_cost, L.mean(nce), L.mean(hs)])
        _, pg = pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return main, startup, loss, [g.name for _, g in pg]


def test_word2vec_nce_hsigmoid_head_trains_like_jax(monkeypatch):
    """3 Adam steps of word2vec with the two sampled heads from JAX's
    initialisation, one seeded draw of nce's negatives fed to both
    packages: JAX's losses, step-1 @GRADs and final params at
    test_torch_train.py's tolerances."""
    r = np.random.RandomState(8)
    feeds = [{**{f"word_{i}": r.randint(0, W2V["dict_size"], (B, 1))
                 .astype("int64") for i in range(4)},
              "next_word": r.randint(0, W2V["dict_size"], (B, 1)).astype(
                  "int64")} for _ in range(STEPS)]
    # one seeded draw for every run of both (JAX's jitted step keeps the
    # draw it traced with)
    neg = r.randint(0, W2V["dict_size"], (B, NEG))
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, lo, hi:
                        jnp.asarray(neg, jnp.int32))
    monkeypatch.setattr(sampling_ops, "nce_negatives",
                        lambda ctx, b, k, n, device: torch.from_numpy(
                            neg.astype("int64")).to(device))
    steps, state, grads, params = _three_steps(build_w2v, feeds)
    _check_trajectory(steps, state, grads, params, 0)
