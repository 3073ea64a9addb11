"""The dense op plane's layers (layers/nn.py, layers/tensor.py and the
sequence.py wrappers over its ops) through both packages.

- Each family of layers builds the JAX package's program (op list,
  slots, attrs, var names and shapes, params) and, run by the Executor on
  the CPU from JAX's initial state, gives JAX's outputs: EXACT (1e-5)
  where a value is arithmetic, bit for bit where it is an index or a
  copy; the random layers by shape and dtype only.
- A small program over stack, pad2d, image_resize, where, prelu,
  smooth_l1 and argsort trains 3 SGD steps from JAX's initialisation
  within ``tests/test_torch_train.py``'s tolerances: loss rtol 1e-5, every
  @GRAD of step 1 rtol 1e-4 atol 1e-6, params atol 2e-6.
- ``layers.auc`` over 4 batches: the persistable StatPos/StatNeg equal
  JAX's op's and the host ``metrics.Auc``'s bit for bit, the AUC within
  1e-6 of both.
- DeepFM at width 8 with ``layers.auc`` beside its loss: 3 Adagrad steps
  match JAX's (the loss, the AUC and its state, the params).
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import deepfm as jdfm
from paddle_tpu_torch import metrics as tmetrics
from paddle_tpu_torch.models import deepfm as tdfm
from test_torch_nmt import check_serializes_like_jax, persistables

EXACT = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_ATOL = 2e-6
AUC_ATOL = 1e-6
B = 4


@pytest.fixture(autouse=True)
def fresh_port_programs():
    ptt.reset_default_programs()
    yield
    ptt.reset_default_programs()


def _act_net(pkg):
    L = pkg.layers
    x = L.data("x", [6])
    outs = [getattr(L, n)(x) for n in ptt.layers.nn.UNARY_LAYERS
            if n not in ("log", "sqrt", "rsqrt", "reciprocal")]
    pos = L.abs(x)
    outs += [L.log(L.scale(pos, bias=0.5)), L.sqrt(pos), L.rsqrt(
        L.scale(pos, bias=0.5)), L.reciprocal(L.scale(pos, bias=0.5))]
    outs += [L.pow(x, factor=2.0), L.leaky_relu(x, alpha=0.1),
             L.brelu(x, t_min=-0.5, t_max=0.5), L.prelu(x),
             L.clip(x, -0.3, 0.3), L.clip_by_norm(x, 1.0)]
    img = L.data("img", [4, 3, 3])
    outs += [L.maxout(img, groups=2), L.prelu(img, mode="channel"),
             L.prelu(img, mode="element")]
    return outs


def _manip_net(pkg):
    L = pkg.layers
    x = L.data("x", [6])
    img = L.data("img", [4, 3, 3])
    ids = L.data("ids", [1], dtype="int64")
    cond = L.data("cond", [6], dtype="bool")
    st = L.stack([x, L.scale(x, 2.0)], axis=1)
    outs = [st] + L.unstack(st, axis=1)
    outs += [L.flatten(img, axis=2), L.reduce_min(img, dim=[1, 2]),
             L.reduce_prod(img, dim=1),
             L.scatter(x, ids, L.scale(x, 3.0)),
             L.scatter(x, ids, x, overwrite=False),
             L.mul(img, L.assign(np.ones((9, 2), "float32")),
                   x_num_col_dims=2),
             L.elementwise_max(x, L.scale(x, -1.0)),
             L.elementwise_min(x, L.scale(x, -1.0)),
             L.elementwise_pow(L.abs(x), L.scale(x, 0.5)),
             L.pad(x, [0, 1, 2, 0], pad_value=0.5),
             L.pad2d(img, [1, 0, 2, 1], mode="reflect"),
             L.pad2d(img, [1, 1, 0, 2], mode="edge"),
             L.where(cond, x, L.scale(x, -2.0)),
             L.argmin(x, axis=1), L.argmax(img, axis=1),
             L.reverse(img, [1, 3]), L.zeros_like(x), L.ones_like(img)]
    outs += list(L.argsort(x, axis=1, descending=True))
    outs += [L.crop(img, shape=[-1, 2, 2, 3], offsets=[0, 1, 1, 0]),
             L.pad_constant_like(img, L.crop(img, shape=[-1, 2, 2, 2],
                                               offsets=[0, 0, 0, 0]),
                                 pad_value=1.0),
             L.space_to_depth(L.pad2d(img, [0, 1, 0, 1]), 2),
             L.multiplex([x, L.scale(x, 2.0)], L.cast(
                 L.argmax(L.assign(np.eye(B, 2, dtype="float32")),
                          axis=1), "int32")),
             L.shape(img)]
    return outs


def _math_net(pkg):
    L = pkg.layers
    x = L.data("x", [6])
    y = L.data("y", [4])
    img = L.data("img", [4, 3, 3])
    lab = L.data("lab", [1], dtype="int64")
    return [L.l2_normalize(x, axis=1), L.l2_normalize(img, axis=1,
                                                      epsilon=1e-6),
            L.bilinear_tensor_product(x, y, 5, act="tanh"),
            L.linspace(0, 3, 7), L.eye(3, 4), L.diag(np.arange(3.0, dtype="float32")),
            L.smooth_l1(x, L.scale(x, 0.5), sigma=2.0),
            L.huber_loss(x, L.scale(x, -1.0), 0.7),
            L.bpr_loss(L.softmax(y), lab),
            L.rank_loss(L.data("rl", [1]), L.reduce_sum(x, dim=1,
                                                        keep_dim=True),
                        L.reduce_mean(x, dim=1, keep_dim=True)),
            L.margin_rank_loss(L.data("ml", [1]), L.reduce_max(
                x, dim=1, keep_dim=True), L.reduce_min(
                x, dim=1, keep_dim=True)),
            L.log_loss(L.sigmoid(L.reduce_sum(y, dim=1, keep_dim=True)),
                       L.data("ll", [1])),
            L.dice_loss(L.softmax(y), L.data("dl", [4]))]


def _metric_net(pkg):
    L = pkg.layers
    prob = L.data("prob", [2])
    lab = L.data("lab", [1], dtype="int64")
    hyp = L.data("hyp", [5], dtype="int64")
    ref = L.data("ref", [4], dtype="int64")
    auc, _ = L.auc(prob, lab, num_thresholds=200)
    ed, num = L.edit_distance(hyp, ref, normalized=False)
    ed_n, _ = L.edit_distance(hyp, ref, ignored_tokens=[1, 3])
    miou, wrong, correct = L.mean_iou(L.argmax(prob, axis=1),
                                      L.reshape(lab, [-1]), 2)
    return [auc, ed, num, ed_n, miou, wrong, correct]


def _resize_net(pkg):
    L = pkg.layers
    img = L.data("img", [2, 5, 6])
    return [L.image_resize(img, out_shape=[8, 9]),
            L.resize_bilinear(img, out_shape=[3, 4], align_corners=False),
            L.resize_nearest(img, out_shape=[7, 3]),
            L.resize_nearest(img, scale=2.0),
            L.image_resize_short(img, 3)]


def _random_net(pkg):
    L = pkg.layers
    x = L.data("x", [6])
    probs = L.softmax(L.data("y", [4]))
    return [L.uniform_random_batch_size_like(x, [-1, 3], min=-0.5, max=0.5),
            L.gaussian_random_batch_size_like(x, [-1, 5], std=0.5),
            L.gaussian_random([3, 4], mean=1.0), L.uniform_random([2, 5]),
            L.sampling_id(probs)]


FAMILIES = {"activation": _act_net, "manip": _manip_net,
            "math": _math_net, "metric": _metric_net, "resize": _resize_net,
            "random": _random_net}


def _feed(r):
    return {"x": r.randn(B, 6).astype("float32"),
            "y": r.randn(B, 4).astype("float32"),
            "img": r.randn(B, 4, 3, 3).astype("float32"),
            "ids": np.array([[2], [0], [2], [3]], "int64"),
            "cond": r.rand(B, 6) < 0.5,
            "lab": r.randint(0, 2, (B, 1)).astype("int64"),
            "rl": r.randint(0, 2, (B, 1)).astype("float32"),
            "ml": np.sign(r.randn(B, 1)).astype("float32"),
            "ll": r.randint(0, 2, (B, 1)).astype("float32"),
            "dl": r.randint(0, 2, (B, 4)).astype("float32"),
            "prob": r.rand(B, 2).astype("float32"),
            "hyp": r.randint(0, 5, (B, 5)).astype("int64"),
            "ref": r.randint(0, 5, (B, 4)).astype("int64")}


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
    res = {}
    init = None
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
    for i, (a, b) in enumerate(zip(mine, theirs)):
        assert a.shape == b.shape, i
        if family == "random":
            assert a.dtype.kind == b.dtype.kind, i
            continue
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b, err_msg=str(i))
        else:
            np.testing.assert_allclose(a, b, err_msg=str(i), **EXACT)


def test_every_listed_layer_is_exported_like_jax():
    """The layers of this plane, where JAX's ``layers`` package exports
    them."""
    names = (["reduce_min", "reduce_prod", "stack", "unstack", "flatten",
              "scatter", "mul", "auc", "clip", "clip_by_norm",
              "elementwise_max", "elementwise_min", "elementwise_pow", "pow",
              "prelu", "maxout", "pad", "pad2d", "image_resize",
              "resize_bilinear", "resize_nearest", "l2_normalize",
              "smooth_l1", "huber_loss", "uniform_random_batch_size_like",
              "gaussian_random", "uniform_random", "where", "argmin",
              "argmax", "argsort", "ones_like", "zeros_like", "reverse",
              "linspace", "diag", "eye", "bpr_loss", "rank_loss",
              "margin_rank_loss", "log_loss", "dice_loss", "mean_iou",
              "edit_distance", "crop", "pad_constant_like", "space_to_depth",
              "multiplex", "shape", "gaussian_random_batch_size_like",
              "sampling_id", "bilinear_tensor_product", "image_resize_short"]
             + list(ptt.layers.nn.UNARY_LAYERS))
    for n in names:
        assert hasattr(pt.layers, n) and hasattr(ptt.layers, n), n


# ---------------------------------------------------------------------
# a small program over the plane's layers, trained 3 SGD steps

LR = 0.1
STEPS = 3


def _train_net(pkg):
    L = pkg.layers
    img = L.data("img", [2, 5, 5])
    label = L.data("label", [4])
    h = L.pad2d(img, [1, 0, 0, 1], mode="reflect")
    h = L.image_resize(h, out_shape=[4, 4])
    h = L.flatten(h, axis=1)
    a = L.fc(h, 8)
    b = L.fc(h, 8)
    h = L.prelu(L.stack([a, b], axis=1), mode="channel")
    h = L.reshape(h, [-1, 16])
    h = L.where(L.greater_than(h, L.scale(h, -1.0)), h, L.scale(h, 0.5))
    h, _ = L.argsort(h, axis=1, descending=True)
    pred = L.fc(h, 4)
    loss = L.mean(L.smooth_l1(pred, label, sigma=1.5))
    _, pg = pkg.optimizer.SGD(learning_rate=LR).minimize(loss)
    return loss, [g.name for _, g in pg]


def test_small_program_trains_like_jax():
    r = np.random.RandomState(11)
    feeds = [{"img": r.randn(B, 2, 5, 5).astype("float32"),
              "label": r.randn(B, 4).astype("float32")}
             for _ in range(STEPS)]
    sides = {}
    init = None
    for pkg in (pt, ptt):
        pkg.reset_default_programs()
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 17
        with pkg.program_guard(main, startup):
            loss, grads = _train_net(pkg)
        exe = pkg.Executor(pkg.CPUPlace(), scope=pkg.Scope())
        exe.run(startup)
        names = persistables(main)
        if pkg is pt:
            init = {n: np.asarray(exe.scope.find_var(n)) for n in names}
        else:
            ptt.io.params_from_numpy(exe.scope, init, ptt.CPUPlace())
        runs = [[np.asarray(o) for o in exe.run(main, feed=f,
                                                 fetch_list=[loss] + grads)]
                for f in feeds]
        state = {n: np.asarray(exe.scope.find_var(n)) if pkg is pt
                 else exe.scope.find_var(n).numpy() for n in names}
        sides[pkg] = (main, startup, runs, state, grads)
    check_serializes_like_jax(sides[ptt][:2], sides[pt][:2])
    assert sides[ptt][4] == sides[pt][4]
    for step, (t, j) in enumerate(zip(sides[ptt][2], sides[pt][2])):
        np.testing.assert_allclose(t[0], j[0], rtol=LOSS_RTOL)
        if step == 0:
            for name, a, b in zip(sides[pt][4], t[1:], j[1:]):
                np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)
                assert np.abs(b).max() > 0, name
    for n, want in sides[pt][3].items():
        np.testing.assert_allclose(sides[ptt][3][n], want, rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)
        if n.endswith(".w_0"):
            assert not np.array_equal(want, init[n]), n


# ---------------------------------------------------------------------
# auc over 4 batches against JAX's op and the host metric

def test_auc_over_four_batches_matches_jax_and_host_auc():
    r = np.random.RandomState(21)
    batches = [(r.rand(64, 2).astype("float32"),
                r.randint(0, 2, (64, 1)).astype("int64")) for _ in range(4)]
    batches[1][0][:3] = [[0.0, 0.0], [1.0, 1.0], [0.5, 0.5]]  # the ends
    host = tmetrics.Auc("auc", num_thresholds=300)
    out = {}
    for pkg in (pt, ptt):
        pkg.reset_default_programs()
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            prob = pkg.layers.data("prob", [2])
            lab = pkg.layers.data("lab", [1], dtype="int64")
            auc, stats = pkg.layers.auc(prob, lab, num_thresholds=300)
        exe = pkg.Executor(pkg.CPUPlace(), scope=pkg.Scope())
        exe.run(startup)
        out[pkg] = [[np.asarray(o) for o in exe.run(
            main, feed={"prob": p, "lab": y}, fetch_list=[auc] + stats)]
            for p, y in batches]
    for i, (p, y) in enumerate(batches):
        host.update(p, y)
        mine, theirs = out[ptt][i], out[pt][i]
        for a, b, h in zip(mine[1:], theirs[1:], (host.stat_pos,
                                                   host.stat_neg)):
            assert a.shape == (301,)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, h)
        assert abs(float(mine[0]) - float(theirs[0])) <= AUC_ATOL
        assert abs(float(mine[0]) - host.eval()) <= AUC_ATOL
    assert 0.3 < host.eval() < 0.7


# ---------------------------------------------------------------------
# DeepFM at width 8 with its in-graph AUC, 3 Adagrad steps

def _deepfm(pkg):
    mod = jdfm if pkg is pt else tdfm
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 13
    with pkg.program_guard(main, startup):
        cfg = mod.DeepFMConfig(num_field=6, vocab_size=200, embed_dim=8,
                               fc_sizes=(8, 8))
        feeds, loss, prob = mod.build_train_net(cfg)
        auc, stats = pkg.layers.auc(prob, feeds[2])
        _, pg = pkg.optimizer.Adagrad(learning_rate=DFM_LR).minimize(loss)
    return main, startup, [loss, prob, auc] + stats, [g for _, g in pg], cfg


DFM_LR = 0.05
DFM_BATCH = 32
NEAR_ZERO = 1e-5


def test_deepfm_with_auc_trains_like_jax():
    """Each step: the loss (rtol 1e-5) and probabilities (atol 1e-6) as
    JAX's, the AUC state bit-equal to JAX's and to the host Auc fed the
    step's fetched probabilities, the AUC within 1e-6 of both; after 3
    steps the params as test_torch_deepfm.py holds them (atol 2e-6, an
    entry whose grad came within 1e-5 of zero held to lr)."""
    sides = {}
    init = None
    feeds = [tdfm.make_fake_batch(tdfm.DeepFMConfig(
        num_field=6, vocab_size=200, embed_dim=8, fc_sizes=(8, 8)),
        DFM_BATCH, seed=600 + s) for s in range(STEPS)]
    for pkg in (pt, ptt):
        main, startup, fetch, grads, _ = _deepfm(pkg)
        exe = pkg.Executor(pkg.CPUPlace(), scope=pkg.Scope())
        exe.run(startup)
        names = persistables(main)
        if pkg is pt:
            init = {n: np.asarray(exe.scope.find_var(n)) for n in names}
        else:
            ptt.io.params_from_numpy(exe.scope, init, ptt.CPUPlace())
        runs = [[np.asarray(o) for o in exe.run(
            main, feed=f, fetch_list=fetch + grads)] for f in feeds]
        state = {n: np.asarray(exe.scope.find_var(n)) if pkg is pt
                 else exe.scope.find_var(n).numpy() for n in names}
        sides[pkg] = (main, startup, runs, state, [g.name for g in grads])
    check_serializes_like_jax(sides[ptt][:2], sides[pt][:2])
    hosts = {pkg: tmetrics.Auc("auc") for pkg in sides}
    for step, feed in enumerate(feeds):
        for pkg in sides:
            got = sides[pkg][2][step]
            hosts[pkg].update(got[1], feed["label"])
            np.testing.assert_array_equal(got[3], hosts[pkg].stat_pos)
            np.testing.assert_array_equal(got[4], hosts[pkg].stat_neg)
            assert abs(float(got[2]) - hosts[pkg].eval()) <= AUC_ATOL
        t, j = sides[ptt][2][step], sides[pt][2][step]
        np.testing.assert_allclose(t[0], j[0], rtol=LOSS_RTOL)
        np.testing.assert_allclose(t[1], j[1], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(t[3], j[3])
        np.testing.assert_array_equal(t[4], j[4])
        assert abs(float(t[2]) - float(j[2])) <= AUC_ATOL
    assert hosts[ptt].stat_pos.sum() + hosts[ptt].stat_neg.sum() == \
        STEPS * DFM_BATCH
    grads = sides[pt][4]
    assert sides[ptt][4] == grads
    near = {g[:-len("@GRAD")]: np.any(
        [(r[5 + k] != 0) & (abs(r[5 + k]) < NEAR_ZERO)
         for r in sides[pt][2] + sides[ptt][2]], 0)
        for k, g in enumerate(grads)}
    for n, want in sides[pt][3].items():
        got = sides[ptt][3][n]
        if n in near:
            np.testing.assert_allclose(got[near[n]], want[near[n]], rtol=0,
                                       atol=DFM_LR, err_msg=n)
            got = np.where(near[n], 0, got)
            want = np.where(near[n], 0, want)
        tol = (dict(rtol=0, atol=PARAM_ATOL) if n in near
               else dict(rtol=1e-4, atol=1e-7))
        np.testing.assert_allclose(got, want, err_msg=n, **tol)
