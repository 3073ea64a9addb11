"""AlexNet, GoogLeNet and SE-ResNeXt-50 (models/alexnet.py, googlenet.py,
se_resnext.py) through both packages, trained with Momentum(0.01, 0.9).

AlexNet and GoogLeNet on 3x64x64 and class_dim 10 (the lint CLI's
shapes); SE-ResNeXt-50 with one block a stage (stage_blocks (1, 1, 1, 1):
every op and shape kind of the depth-50 build) on 3x32x32; batch 4.  The
JAX package builds and initialises each program on the CPU; its state is
carried into the port with ``io.params_from_numpy``.  Every dropout rate
is set to 0 in both programs (torch's Philox draws other masks than JAX's
threefry; the dropout op's own parity is tests/test_torch_dropout.py's).

Each step is taken by both packages from JAX's state before it, and the
port's relu ops take JAX's branches (``chip_smoke.replayed_relu_masks``
with the signs of JAX's relu inputs of that step): at batch 4 one relu
unit whose pre-activation lies within rounding of 0 moves a late conv's
weight gradient by percents (a 4 x 2 x 2 map: 16 positions a weight
entry), so two correct f32 implementations part there.  Readings on
their own branches: one unit of 1.08 million parts at GoogLeNet's first
step (its gradients 2.4e-2 of their max apart,
test_one_relu_flip_moves_a_late_gradient), one of 0.4 million at
SE-ResNeXt's first and third (4.3e-3 and 3.0e-2).  f32 tolerances, from
the readings beside them:

- loss: rtol 1e-5 (readings 1.5e-7 at AlexNet, 1.9e-7 at GoogLeNet);
  1e-4 at SE-ResNeXt (5.6e-6), tests/test_torch_resnet.py's: its 4-entry
  batch statistics amplify rounding as ResNet's do (a 1e-6 relative
  change of the input moves its gradients by 3.4e-4 of their max);
- every @GRAD: max |port - JAX| within 1e-4 of max |JAX| for each tensor
  (readings 9.2e-7 at AlexNet, 2.0e-6 at GoogLeNet); 2e-3 at SE-ResNeXt
  (1.0e-3; test_torch_resnet.py's STATE_RTOL);
- every velocity, param change and running-stat change: within 2e-3 of
  max |JAX| (readings up to 3.2e-5 at AlexNet, 8.8e-6 at GoogLeNet, 1.0e-3
  at SE-ResNeXt, its running stats 8.4e-5).

Under FLAGS_amp_bf16 (the programs built with the flag off, as
tests/test_torch_amp.py builds them) each of 3 steps is taken from JAX's
AMP state by JAX f32, JAX AMP and the port AMP, each on its own relu
branches.  The port's AMP gradient is held to JAX's f32 one as JAX's AMP
one is: its largest distance over the steps at most 1.5x JAX's largest
plus 0.1 (readings, port against JAX: 0.068 / 0.068 at AlexNet, 0.115 /
0.116 at GoogLeNet, 0.558 / 0.693 at SE-ResNeXt, where the per-step
distances cross: 0.56 against 0.30 at one step, 0.35 against 0.69 at the
next).  The AMP losses within the reference's bf16 tolerance 2e-2 of the
f32 loss (readings up to 9.3e-3 for the port, 1.4e-2 for JAX; the losses
grow to 32 and 57 at AlexNet's and GoogLeNet's third step, Momentum(0.01)
without batch norm).  Op by op the AMP policy of the new ops is held tight
(test_convnet_amp_policy_matches_jax).
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from chip_smoke import replayed_relu_masks
from paddle_tpu.analysis import lint as jlint
from paddle_tpu.models import alexnet as jalex
from paddle_tpu.models import googlenet as jgoog
from paddle_tpu.models import se_resnext as jsex
from paddle_tpu_torch.analysis import lint as tlint
from paddle_tpu_torch.models import alexnet as talex
from paddle_tpu_torch.models import googlenet as tgoog
from paddle_tpu_torch.models import se_resnext as tsex
from test_torch_resnet import _bf16, flat, rel_of_max
from test_torch_train import _op_view, _var_view

BATCH, STEPS, LR, MU = 4, 3, 0.01, 0.9
MODELS = ("alexnet", "googlenet", "se_resnext")
MODS = {"alexnet": (jalex, talex), "googlenet": (jgoog, tgoog),
        "se_resnext": (jsex, tsex)}
SMALL = {"alexnet": dict(class_dim=10, img_shape=(3, 64, 64)),
         "googlenet": dict(class_dim=10, img_shape=(3, 64, 64)),
         "se_resnext": dict(class_dim=10, img_shape=(3, 32, 32), depth=50,
                            stage_blocks=(1, 1, 1, 1))}
# the loss, relative; each @GRAD, of max |JAX| per tensor
LOSS_RTOL = {"alexnet": 1e-5, "googlenet": 1e-5, "se_resnext": 1e-4}
GRAD_RTOL = {"alexnet": 1e-4, "googlenet": 1e-4, "se_resnext": 2e-3}
STATE_RTOL = 2e-3          # of max |JAX| per tensor, on each step's change
AMP_GRAD_SLACK = (1.5, 0.1)
AMP_LOSS_RTOL = 2e-2       # the reference's bf16 tolerance
AMP_OP_RTOL = 2.0 ** -7    # one bf16 step at the largest entry


@pytest.fixture(autouse=True)
def fresh_port_programs():
    ptt.reset_default_programs()
    yield
    ptt.reset_default_programs()
    pt.core.flags.set_flag("amp_bf16", False)
    ptt.flags.set_flag("amp_bf16", False)


def build(pkg, model, opt=True, no_dropout=True, **kw):
    """(main, startup, loss, grad names, relu inputs) of `model`'s
    training program in fresh programs of `pkg`, Momentum(LR, MU) with
    `opt`, every dropout rate 0 with `no_dropout`."""
    mod = MODS[model][0 if pkg is pt else 1]
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup):
        _, loss, _, _ = mod.build_train_net(**dict(SMALL[model], **kw))
        grads = []
        if opt:
            _, pg = pkg.optimizer.Momentum(learning_rate=LR,
                                           momentum=MU).minimize(loss)
            grads = [g.name for _, g in pg]
    if no_dropout:
        for op in main.global_block().ops:
            if op.type == "dropout":
                op.attrs["dropout_prob"] = 0.0
    relus = [op.inputs["X"][0] for op in main.global_block().ops
             if op.type == "relu"]
    return main, startup, loss, grads, relus


def batches(model, n=STEPS, seed=0):
    shape = SMALL[model]["img_shape"]
    r = np.random.RandomState(seed)
    return [{"img": r.randn(BATCH, *shape).astype("float32"),
             "label": r.randint(0, 10, (BATCH, 1)).astype("int64")}
            for _ in range(n)]


def persistables(prog):
    return sorted(v.name for v in prog.list_vars() if v.persistable)


def signs(arrays):
    return [torch.from_numpy((np.asarray(a, np.float32) > 0).astype(
        "float32")) for a in arrays]


@pytest.fixture(scope="module")
def jax_programs():
    """One JAX build and initial state a model, shared by the tests."""
    out = {}
    for model in MODELS:
        main, startup, loss, grads, relus = build(pt, model)
        scope = pt.Scope()
        exe = pt.Executor(pt.CPUPlace(), scope=scope)
        exe.run(startup)
        out[model] = dict(main=main, loss=loss, grads=grads, relus=relus,
                          exe=exe, scope=scope,
                          init={n: np.asarray(scope.find_var(n))
                                for n in persistables(main)})
    return out


def _jax_step(j, feed, state):
    """One JAX step from `state`: (loss, grads, relu signs, state after)."""
    for n, a in state.items():
        j["scope"].set_var(n, a)
    out = j["exe"].run(j["main"], feed=feed,
                       fetch_list=[j["loss"]] + j["grads"] + j["relus"])
    n = 1 + len(j["grads"])
    return (float(np.asarray(out[0]).reshape(())), out[1:n],
            signs(out[n:]),
            {k: np.asarray(j["scope"].find_var(k)) for k in state})


def _port(model):
    main, _, loss, grads, relus = build(ptt, model)
    scope = ptt.Scope()
    return dict(main=main, loss=loss, grads=grads, relus=relus, scope=scope,
                exe=ptt.Executor(ptt.CPUPlace(), scope=scope))


def _port_step(t, feed, state, masks=None, fetch_relus=False):
    """One port step from `state`, its relus taking `masks` where given:
    (loss, grads, state after, loss dtype[, relu inputs])."""
    ptt.io.params_from_numpy(t["scope"], state, ptt.CPUPlace())
    fetch = [t["loss"]] + t["grads"] + (t["relus"] if fetch_relus else [])
    if masks is None:
        out = t["exe"].run(t["main"], feed=feed, fetch_list=fetch,
                           return_numpy=False)
    else:
        with replayed_relu_masks(masks) as left:
            out = t["exe"].run(t["main"], feed=feed, fetch_list=fetch,
                               return_numpy=False)
        assert not left
    n = 1 + len(t["grads"])
    res = (float(out[0].float().reshape(())),
           [g.float().numpy() for g in out[1:n]],
           {k: t["scope"].find_var(k).float().numpy() for k in state},
           out[0].dtype)
    return res + ([x.float().numpy() for x in out[n:]],) if fetch_relus \
        else res


@pytest.fixture(scope="module")
def f32_steps(jax_programs):
    """Per model and step: (JAX loss, port loss, JAX grads, port grads,
    state before, JAX state after, port state after), each step from
    JAX's state before it, the port taking JAX's relu branches."""
    out = {}
    for model in MODELS:
        j, t = jax_programs[model], _port(model)
        assert persistables(t["main"]) == sorted(j["init"])
        assert t["grads"] == j["grads"] and len(t["relus"]) == len(
            j["relus"])
        state, rows = j["init"], []
        for feed in batches(model):
            jl, jg, masks, jafter = _jax_step(j, feed, state)
            tl, tg, tafter, dtype = _port_step(t, feed, state, masks)
            assert dtype == torch.float32
            rows.append((jl, tl, jg, tg, state, jafter, tafter))
            state = jafter
        out[model] = dict(rows=rows, main=t["main"], grads=t["grads"])
    return out


# =====================================================================
# the build
# =====================================================================

@pytest.mark.parametrize("model", MODELS)
def test_build_serializes_like_jax(model):
    """Op list, slots, attrs, var names and shapes, and the params, of the
    Momentum training program (dropout as built) and its startup
    program."""
    theirs = build(pt, model, no_dropout=False)
    mine = build(ptt, model, no_dropout=False)
    for t, j in ((mine[0], theirs[0]), (mine[1], theirs[1])):
        assert _op_view(t) == _op_view(j)
        assert _var_view(t) == _var_view(j)
    assert ({p.name: (tuple(p.shape), p.dtype, p.trainable)
             for p in mine[0].all_parameters()}
            == {p.name: (tuple(p.shape), p.dtype, p.trainable)
                for p in theirs[0].all_parameters()})
    for v in theirs[0].list_vars():
        if v.dtype.startswith("float"):
            assert mine[0].global_block().var(v.name).dtype == v.dtype
    types = [op.type for op in mine[0].global_block().ops]
    n_train = sum(p.trainable for p in mine[0].all_parameters())
    assert types.count("momentum") == n_train
    want = {"alexnet": {"lrn": 2, "dropout": 2, "concat": 0},
            "googlenet": {"lrn": 0, "dropout": 3, "concat": 9},
            "se_resnext": {"lrn": 0, "dropout": 1, "concat": 0}}[model]
    assert {k: types.count(k) for k in want} == want
    if model == "se_resnext":
        groups = [op.attrs["groups"] for op in mine[0].global_block().ops
                  if op.type == "conv2d"]
        assert groups.count(32) == 4


@pytest.mark.parametrize("model", MODELS)
def test_full_width_builds_like_jax(model):
    """bench.py's shapes (3x224x224, class_dim 1000; SE-ResNeXt at depth
    50 with all its blocks): JAX's op count, output shape and param
    shapes."""
    kw = dict(class_dim=1000, img_shape=(3, 224, 224))
    if model == "se_resnext":
        kw["stage_blocks"] = None
    counts = []
    for pkg in (pt, ptt):
        main = build(pkg, model, opt=False, no_dropout=False, **kw)[0]
        preds = [op.outputs["Out"][0] for op in main.global_block().ops
                 if op.type == "softmax"]
        counts.append((len(main.global_block().ops),
                       [tuple(main.global_block().var(p).shape)
                        for p in preds],
                       sorted((p.name, tuple(p.shape))
                              for p in main.all_parameters())))
    assert counts[0] == counts[1]
    assert counts[1][1] == [(-1, 1000)] * (3 if model == "googlenet" else 1)


# =====================================================================
# training: Momentum, f32 and AMP
# =====================================================================

@pytest.mark.parametrize("model", MODELS)
def test_momentum_losses_match_jax(f32_steps, model):
    rows = f32_steps[model]["rows"]
    assert len(rows) == STEPS
    for jl, tl, *_ in rows:
        assert math.isfinite(tl)
        assert tl == pytest.approx(jl, rel=LOSS_RTOL[model])


@pytest.mark.parametrize("model", MODELS)
def test_grads_match_jax_on_jax_relu_branches(f32_steps, model):
    names = f32_steps[model]["grads"]
    for step, (_, _, jg, tg, *_) in enumerate(f32_steps[model]["rows"]):
        for n, got, want in zip(names, tg, jg):
            want = np.asarray(want)
            assert got.shape == want.shape, n
            err = rel_of_max(got, want)
            assert err <= GRAD_RTOL[model], (step, n, err)


@pytest.mark.parametrize("kind", ["velocity", "param", "running_stat"])
@pytest.mark.parametrize("model", MODELS)
def test_momentum_state_matches_jax_every_step(f32_steps, model, kind):
    """Each step's change of every velocity, param and running stat
    (SE-ResNeXt's batch norms; AlexNet and GoogLeNet have none)."""
    main = f32_steps[model]["main"]
    names = {"velocity": [n for n in persistables(main)
                          if n.endswith(".velocity")],
             "param": [p.name for p in main.all_parameters()
                       if p.trainable],
             "running_stat": [p.name for p in main.all_parameters()
                              if not p.trainable]}[kind]
    n_bn = sum(op.type == "batch_norm" for op in main.global_block().ops)
    assert (n_bn > 0) == (model == "se_resnext")
    if kind == "running_stat":
        assert len(names) == 2 * n_bn
    else:
        assert len(names) == len(f32_steps[model]["grads"])
    for step, (*_, before, jafter, tafter) in enumerate(
            f32_steps[model]["rows"]):
        for n in names:
            want = jafter[n] - (0 if kind == "velocity" else before[n])
            got = tafter[n] - (0 if kind == "velocity" else before[n])
            assert np.abs(want).max() > 0, (step, n)
            err = rel_of_max(got, want)
            assert err <= STATE_RTOL, (step, n, err)


def test_one_relu_flip_moves_a_late_gradient(jax_programs):
    """Why the steps take JAX's relu branches: from JAX's initial state on
    the first batch, the port's own relu branches part from JAX's at a
    unit or so (one of 1.08 million in the reading), which moves
    GoogLeNet's gradients by more than 1e-3 of their max (reading 2.4e-2,
    conv2d_60's weight at the 2x2 stage); on JAX's branches they agree
    within GRAD_RTOL (reading 2.0e-6)."""
    j, t = jax_programs["googlenet"], _port("googlenet")
    feed = batches("googlenet", n=1)[0]
    _, jg, masks, _ = _jax_step(j, feed, j["init"])
    _, own, _, _, relu_in = _port_step(t, feed, j["init"], fetch_relus=True)
    flips = sum(int(((a > 0) != m.numpy().astype(bool)).sum())
                for a, m in zip(relu_in, masks))
    free = max(rel_of_max(a, b) for a, b in zip(own, jg))
    _, kept, _, _ = _port_step(t, feed, j["init"], masks=masks)
    replayed = max(rel_of_max(a, b) for a, b in zip(kept, jg))
    assert flips >= 1 and free > 1e-3, (flips, free)
    assert replayed <= GRAD_RTOL["googlenet"], replayed


@pytest.mark.parametrize("model", MODELS)
def test_amp_step_is_as_close_to_f32_as_jax_amp(jax_programs, model):
    """Programs built with the flag off, run with it on.  Each of 3 steps
    from JAX's AMP state before it: JAX f32, JAX AMP and port AMP from
    the same state (each taking its own relu branches); the port's AMP
    gradient and loss held to JAX's f32 ones as JAX's AMP ones are."""
    j, t = jax_programs[model], _port(model)
    state, dists = j["init"], []
    for step, feed in enumerate(batches(model, seed=7)):
        pt.core.flags.set_flag("amp_bf16", False)
        fl, fg, _, _ = _jax_step(j, feed, state)
        pt.core.flags.set_flag("amp_bf16", True)
        ptt.flags.set_flag("amp_bf16", True)
        try:
            al, ag, _, after = _jax_step(j, feed, state)
            tl, tg, _, dtype = _port_step(t, feed, state)
        finally:
            pt.core.flags.set_flag("amp_bf16", False)
            ptt.flags.set_flag("amp_bf16", False)
        assert dtype == torch.bfloat16
        fg, ag, tg = flat(fg), flat(ag), flat(tg)
        d_jax = np.linalg.norm(ag - fg) / np.linalg.norm(fg)
        d_port = np.linalg.norm(tg - fg) / np.linalg.norm(fg)
        dists.append((d_port, d_jax))
        assert abs(tl - fl) <= AMP_LOSS_RTOL * abs(fl), (step, tl, fl, al)
        assert abs(al - fl) <= AMP_LOSS_RTOL * abs(fl), (step, al, fl)
        state = after
    k, c = AMP_GRAD_SLACK
    port, jax_ = (max(d) for d in zip(*dists))
    assert 0 < port <= k * jax_ + c, dists


# (op, inputs, attrs, compared slots, bf16 input slots) under
# FLAGS_amp_bf16: the bf16 conv outputs these ops take
AMP_OPS = {
    "lrn_alexnet": ("lrn", lambda r: {
        "X": [np.maximum(r.randn(2, 16, 6, 6), 0).astype("float32") * 4]},
        {"n": 5, "k": 1.0, "alpha": 1e-4, "beta": 0.75}, ["Out", "MidOut"],
        ("X",)),
    "lrn_wide_alpha": ("lrn", lambda r: {
        "X": [r.randn(2, 9, 5, 5).astype("float32") * 3]},
        {"n": 3, "k": 2.0, "alpha": 0.05, "beta": 0.5}, ["Out", "MidOut"],
        ("X",)),
    "concat_towers": ("concat", lambda r: {
        "X": [r.randn(2, c, 4, 4).astype("float32") for c in (3, 5, 2, 4)]},
        {"axis": 1}, ["Out"], ("X",)),
    "adaptive_avg_pool": ("pool2d", lambda r: {
        "X": [r.randn(2, 6, 8, 8).astype("float32")]},
        {"pooling_type": "avg", "ksize": [2, 2], "strides": [2, 2],
         "paddings": [0, 0]}, ["Out"], ("X",)),
    "se_gate_axis0": ("elementwise_mul", lambda r: {
        "X": [r.randn(2, 6, 4, 4).astype("float32")],
        "Y": [r.rand(2, 6).astype("float32")]},
        {"axis": 0}, ["Out"], ("X", "Y")),
    "relu": ("relu", lambda r: {"X": [r.randn(3, 7).astype("float32")]},
             {}, ["Out"], ("X",)),
}


@pytest.mark.parametrize("name", sorted(AMP_OPS))
def test_convnet_amp_policy_matches_jax(name):
    """The new ops of these builds under FLAGS_amp_bf16 against the JAX
    lowering under the flag: the same output dtypes, values within one
    bf16 step (AMP_OP_RTOL) of max |JAX|; bf16 inputs go in as bf16 on
    both sides (lrn's window sum runs in bf16 in both packages: reading
    0.75 steps)."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.framework.registry import LowerContext as JaxCtx
    from paddle_tpu.framework.registry import get_op_def as jax_op
    from paddle_tpu_torch.framework.registry import LowerContext as TorchCtx
    from paddle_tpu_torch.framework.registry import get_op_def

    op, make, attrs, slots, bf = AMP_OPS[name]
    ins = make(np.random.RandomState(len(name)))
    ins = {k: [_bf16(a) if k in bf else a for a in v]
           for k, v in ins.items()}
    pt.core.flags.set_flag("amp_bf16", True)
    ptt.flags.set_flag("amp_bf16", True)
    try:
        jouts = jax_op(op).lower(JaxCtx(jax.random.PRNGKey(0)), {
            k: [jnp.asarray(a).astype(jnp.bfloat16 if k in bf else None)
                for a in v] for k, v in ins.items()}, attrs)
        touts = get_op_def(op).lower(TorchCtx(0, torch.device("cpu")), {
            k: [torch.from_numpy(np.array(a)).to(torch.bfloat16)
                if k in bf else torch.from_numpy(np.array(a)) for a in v]
            for k, v in ins.items()}, attrs)
    finally:
        pt.core.flags.set_flag("amp_bf16", False)
        ptt.flags.set_flag("amp_bf16", False)
    for slot in slots:
        j, t = jouts[slot][0], touts[slot][0]
        assert str(t.dtype).split(".")[-1] == str(j.dtype), slot
        assert tuple(t.shape) == tuple(j.shape), slot
        err = rel_of_max(t.float().numpy(), np.asarray(j, np.float32))
        assert err <= AMP_OP_RTOL, (slot, err)


# =====================================================================
# the lint CLI
# =====================================================================

@pytest.mark.parametrize("model", MODELS)
def test_lint_counts_match_the_jax_cli(model):
    """The port's CLI builds JAX's builder shapes with JAX's SGD(0.01)
    and finds the same (errors, warnings)."""
    mine = tlint.lint_model(model, tlint.model_builders()[model])
    theirs = jlint.lint_model(model, jlint.model_builders()[model])
    assert mine == theirs == (0, 0)
