"""The image classifiers through both packages: ResNet (models/resnet.py),
LeNet and VGG, trained with Momentum and SGD and served by the Predictor.

ResNet-18 and a ResNet-50 with one bottleneck block a stage (every op and
shape kind of ResNet-50, at a quarter of its blocks) on 3x32x32, class_dim
10, batch 4.  The JAX package builds and initialises each program on the
CPU; its whole state is carried into the port with
``io.params_from_numpy``.

Each Momentum step is taken by both packages from JAX's state before it
(the port's state is reset to JAX's every step).  A free-running
trajectory is not comparable: at batch 4 the batch statistics of the last
stage (a 1x1 map, 4 entries a channel) amplify rounding, and a 1e-6
relative change of the input moves ResNet-18's step-1 gradients by
1.8e-4 of their max and the ResNet-50's by 4.5e-4, so two correct f32
implementations part within three steps
(test_batch4_gradients_amplify_rounding).  lr is 0.01, not the bench's
0.1, which at this batch saturates the softmax within a few steps and
amplifies rounding further.  f32 tolerances, from the readings beside
them:

- loss: rtol 1e-4 (readings up to 1.3e-5; test_torch_train.py's 1e-5
  is below what the 4-entry statistics leave);
- every velocity, every param's update and every running stat's update
  (state after less state before): max |port - JAX| within 2e-3 of
  max |JAX| for each tensor (readings up to 3.7e-4).

Under FLAGS_amp_bf16 (the programs built with the flag off, as
tests/test_torch_amp.py builds them: the JAX build would declare bf16
filters) bf16 activations round 4e-3 apart, which the same amplification
turns into gradients that differ by O(1) between the packages, and
between JAX's AMP and its own f32 (JAX's AMP step-1 gradient is 0.84 of
the f32 gradient's norm away from it at ResNet-18).  So the port's AMP
step is held to the f32 step as JAX's is: the distance of the port's AMP
gradient from JAX's f32 gradient at most 1.5x JAX's AMP distance plus
0.1 (readings: the port's 0.42-0.81 where JAX's were 0.41-0.86, the
port's the larger in 3 of 6 steps), and the AMP loss within 0.1 of the
f32 loss (readings up to 0.069; JAX's up to 0.062; three to six bf16
steps at |loss| 3-5); the forward under AMP runs on bf16 activations.
Op by op, where the conditioning is fine, the AMP policy is held tight
(test_conv_plane_amp_policy_matches_jax): the same output dtypes as
JAX's lowerings and values within AMP_OP_RTOL of max |JAX|.  The served
forward (is_test: running statistics, no batch coupling) is well
conditioned: the port's Predictor on a JAX-saved model
matches JAX's Predictor at rtol 1e-4 (atol 1e-6) in f32, and at 2e-2 of
max |JAX| under AMP.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.analysis import lint as jlint
from paddle_tpu.inference import predictor as jpred
from paddle_tpu.models import lenet as jlenet
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.models import vgg as jvgg
from paddle_tpu_torch.analysis import lint as tlint
from paddle_tpu_torch.framework.registry import get_op_def
from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
from paddle_tpu_torch.models import lenet as tlenet
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models import vgg as tvgg
from test_torch_train import _op_view, _var_view

BATCH, STEPS, LR, MU = 4, 3, 0.01, 0.9
IMG = (3, 32, 32)
LOSS_RTOL = 1e-4
STATE_RTOL = 2e-3          # of max |JAX| per tensor, on each step's change
AMP_GRAD_SLACK = (1.5, 0.1)
AMP_LOSS_ATOL = 0.1
GRAD_FLOOR = 1e-5
PRED_TOL = dict(rtol=1e-4, atol=1e-6)
AMP_PRED_RTOL = 2e-2
AMP_OP_RTOL = 2.0 ** -7   # one bf16 step at the largest entry
MODELS = ("resnet18", "resnet50_1block")


@pytest.fixture(autouse=True)
def fresh_port_programs():
    ptt.reset_default_programs()
    yield
    ptt.reset_default_programs()
    pt.core.flags.set_flag("amp_bf16", False)
    ptt.flags.set_flag("amp_bf16", False)


@pytest.fixture
def one_block_resnet50(monkeypatch):
    """models.resnet's ResNet-50 with one bottleneck block a stage, in
    both packages, for the length of one test."""
    for mod in (jresnet, tresnet):
        monkeypatch.setitem(mod._DEPTH_CFG, 50,
                            (mod.bottleneck_block, [1, 1, 1, 1]))


def _depth(model):
    return {"resnet18": 18, "resnet50_1block": 50}[model]


def build(pkg, mod, model, opt=None, is_test=False):
    """(main, startup, loss, acc, prediction, grad names) in fresh
    programs of `pkg`; `opt` attaches an optimizer."""
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup):
        if mod in (jresnet, tresnet):
            _, loss, acc, pred = mod.build_train_net(
                class_dim=10, img_shape=IMG, depth=_depth(model),
                is_test=is_test)
        elif mod in (jlenet, tlenet):
            _, loss, acc, pred = mod.build_train_net()
        else:
            _, loss, acc, pred = mod.build_train_net(class_dim=10,
                                                     img_shape=IMG)
        grads = []
        if opt is not None:
            _, pg = opt(pkg).minimize(loss)
            grads = [g.name for _, g in pg]
    return main, startup, loss, acc, pred, grads


def momentum(pkg):
    return pkg.optimizer.Momentum(learning_rate=LR, momentum=MU)


def batches(shape=IMG, n=STEPS, seed=0):
    r = np.random.RandomState(seed)
    return [{"img": r.randn(BATCH, *shape).astype("float32"),
             "label": r.randint(0, 10, (BATCH, 1)).astype("int64")}
            for _ in range(n)]


def persistables(prog):
    return sorted(v.name for v in prog.list_vars() if v.persistable)


def jax_state(scope, names):
    return {n: np.asarray(scope.find_var(n)) for n in names}


def port_state(scope, names):
    return {n: scope.find_var(n).float().numpy() for n in names}


def rel_of_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def flat(arrays):
    return np.concatenate([np.asarray(a, np.float64).ravel()
                           for a in arrays])


@pytest.fixture(scope="module")
def jax_programs():
    """One JAX build and initial state a model, shared by the tests."""
    out = {}
    for model in MODELS:
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(jresnet._DEPTH_CFG, 50,
                       (jresnet.bottleneck_block, [1, 1, 1, 1]))
            main, startup, loss, acc, pred, grads = build(
                pt, jresnet, model, momentum)
        scope = pt.Scope()
        exe = pt.Executor(pt.CPUPlace(), scope=scope)
        exe.run(startup)
        out[model] = dict(main=main, startup=startup, loss=loss, acc=acc,
                          pred=pred, grads=grads, exe=exe, scope=scope,
                          init=jax_state(scope, persistables(main)))
    return out


# =====================================================================
# the build
# =====================================================================

@pytest.mark.usefixtures("one_block_resnet50")
@pytest.mark.parametrize("model", MODELS + ("lenet", "vgg"))
def test_build_serializes_like_jax(model):
    """Op list, slots, attrs, var names and shapes, and the params, of the
    Momentum training program and its startup program."""
    mods = {"lenet": (jlenet, tlenet), "vgg": (jvgg, tvgg)}.get(
        model, (jresnet, tresnet))
    theirs = build(pt, mods[0], model, momentum)
    mine = build(ptt, mods[1], model, momentum)
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
    assert {"conv2d", "batch_norm", "pool2d", "cross_entropy", "top_k",
            "accuracy"} <= set(types)


def test_resnet_depths_build_at_full_width():
    """Every depth of _DEPTH_CFG (ResNet-50 whole) and resnet_cifar10
    build in the port with JAX's op count and param shapes (ImageNet
    shape, class_dim 1000)."""
    assert tresnet._DEPTH_CFG[50][1] == [3, 4, 6, 3]
    for depth in (18, 34, 50, 101, 152):
        counts = []
        for pkg, mod in ((pt, jresnet), (ptt, tresnet)):
            pkg.reset_default_programs()
            main = pkg.Program()
            with pkg.program_guard(main, pkg.Program()):
                img = pkg.layers.data("img", [3, 224, 224])
                pred = mod.resnet_imagenet(img, 1000, depth=depth)
            counts.append((len(main.global_block().ops), tuple(pred.shape),
                           sorted((p.name, tuple(p.shape))
                                  for p in main.all_parameters())))
        assert counts[0] == counts[1], depth
        assert counts[1][1] == (-1, 1000)
    for pkg, mod in ((pt, jresnet), (ptt, tresnet)):
        pkg.reset_default_programs()
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            img = pkg.layers.data("img", list(IMG))
            counts.append((len(main.global_block().ops),
                           tuple(mod.resnet_cifar10(img, 10, 20).shape)))
    assert counts[-1] == counts[-2] and counts[-1][1] == (-1, 10)


# =====================================================================
# training: Momentum, f32 and AMP
# =====================================================================

def _jax_step(j, feed, state):
    """One JAX step from `state`: (loss, grads, state after)."""
    for n, a in state.items():
        j["scope"].set_var(n, a)
    out = j["exe"].run(j["main"], feed=feed,
                       fetch_list=[j["loss"]] + j["grads"])
    return (float(np.asarray(out[0]).reshape(())), out[1:],
            jax_state(j["scope"], state))


def _port_step(t, feed, state):
    """One port step from `state`: (loss, grads, state after, the loss
    tensor's dtype)."""
    ptt.io.params_from_numpy(t["scope"], state, ptt.CPUPlace())
    out = t["exe"].run(t["main"], feed=feed,
                       fetch_list=[t["loss"]] + t["grads"],
                       return_numpy=False)
    return (float(out[0].float().reshape(())),
            [g.float().numpy() for g in out[1:]],
            port_state(t["scope"], list(state)), out[0].dtype)


def _port(model):
    main, startup, loss, acc, pred, grads = build(ptt, tresnet, model,
                                                  momentum)
    scope = ptt.Scope()
    return dict(main=main, loss=loss, grads=grads, scope=scope,
                exe=ptt.Executor(ptt.CPUPlace(), scope=scope))


@pytest.fixture(scope="module")
def f32_steps(jax_programs):
    """Per model and step: (JAX loss, port loss, state before, JAX state
    after, port state after), each step from JAX's state before it."""
    out = {}
    for model in MODELS:
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(tresnet._DEPTH_CFG, 50,
                       (tresnet.bottleneck_block, [1, 1, 1, 1]))
            t = _port(model)
        j = jax_programs[model]
        assert persistables(t["main"]) == sorted(j["init"])
        assert t["grads"] == j["grads"]
        state, rows = j["init"], []
        for feed in batches():
            jl, _, jafter = _jax_step(j, feed, state)
            tl, _, tafter, dtype = _port_step(t, feed, state)
            assert dtype == torch.float32
            rows.append((jl, tl, state, jafter, tafter))
            state = jafter
        out[model] = dict(rows=rows, main=t["main"], scope=t["scope"])
    return out


@pytest.mark.usefixtures("one_block_resnet50")
@pytest.mark.parametrize("model", MODELS)
def test_batch4_gradients_amplify_rounding(jax_programs, model):
    """Why the steps are compared one at a time: a 1e-6 relative change
    of the input moves the port's own step-1 gradients by more than 20x
    that, of their max (readings 1.8e-4 at ResNet-18, 4.5e-4 at the
    one-block ResNet-50)."""
    t = _port(model)
    feed = batches(n=1)[0]
    noise = np.random.RandomState(1).randn(*feed["img"].shape)
    shaken = dict(feed, img=(feed["img"] * (1 + 1e-6 * noise)).astype(
        "float32"))
    init = jax_programs[model]["init"]
    _, grads, _, _ = _port_step(t, feed, init)
    _, moved, _, _ = _port_step(t, shaken, init)
    err = max(rel_of_max(a, b) for a, b in zip(moved, grads))
    assert err > 2e-5, err


@pytest.mark.parametrize("model", MODELS)
def test_momentum_losses_match_jax(f32_steps, model):
    rows = f32_steps[model]["rows"]
    assert len(rows) == STEPS
    for jl, tl, *_ in rows:
        assert math.isfinite(tl)
        assert tl == pytest.approx(jl, rel=LOSS_RTOL)


@pytest.mark.parametrize("kind", ["velocity", "param", "running_stat"])
@pytest.mark.parametrize("model", MODELS)
def test_momentum_state_matches_jax_every_step(f32_steps, model, kind):
    """Each step's change of every velocity, param and running stat."""
    main = f32_steps[model]["main"]
    names = {"velocity": [n for n in persistables(main)
                          if n.endswith(".velocity")],
             "param": [p.name for p in main.all_parameters()
                       if p.trainable],
             "running_stat": [p.name for p in main.all_parameters()
                              if not p.trainable]}[kind]
    n_bn = sum(op.type == "batch_norm" for op in main.global_block().ops)
    assert len(names) == {"velocity": 3 * n_bn + 2, "param": 3 * n_bn + 2,
                          "running_stat": 2 * n_bn}[kind]
    for step, (_, _, before, jafter, tafter) in enumerate(
            f32_steps[model]["rows"]):
        for n in names:
            want = jafter[n] - (0 if kind == "velocity" else before[n])
            got = tafter[n] - (0 if kind == "velocity" else before[n])
            assert np.abs(want).max() > 0, (step, n)
            err = rel_of_max(got, want)
            assert err <= STATE_RTOL, (step, n, err)


@pytest.mark.parametrize("model", MODELS)
def test_scope_holds_no_autograd_state_after_training(f32_steps, model):
    scope = f32_steps[model]["scope"]
    names = persistables(f32_steps[model]["main"])
    for n in names:
        t = scope.find_var(n)
        assert not t.requires_grad and t.grad_fn is None, n


def test_executor_refuses_a_graph_attached_persistable(monkeypatch):
    """A batch_norm lowering that forgot to detach its running mean: the
    run raises before the scope takes the tensor."""
    main, startup, loss, _, _, _ = build(ptt, tresnet, "resnet18", momentum)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace(), scope=scope)
    exe.run(startup)
    opdef = get_op_def("batch_norm")
    lower = opdef.lower

    def leaky(ctx, ins, attrs):
        outs = lower(ctx, ins, attrs)
        outs["MeanOut"] = [outs["MeanOut"][0] + 0 * outs["SavedMean"][0]]
        return outs

    monkeypatch.setattr(opdef, "lower", leaky)
    before = {n: scope.find_var(n) for n in persistables(main)
              if scope.find_var(n) is not None}
    with pytest.raises(ptt.core.enforce.EnforceNotMet, match="grad_fn"):
        exe.run(main, feed=batches(n=1)[0], fetch_list=[loss])
    # nothing of the refused run reached the scope
    assert all(scope.find_var(n) is t for n, t in before.items())


@pytest.mark.usefixtures("one_block_resnet50")
@pytest.mark.parametrize("model", MODELS)
def test_amp_step_is_as_close_to_f32_as_jax_amp(jax_programs, model):
    """Programs built with the flag off, run with it on.  Each of 3 steps
    from JAX's AMP state before it: JAX f32, JAX AMP and port AMP from
    the same state; the port's AMP gradient and loss held to JAX's f32
    ones as JAX's AMP ones are."""
    j = jax_programs[model]
    t = _port(model)
    state = j["init"]
    for step, feed in enumerate(batches()):
        pt.core.flags.set_flag("amp_bf16", False)
        fl, fg, _ = _jax_step(j, feed, state)
        pt.core.flags.set_flag("amp_bf16", True)
        ptt.flags.set_flag("amp_bf16", True)
        al, ag, after = _jax_step(j, feed, state)
        tl, tg, _, dtype = _port_step(t, feed, state)
        ptt.flags.set_flag("amp_bf16", False)
        # the port's forward ran on bf16 activations, its loss among them
        assert dtype == torch.bfloat16
        fg, ag, tg = flat(fg), flat(ag), flat(tg)
        d_jax = np.linalg.norm(ag - fg) / np.linalg.norm(fg)
        d_port = np.linalg.norm(tg - fg) / np.linalg.norm(fg)
        k, c = AMP_GRAD_SLACK
        assert d_port <= k * d_jax + c, (step, d_port, d_jax)
        assert abs(tl - fl) <= AMP_LOSS_ATOL, (step, tl, fl, al)
        assert abs(al - fl) <= AMP_LOSS_ATOL, (step, al, fl)
        state = after


def _bf16(a):
    return np.asarray(torch.from_numpy(a).to(torch.bfloat16).float())


# (op, inputs, attrs, compared slots) under FLAGS_amp_bf16; X inputs are
# bf16 activations (f32 arrays holding bf16 values), params f32
AMP_OPS = {
    "conv2d_bias": ("conv2d", lambda r: {
        "Input": [r.randn(2, 8, 9, 9).astype("float32")],
        "Filter": [r.randn(16, 8, 3, 3).astype("float32") * 0.2],
        "Bias": [r.randn(16).astype("float32")]},
        {"strides": [2, 2], "paddings": [1, 1]}, ["Output"]),
    "conv2d_bf16_input": ("conv2d", lambda r: {
        "Input": [_bf16(r.randn(2, 8, 9, 9).astype("float32"))],
        "Filter": [r.randn(8, 8, 1, 1).astype("float32")]},
        {}, ["Output"]),
    "batch_norm_train": ("batch_norm", lambda r: {
        "X": [_bf16(r.randn(4, 6, 5, 5).astype("float32") * 3 + 1)],
        "Scale": [r.randn(6).astype("float32")],
        "Bias": [r.randn(6).astype("float32")],
        "Mean": [np.zeros(6, "float32")],
        "Variance": [np.ones(6, "float32")]},
        {"momentum": 0.9}, ["Y", "MeanOut", "VarianceOut", "SavedMean",
                            "SavedVariance"]),
    "pool2d_max": ("pool2d", lambda r: {
        "X": [_bf16(r.randn(2, 4, 9, 9).astype("float32"))]},
        {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
         "paddings": [1, 1]}, ["Out"]),
    "pool2d_global_avg": ("pool2d", lambda r: {
        "X": [_bf16(r.randn(2, 4, 7, 7).astype("float32"))]},
        {"pooling_type": "avg", "ksize": [1, 1], "global_pooling": True},
        ["Out"], 2 * AMP_OP_RTOL),
    "cross_entropy": ("cross_entropy", lambda r: {
        "X": [_bf16(np.full((6, 10), 0.1, "float32")
                    + r.rand(6, 10).astype("float32") * 0.05)],
        "Label": [r.randint(0, 10, (6, 1))]}, {}, ["Y"]),
}


@pytest.mark.parametrize("name", sorted(AMP_OPS))
def test_conv_plane_amp_policy_matches_jax(name):
    """Each conv-plane op under FLAGS_amp_bf16 against the JAX lowering
    under the flag: the same output dtypes, values within AMP_OP_RTOL of
    max |JAX| (bf16 inputs go in as bf16 on both sides).  The average
    pool is held to two steps: XLA sums the bf16 window in bf16, torch in
    f32 (reading 1.07 steps)."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.framework.registry import LowerContext as JaxCtx
    from paddle_tpu.framework.registry import get_op_def as jax_op
    from paddle_tpu_torch.framework.registry import LowerContext as TorchCtx

    op, make, attrs, slots, *tol = AMP_OPS[name]
    tol = tol[0] if tol else AMP_OP_RTOL
    ins = make(np.random.RandomState(len(name)))
    bf = {"X"} if op != "conv2d" or name.endswith("bf16_input") else set()
    bf |= {"Input"} if name.endswith("bf16_input") else set()
    pt.core.flags.set_flag("amp_bf16", True)
    ptt.flags.set_flag("amp_bf16", True)
    try:
        jouts = jax_op(op).lower(JaxCtx(jax.random.PRNGKey(0)), {
            k: [jnp.asarray(a.astype(np.int32) if a.dtype == np.int64
                            else a).astype(jnp.bfloat16 if k in bf
                                           else None) for a in v]
            for k, v in ins.items()}, attrs)
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
        err = rel_of_max(t.float().numpy(), np.asarray(j, np.float32))
        assert err <= tol, (slot, err)


# =====================================================================
# serving: the Predictor on a JAX-saved model
# =====================================================================

@pytest.fixture(scope="module")
def jax_saved(jax_programs, tmp_path_factory):
    """ResNet-50 (one block a stage) after one JAX Momentum step (running
    stats moved), saved for inference; JAX's Predictor's answers."""
    j = jax_programs["resnet50_1block"]
    _jax_step(j, batches(n=1)[0], j["init"])
    d = str(tmp_path_factory.mktemp("resnet_infer"))
    pt.io.save_inference_model(d, ["img"], [j["pred"]], j["exe"],
                               main_program=j["main"])
    img = batches(n=1, seed=9)[0]["img"]
    p = jpred.create_predictor(jpred.AnalysisConfig(d, use_tpu=False))
    want = {}
    for amp in (False, True):
        pt.core.flags.set_flag("amp_bf16", amp)
        want[amp] = np.asarray(p.run({"img": img})[0], np.float32)
    pt.core.flags.set_flag("amp_bf16", False)
    return dict(dir=d, img=img, want=want)


@pytest.mark.parametrize("amp", [False, True])
def test_port_predictor_serves_the_jax_saved_resnet(jax_saved, amp):
    p = create_predictor(AnalysisConfig(jax_saved["dir"], use_gpu=False))
    ops = [op.type for op in p.program.global_block().ops]
    assert "momentum" not in ops and "autodiff" not in ops
    assert all(op.attrs["is_test"] for op in p.program.global_block().ops
               if op.type == "batch_norm")
    state = {n: t.clone() for n, t in p.state.items()}
    ptt.flags.set_flag("amp_bf16", amp)
    got, = p.run({"img": jax_saved["img"]})
    raw, = p.run({"img": jax_saved["img"]}, return_numpy=False)
    ptt.flags.set_flag("amp_bf16", False)
    want = jax_saved["want"][amp]
    assert got.shape == want.shape == (BATCH, 10)
    assert raw.dtype == (torch.bfloat16 if amp else torch.float32)
    if amp:
        assert rel_of_max(got, want) <= AMP_PRED_RTOL
    else:
        np.testing.assert_allclose(got, want, **PRED_TOL)
    # is_test batch norm writes no state: the running stats stay
    assert all(torch.equal(p.state[n], t) for n, t in state.items())


# =====================================================================
# LeNet and VGG: one SGD step
# =====================================================================

@pytest.mark.parametrize("model", ["lenet", "vgg"])
def test_sgd_step_matches_jax(model):
    """One SGD(0.01) step from JAX's initialisation: loss, every grad and
    every param after, within STATE_RTOL of the tensor's max plus
    GRAD_FLOOR of the model's largest gradient entry (lr times that on a
    param's change): the bias of a conv or fc that batch norm follows has
    a gradient of 0 in exact arithmetic, and both packages leave rounding
    residues of up to 3e-6 there.  VGG's
    dropout rates are set to 0 in both programs
    (torch's Philox draws other masks than JAX's threefry; the dropout
    op's own parity is tests/test_torch_dropout.py's)."""
    mods = {"lenet": (jlenet, tlenet), "vgg": (jvgg, tvgg)}[model]
    shape = (1, 28, 28) if model == "lenet" else IMG
    sgd = lambda pkg: pkg.optimizer.SGD(learning_rate=0.01)  # noqa: E731
    progs = [build(pkg, mod, model, sgd)
             for pkg, mod in ((pt, mods[0]), (ptt, mods[1]))]
    for main, *_ in progs:
        drops = [op for op in main.global_block().ops
                 if op.type == "dropout"]
        assert len(drops) == (0 if model == "lenet" else 10)
        for op in drops:
            op.attrs["dropout_prob"] = 0.0
    jmain, jstartup, jloss, _, _, jgrads = progs[0]
    tmain, _, tloss, _, _, tgrads = progs[1]
    jscope = pt.Scope()
    jexe = pt.Executor(pt.CPUPlace(), scope=jscope)
    jexe.run(jstartup)
    names = persistables(jmain)
    init = jax_state(jscope, names)
    feed = batches(shape=shape, n=1)[0]
    jout = jexe.run(jmain, feed=feed, fetch_list=[jloss] + jgrads)
    tscope = ptt.Scope()
    ptt.io.params_from_numpy(tscope, init, ptt.CPUPlace())
    tout = ptt.Executor(ptt.CPUPlace(), scope=tscope).run(
        tmain, feed=feed, fetch_list=[tloss] + tgrads)
    assert tgrads == jgrads
    assert float(tout[0].reshape(())) == pytest.approx(
        float(np.asarray(jout[0]).reshape(())), rel=LOSS_RTOL)
    floor = GRAD_FLOOR * max(np.abs(np.asarray(b)).max() for b in jout[1:])
    for n, a, b in zip(tgrads, tout[1:], jout[1:]):
        err = np.abs(np.asarray(a) - np.asarray(b)).max()
        assert err <= STATE_RTOL * np.abs(b).max() + floor, (n, err, floor)
    jafter, tafter = jax_state(jscope, names), port_state(tscope, names)
    for n in names:
        want, got = jafter[n] - init[n], tafter[n] - init[n]
        err = np.abs(got - want).max()
        assert err <= STATE_RTOL * np.abs(want).max() + 0.01 * floor, n


# =====================================================================
# the lint CLI
# =====================================================================

@pytest.mark.parametrize("model", ["lenet", "vgg", "resnet"])
def test_lint_counts_match_the_jax_cli(model):
    """The port's CLI builds JAX's builder shapes with JAX's SGD(0.01)
    and finds the same (errors, warnings)."""
    mine = tlint.lint_model(model, tlint.model_builders()[model])
    theirs = jlint.lint_model(model, jlint.model_builders()[model])
    assert mine == theirs == (0, 0)
