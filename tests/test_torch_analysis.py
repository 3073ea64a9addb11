"""The port's static verifier (paddle_tpu_torch/analysis) against the JAX
package's (paddle_tpu/analysis), on the same programs.

- The planted-fault matrix of the JAX package's tests/test_analysis.py
  (:44-129), on one small net built in both packages: each fault gives
  the same (code, severity, op_index, op_type, var_names) findings.
- The flagship LM's programs (V 256, L 2, H 4, d_model 64, d_inner 128,
  T 32; unfused, fused, fuse_block after ``maybe_fuse``, the pruned
  ``is_test`` program, ``accumulate_steps`` 2, the global-norm clip with
  L2 decay) give the same findings in both, no error, and the port's
  inferred (shape, dtype) of every var equals JAX's.  The one gap is by
  design: int vars JAX computes on its 32-bit plane are int64 in the port
  (ROADMAP queue C), so ints compare by kind.
- The Executor's gate (after the JAX tests :208-306): ``error`` rejects
  in ``run`` and ``run_steps`` before any op runs; valid ``run_steps``
  slabs pass; ``warn`` warns once; ``off`` gives the outputs of today;
  the verdict is kept per key.
- FuseBlockTranspiler's post-condition names the transpiler on a planted
  miscompile (after :377); the ``mul`` and ``matmul`` rules agree with
  JAX's over a transpose and batch grid (after :564); the lint CLI's
  exit codes (after :677), and each of the JAX CLI's 19 models built by
  both CLIs with the same (errors, warnings) counts and the same
  unknown-shape op list (``static_rnn_scan`` is one of
  ``UNEVALUABLE_OPS``, and what reads its outputs falls back to the
  declared shapes, as in JAX).
"""
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import analysis as jan
from paddle_tpu.analysis import infer_rules as jrules
from paddle_tpu.analysis import lint as jlint_cli
from paddle_tpu.analysis.findings import AnalysisResult as JaxResult
from paddle_tpu.analysis.shape_inference import ShapeInferencePass as JaxSI
from paddle_tpu.models import transformer as jtr
from paddle_tpu.transpiler import fused_block as jfb
from paddle_tpu_torch import analysis as tan
from paddle_tpu_torch.analysis import infer_rules as trules
from paddle_tpu_torch.analysis import lint as lint_cli
from paddle_tpu_torch.analysis.findings import AnalysisResult as PortResult
from paddle_tpu_torch.analysis.shape_inference import (
    ShapeInferencePass as PortSI)
from paddle_tpu_torch.framework import executor as texecutor
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.transpiler import fused_block as tfb

T = 32
PKGS = {"jax": (pt, jan, jtr, jfb), "port": (ptt, tan, ttr, tfb)}


@pytest.fixture(autouse=True)
def port_isolation():
    """The port's planes, reset per test: tests/conftest.py resets only
    the JAX package's (its shape-rule registry, its verify_program
    flag)."""
    ptt.reset_default_programs()
    mode = ptt.flags.get_flag("verify_program")
    yield
    ptt.flags.set_flag("verify_program", mode)
    ptt.flags.set_flag("fuse_block", False)
    tan.reset()
    ptt.reset_default_programs()


def key(f):
    return (f.code, f.severity, f.op_index, f.op_type, f.var_names)


def keys(result):
    return sorted(map(key, result.findings))


# =====================================================================
# the planted-fault matrix
# =====================================================================

def small_net(pkg):
    """x[-1, 16] -> fc relu -> fc 4 -> mean softmax-CE against y."""
    x = pkg.layers.data("x", [16], dtype="float32")
    y = pkg.layers.data("y", [1], dtype="int64")
    h = pkg.layers.fc(x, size=16, act="relu")
    logits = pkg.layers.fc(h, size=4)
    loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(logits, y))
    return loss


def small_feed(batch=4):
    rng = np.random.RandomState(0)
    return {"x": rng.randn(batch, 16).astype("float32"),
            "y": rng.randint(0, 4, (batch, 1)).astype("int64")}


def find_op(block, op_type, nth=0):
    return [i for i, op in enumerate(block.ops) if op.type == op_type][nth]


def plant(pkg, fault):
    """Build the small net in `pkg` with one fault planted; returns the
    verify_program kwargs that expose it."""
    pkg.reset_default_programs()
    loss = small_net(pkg)
    main = pkg.default_main_program()
    block = main.global_block()
    kw = dict(feed=["x", "y"], fetch_list=[loss])
    if fault == "undefined_read":
        block.ops[find_op(block, "relu")].inputs["X"] = ["never_produced"]
    elif fault == "shape_mismatch":
        block.create_parameter("bad_w", [8, 4])
        block.ops[find_op(block, "mul", nth=1)].inputs["Y"] = ["bad_w"]
    elif fault == "dead_op":
        pkg.layers.scale(block.var("x"), scale=3.0)
    elif fault == "donated_fetch":
        kw.update(fetch_list=["x", loss], donate_feeds=True)
    elif fault == "missing_fetch":
        kw.update(fetch_list=[loss, "no_such_var"])
    return main, kw


FAULTS = {"undefined_read": ("error", "dataflow"),
          "shape_mismatch": ("error", "shape_inference"),
          "dead_op": ("warn", "dataflow"),
          "donated_fetch": ("error", "hazards"),
          "missing_fetch": ("error", "dataflow")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_gives_jax_findings(fault):
    got = {}
    for name, (pkg, an, _, _) in PKGS.items():
        main, kw = plant(pkg, fault)
        got[name] = an.verify_program(main, **kw)
    assert keys(got["port"]) == keys(got["jax"])
    severity, pass_name = FAULTS[fault]
    hits = got["port"].by_code(fault)
    assert hits and all(f.severity == severity and f.pass_name == pass_name
                        for f in hits)
    if fault == "undefined_read":
        (f,) = hits
        assert f.var_names == ("never_produced",) and f.op_type == "relu"
        assert "no producer" in f.message
        # the op was appended from this file: its layer call site rides
        assert f.callsite and "test_torch_analysis.py" in f.callsite
    elif fault == "shape_mismatch":
        f = hits[0]
        assert "contraction mismatch" in f.message and "[8, 4]" in f.message
        assert "bad_w" in f.var_names


def test_clean_small_net_and_records_match_jax_field_by_field():
    res = {}
    for name, (pkg, an, _, _) in PKGS.items():
        main, kw = plant(pkg, "missing_fetch")
        res[name] = an.verify_program(main, **kw)
    (jf,), (tf,) = (r.by_code("missing_fetch") for r in res.values())
    assert tf.to_dict() == jf.to_dict()
    assert tf.to_dict()["schema"] == tan.SCHEMA == "paddle_tpu.analysis.v1"
    assert res["port"].to_dict() == res["jax"].to_dict()
    ptt.reset_default_programs()
    loss = small_net(ptt)
    clean = tan.verify_program(ptt.default_main_program(),
                               feed=["x", "y"], fetch_list=[loss])
    assert clean.findings == [] and "shape_inference" in clean.passes_run


def test_lowp_accum_hazard_matches_jax():
    got = {}
    for name, (pkg, an, _, _) in PKGS.items():
        pkg.reset_default_programs()
        x = pkg.layers.data("x", [8, 8], dtype="bfloat16")
        block = pkg.default_main_program().global_block()
        block.create_parameter("w16", [8, 8], dtype="bfloat16")
        out = pkg.layers.mean(pkg.layers.matmul(x, block.var("w16")))
        got[name] = an.verify_program(pkg.default_main_program(),
                                      feed=["x"], fetch_list=[out])
    assert keys(got["port"]) == keys(got["jax"])
    assert {f.op_type for f in got["port"].by_code("lowp_accum")} == {
        "matmul", "mean"}
    ptt.flags.set_flag("amp_bf16", True)
    try:
        amp = tan.verify_program(ptt.default_main_program(), feed=["x"],
                                 fetch_list=[out])
    finally:
        ptt.flags.set_flag("amp_bf16", False)
    assert not amp.by_code("lowp_accum")


def test_findings_metric_counts_and_reset_zeroes_it():
    from paddle_tpu_torch.analysis.findings import _m_findings
    main, kw = plant(ptt, "missing_fetch")
    before = _m_findings.labels(**{"pass": "dataflow",
                                   "severity": "error"}).value
    res = tan.verify_program(main, **kw)
    after = _m_findings.labels(**{"pass": "dataflow",
                                  "severity": "error"}).value
    assert after == before + len(res.errors) >= before + 1
    tan.reset()
    assert _m_findings.total() == 0


def test_rule_registry_reset_drops_a_test_rule():
    from paddle_tpu_torch.framework import registry
    assert registry.get_shape_infer("mul") is trules._infer_mul
    assert registry.get_op_def("mul") is not None

    @registry.register_shape_infer("relu")
    def _rule(op, ins, attrs):
        return None
    assert registry.get_shape_infer("relu") is _rule
    tan.reset()
    assert registry.get_shape_infer("relu") is None
    assert registry.get_shape_infer("mul") is trules._infer_mul


# =====================================================================
# the flagship programs: the same findings, the same inferred vars
# =====================================================================

def tiny_cfg(mod):
    return mod.TransformerConfig(src_vocab_size=256, max_length=T,
                                 n_layer=2, n_head=4, d_model=64,
                                 d_inner=128, dropout=0.0)


def flagship(name, variant):
    """(main, startup, feed names, fetch list) of one flagship program."""
    pkg, _, tr, fb = PKGS[name]
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        if variant in ("unfused", "dropout"):
            cfg = tiny_cfg(tr)
            cfg.dropout = 0.1 if variant == "dropout" else 0.0
            feeds, loss, _ = tr.build_lm_net(cfg, T, fused_attention=False)
        elif variant == "is_test":
            feeds, _, logits = tr.build_lm_net(tiny_cfg(tr), T,
                                               is_test=True)
            names = [v.name for v in feeds]
            return (main.prune(names, [logits.name]), startup, names,
                    [logits.name])
        else:
            feeds, loss, _ = tr.build_lm_net(tiny_cfg(tr), T,
                                             fused_head=True)
        if variant == "fuse_block":
            pkg.flags.set_flag("fuse_block", True)
            try:
                assert fb.maybe_fuse(main) == 2
            finally:
                pkg.flags.set_flag("fuse_block", False)
        if variant == "clip_l2":
            pkg.clip.set_gradient_clip(
                pkg.clip.GradientClipByGlobalNorm(1.0))
        reg = (pkg.regularizer.L2Decay(1e-4) if variant == "clip_l2"
               else None)
        pkg.optimizer.Adam(1e-3, regularization=reg).minimize(
            loss, accumulate_steps=2 if variant == "accumulate" else 1)
    return main, startup, [v.name for v in feeds], [loss.name]


VARIANTS = ("unfused", "fused", "fuse_block", "is_test", "accumulate",
            "clip_l2")


def _kind(dtype):
    """int vars compare by kind: int32 on JAX's 32-bit plane is int64 in
    the port (a divergence by design)."""
    return "int" if dtype and dtype.startswith("int") else dtype


@pytest.mark.parametrize("variant", VARIANTS)
def test_flagship_program_verifies_as_in_jax(variant):
    res, envs = {}, {}
    for name, (pkg, an, _, _) in PKGS.items():
        main, startup, feeds, fetches = flagship(name, variant)
        res[name] = (an.verify_program(main, feed=feeds,
                                       fetch_list=fetches),
                     an.verify_program(startup))
        envs[name] = (JaxSI if name == "jax" else PortSI)().run(
            main, JaxResult() if name == "jax" else PortResult())
    for j, t in zip(res["jax"], res["port"]):
        assert keys(t) == keys(j)
        assert t.errors == [], t.report()
    # the accumulating program double-writes its counter and accumulators
    # (warn), as the JAX package's does; every other program is clean
    assert bool(res["port"][0].findings) == (variant == "accumulate")
    assert res["port"][1].findings == []
    je, te = envs["jax"], envs["port"]
    assert sorted(te) == sorted(je) and len(te) > 60
    int_gap = []
    for n, (shape, dtype) in je.items():
        assert te[n][0] == shape, n
        assert _kind(te[n][1]) == _kind(dtype), n
        if te[n][1] != dtype:
            int_gap.append((n, dtype, te[n][1]))
    assert all(j == "int32" and t == "int64" for _, j, t in int_gap)
    assert len(int_gap) <= 1


@pytest.mark.parametrize("variant", ["fused", "fuse_block", "clip_l2",
                                     "accumulate", "dropout"])
def test_flagship_program_verifies_strictly_with_no_unknown_op(variant):
    """Strict mode (the post-condition's): every op's meta evaluation
    runs on the fed shapes (no ``shape_infer_failed``; dropout draws
    nothing on meta), and no op is left with an unknown shape: autodiff
    goes through its rule."""
    main, _, feeds, fetches = flagship("port", variant)
    res = tan.verify_program(main, feed=feeds, fetch_list=fetches,
                             strict_shapes=True,
                             feed_shapes={n: (3, T) for n in feeds})
    assert res.errors == [], res.report()
    assert {f.code for f in res.findings} <= {"double_write"}
    assert res.unknown_shape_ops == []
    if variant == "dropout":
        assert "dropout" in {op.type for op in main.global_block().ops}


def test_verification_runs_with_amp_off_and_leaves_the_flag():
    main, _, feeds, fetches = flagship("port", "fused")
    ptt.flags.set_flag("amp_bf16", True)
    try:
        res = tan.verify_program(main, feed=feeds, fetch_list=fetches)
        assert ptt.flags.get_flag("amp_bf16") is True
    finally:
        ptt.flags.set_flag("amp_bf16", False)
    assert res.findings == [], res.report()


# =====================================================================
# the Executor's gate
# =====================================================================

@pytest.fixture
def op_runs(monkeypatch):
    """Counts the op loops the Executor enters (every op of a run goes
    through run_ops_in_env)."""
    calls = []
    real = texecutor.run_ops_in_env

    def spy(ctx, env, ops):
        calls.append(len(ops))
        return real(ctx, env, ops)
    monkeypatch.setattr(texecutor, "run_ops_in_env", spy)
    return calls


def severed(pkg):
    pkg.reset_default_programs()
    loss = small_net(pkg)
    block = pkg.default_main_program().global_block()
    block.ops[find_op(block, "relu")].inputs["X"] = ["never_produced"]
    return loss


def test_error_mode_rejects_run_before_any_op_runs(op_runs):
    jloss = severed(pt)
    pt.flags.set_flag("verify_program", "error")
    with pytest.raises(jan.ProgramVerificationError) as jei:
        pt.Executor(pt.CPUPlace()).run(pt.default_main_program(),
                                       feed=small_feed(),
                                       fetch_list=[jloss])
    loss = severed(ptt)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace(), scope=scope)
    exe.run(ptt.default_startup_program())
    state = {n: scope.find_var(n) for n in scope._vars}
    n0 = len(op_runs)
    ptt.flags.set_flag("verify_program", "error")
    for _ in range(2):        # the memo's verdict raises again
        with pytest.raises(tan.ProgramVerificationError) as ei:
            exe.run(ptt.default_main_program(), feed=small_feed(),
                    fetch_list=[loss])
        assert len(op_runs) == n0
    assert "undefined_read" in str(ei.value)
    assert keys(ei.value.result) == keys(jei.value.result)
    assert {n: scope.find_var(n) for n in scope._vars} == state


def test_error_mode_rejects_run_steps_before_any_op_runs(op_runs):
    loss = severed(ptt)
    exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    exe.run(ptt.default_startup_program())
    ptt.flags.set_flag("verify_program", "error")
    n0 = len(op_runs)
    feed = {k: np.stack([v, v]) for k, v in small_feed().items()}
    with pytest.raises(tan.ProgramVerificationError):
        exe.run_steps(ptt.default_main_program(), feed=feed,
                      fetch_list=[loss], steps=2,
                      per_step_feeds=("x", "y"))
    assert len(op_runs) == n0


def test_error_mode_catches_a_shape_mismatch_statically(op_runs):
    main, kw = plant(ptt, "shape_mismatch")
    exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    exe.run(ptt.default_startup_program())
    ptt.flags.set_flag("verify_program", "error")
    n0 = len(op_runs)
    with pytest.raises(tan.ProgramVerificationError,
                       match="contraction mismatch"):
        exe.run(main, feed=small_feed(), fetch_list=kw["fetch_list"])
    assert len(op_runs) == n0


def test_error_mode_accepts_valid_run_steps_slabs():
    """The slabs' leading [steps] dim is dropped for shape inference: the
    valid program is not a shape mismatch."""
    loss = small_net(ptt)
    ptt.optimizer.Adam(0.01).minimize(loss)
    exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    exe.run(ptt.default_startup_program())
    ptt.flags.set_flag("verify_program", "error")
    slabs = {k: np.stack([v, v, v]) for k, v in small_feed().items()}
    out, = exe.run_steps(ptt.default_main_program(), feed=slabs,
                         fetch_list=[loss], steps=3,
                         per_step_feeds=("x", "y"))
    assert out.shape == (3,) and np.isfinite(out).all()


def test_warn_mode_warns_once_and_runs():
    assert ptt.flags.get_flag("verify_program") == "warn"
    loss = severed(ptt)
    exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for _ in range(2):
            with pytest.raises(Exception, match="not materialised"):
                exe.run(ptt.default_main_program(), feed=small_feed(),
                        fetch_list=[loss])
    msgs = [str(x.message) for x in w
            if "program verification" in str(x.message)]
    assert len(msgs) == 1 and "undefined_read" in msgs[0]
    assert all(x.filename == __file__ for x in w
               if "program verification" in str(x.message))


def test_clean_program_emits_no_warning():
    loss = small_net(ptt)
    ptt.optimizer.Adam(0.01).minimize(loss)
    exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        exe.run(ptt.default_startup_program())
        out, = exe.run(ptt.default_main_program(), feed=small_feed(),
                       fetch_list=[loss])
    assert np.isfinite(out).all()


def _three_steps(mode):
    ptt.reset_default_programs()
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = 3
    with ptt.program_guard(main, startup):
        loss = small_net(ptt)
        ptt.optimizer.Adam(0.01).minimize(loss)
    ptt.flags.set_flag("verify_program", mode)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace(), scope=scope)
    exe.run(startup)
    outs = [exe.run(main, feed=small_feed(), fetch_list=[loss])[0]
            for _ in range(3)]
    state = {n: scope.find_var(n).numpy().copy() for n in scope._vars}
    return outs, state, exe


@pytest.mark.parametrize("mode", ["warn", "error"])
def test_off_gives_the_same_outputs_bit_for_bit(mode):
    outs_off, state_off, exe_off = _three_steps("off")
    outs, state, exe = _three_steps(mode)
    assert exe_off._verified == {}
    assert len(exe._verified) == 2          # startup, then the step
    for a, b in zip(outs_off, outs):
        np.testing.assert_array_equal(a, b)
    assert sorted(state) == sorted(state_off)
    for n in state:
        np.testing.assert_array_equal(state[n], state_off[n])


@pytest.mark.parametrize("mode,entry", [("error", "verify_program"),
                                        ("warn", "quick_lints")])
def test_the_verdict_is_kept_per_key(monkeypatch, mode, entry):
    calls = []
    real = getattr(tan, entry)

    def counted(*a, **kw):
        calls.append(kw.get("feed_shapes"))
        return real(*a, **kw)
    monkeypatch.setattr(tan, entry, counted)
    loss = small_net(ptt)
    main = ptt.default_main_program()
    exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    exe.run(ptt.default_startup_program())
    ptt.flags.set_flag("verify_program", mode)
    calls.clear()
    for _ in range(3):
        exe.run(main, feed=small_feed(), fetch_list=[loss])
    assert len(calls) == 1
    exe.run(main, feed=small_feed(batch=5), fetch_list=[loss])   # shapes
    exe.run(main, feed=small_feed(), fetch_list=[loss, "x"])      # fetches
    exe.run(main, feed=small_feed(), fetch_list=[loss],
            donate_feeds=True)                                     # donate
    assert len(calls) == 4
    # run_steps takes the key of its steps' runs: no new verification
    slabs = {k: np.stack([v, v]) for k, v in small_feed().items()}
    exe.run_steps(main, feed=slabs, fetch_list=[loss], steps=2,
                  per_step_feeds=("x", "y"))
    assert len(calls) == 4
    # a program changed through the Block API is verified anew
    v0 = main._version
    ptt.layers.scale(main.global_block().var("x"), scale=2.0)
    assert main._version > v0
    exe.run(main, feed=small_feed(), fetch_list=[loss])
    assert len(calls) == 5
    if mode == "error":
        assert calls[0] == {"x": (4, 16), "y": (4, 1)}


# =====================================================================
# the fuse_block post-condition
# =====================================================================

def _sabotaged(mod, monkeypatch):
    orig = mod.FuseBlockTranspiler._try_match

    def sabotage(self, block, ops, i, consumers):
        repl, width = orig(self, block, ops, i, consumers)
        if repl is not None:
            repl.inputs["X"] = [repl.inputs["X"][0] + ".GONE"]
        return repl, width
    monkeypatch.setattr(mod.FuseBlockTranspiler, "_try_match", sabotage)


def test_fuse_block_postcondition_names_the_transpiler(monkeypatch):
    for name, (pkg, an, tr, fb) in PKGS.items():
        pkg.reset_default_programs()
        tr.build_lm_net(tiny_cfg(tr), T, fused_head=True)
        _sabotaged(fb, monkeypatch)
        with pytest.raises(an.ProgramVerificationError,
                           match="FuseBlockTranspiler") as ei:
            fb.FuseBlockTranspiler().transpile(pkg.default_main_program())
        assert ei.value.result.by_code("undefined_read"), name
    # the escape hatch: off runs no post-condition
    ptt.reset_default_programs()
    ttr.build_lm_net(tiny_cfg(ttr), T, fused_head=True)
    ptt.flags.set_flag("verify_program", "off")
    assert tfb.FuseBlockTranspiler().transpile(
        ptt.default_main_program()) == 2
    assert tan.maybe_check_transpiled(ptt.default_main_program(),
                                      "FuseBlockTranspiler") is None


def test_fuse_block_postcondition_runs_on_a_clean_rewrite(monkeypatch):
    calls = []
    real = tan.maybe_check_transpiled

    def spy(program, name):
        calls.append(name)
        return real(program, name)
    monkeypatch.setattr(tan, "maybe_check_transpiled", spy)
    ttr.build_lm_net(tiny_cfg(ttr), T, fused_head=True)
    assert tfb.FuseBlockTranspiler().transpile(
        ptt.default_main_program()) == 2
    assert calls == ["FuseBlockTranspiler"]
    # nothing fused, nothing to check
    assert tfb.FuseBlockTranspiler().transpile(
        ptt.default_main_program()) == 0
    assert calls == ["FuseBlockTranspiler"]


# =====================================================================
# the infer rules against JAX's
# =====================================================================

class _Op:
    inputs = {"X": ["a"], "Y": ["b"]}


def _rule_outcome(rule, ins, attrs):
    try:
        return rule(_Op(), ins, attrs)
    except Exception as e:          # both raise their InferError
        return type(e).__name__, str(e)


_SHAPES = [(3, 4, 5), (3, 5, 7), (4, 5), (5, 7), (7, 5), (6, 7), (-1, 5),
           (1, 4, 8), (5, 8, 2), (8, 2), (5, 4, 8), (2, 1, 5, 4), (3, 4, 7)]


@pytest.mark.parametrize("tx", [False, True])
@pytest.mark.parametrize("ty", [False, True])
def test_matmul_rule_agrees_with_jax(tx, ty):
    attrs = {"transpose_X": tx, "transpose_Y": ty}
    n = 0
    for xs in _SHAPES:
        for ys in _SHAPES:
            ins = {"X": [(xs, "float32")], "Y": [(ys, "float32")]}
            want = _rule_outcome(jrules._infer_matmul, ins, attrs)
            got = _rule_outcome(trules._infer_matmul, ins, attrs)
            assert got == want, (xs, ys, attrs)
            n += not isinstance(want, tuple)
    assert n > 10


@pytest.mark.parametrize("nc", [1, 2])
def test_mul_rule_agrees_with_jax(nc):
    for xs in [(4, 16), (-1, 16), (2, 3, 16), (-1, 8, 16), (4, 8), None]:
        for ws in [(16, 4), (8, 4), (48, 4), (16, 4, 1), None]:
            ins = {"X": [(xs, "float32")], "Y": [(ws, "float32")]}
            attrs = {"x_num_col_dims": nc}
            assert (_rule_outcome(trules._infer_mul, ins, attrs)
                    == _rule_outcome(jrules._infer_mul, ins, attrs)), (
                xs, ws, nc)


# =====================================================================
# the lint CLI
# =====================================================================

def test_lint_cli_exit_codes(capsys):
    assert lint_cli.main([]) == 0
    out = capsys.readouterr().out
    models = ["lenet", "alexnet", "vgg", "googlenet", "resnet",
              "se_resnext", "transformer", "transformer_lm", "bert",
              "deepfm", "deepfm_sparse", "nmt", "stacked_lstm",
              "book_fit_a_line", "book_word2vec", "book_recommender",
              "book_rnn_enc_dec", "book_db_lstm", "mt_beam_decode"]
    for model in models:
        assert f"[lint] {model}: ok" in out
    assert "0 errors" in out.splitlines()[-1]
    assert lint_cli.main(["--list"]) == 0
    assert capsys.readouterr().out.split() == models
    assert lint_cli.main(["--models", "nope"]) == 2
    assert lint_cli.main(["--self-test"]) == 1


def test_lint_cli_runs_as_a_module_without_warning():
    res = subprocess.run(
        [sys.executable, "-W", "error", "-m",
         "paddle_tpu_torch.analysis.lint", "-v"],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "19 models: 0 errors" in res.stdout


def _lint_view(pkg, an, builders, model):
    """(errors, warnings, sorted unknown-shape op types) of `model` as a
    lint CLI builds and verifies it, main and startup programs."""
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        feeds, fetches = builders[model]()
    res = an.verify_program(main, feed=[v.name for v in feeds],
                            fetch_list=fetches)
    sres = an.verify_program(startup)
    return (len(res.errors) + len(sres.errors),
            len(res.warnings) + len(sres.warnings),
            sorted(set(res.unknown_shape_ops)))


@pytest.mark.parametrize("model", list(jlint_cli.model_builders()))
def test_lint_model_matches_the_jax_cli(model):
    """Every model of the JAX CLI, built by the port's CLI: clean, with
    JAX's unknown-shape ops (the decode: beam_search_decode, slice,
    squeeze and static_rnn_scan; the MT train program static_rnn_scan;
    every other model none)."""
    theirs = _lint_view(pt, jan, jlint_cli.model_builders(), model)
    mine = _lint_view(ptt, tan, lint_cli.model_builders(), model)
    assert mine == theirs
    assert mine[:2] == (0, 0)
    if model in ("nmt", "mt_beam_decode"):
        assert "static_rnn_scan" in mine[2]
