"""InferenceTranspiler (the conv + batch_norm fold), the transpiler
package's no-op API, and frozen int8 / fp8 models across the two
packages' save formats (transpiler/inference_transpiler.py, io.py,
inference/predictor.py).

- The fold from the same state in both packages: the same program (conv
  kept, batch_norm replaced by an assign aliasing its output), the folded
  filter and bias bit-equal to JAX's (the same f32 math in the same
  order), the folded program's output within FOLD_RTOL of the unfolded
  one's (a product's rounding moves).
- A model JAX froze and saved serves through the port's Predictor with
  the outputs of JAX's executor in its eager per-op mode: int8
  bit-equal, fp8 within FP8_RTOL (the same exact products summed in f32
  in another order).  JAX cannot load its own fp8 file (ROADMAP C): the
  test shows that too.
- The port's own save of a frozen model round-trips bit for bit.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.core import flags as jflags
from paddle_tpu.inference import AnalysisConfig as JaxConfig
from paddle_tpu.inference import create_predictor as jax_predictor
from paddle_tpu.transpiler import InferenceTranspiler as JIT
from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
from paddle_tpu_torch.transpiler import (InferenceTranspiler,
                                         memory_optimize, release_memory)
from test_torch_quantize import _bits, _feed, _rel, _train_jax
from test_torch_train import _op_view, _var_view

FOLD_RTOL = 1e-5
FP8_RTOL = 1e-6


@pytest.fixture(autouse=True)
def fresh_programs():
    ptt.reset_default_programs()
    pt.reset_default_programs()
    yield
    ptt.reset_default_programs()


def _conv_bn(pkg, bias, reuse=False):
    """conv2d -> batch_norm(is_test); with `bias` the conv op takes its
    fused Bias slot (the fold's other branch: layers.conv2d adds a bias
    as an elementwise_add op, which the fold does not look through)."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 4
    with pkg.program_guard(main, startup):
        img = pkg.layers.data("img", [3, 10, 10], dtype="float32")
        conv = pkg.layers.conv2d(img, 6, 3, padding=1, bias_attr=False)
        bn = pkg.layers.batch_norm(conv, is_test=True)
        out = pkg.layers.elementwise_add(bn, conv) if reuse else bn
    if bias:
        block = main.global_block()
        block.create_parameter("conv_b", shape=[6], dtype="float32")
        [op for op in block.ops
         if op.type == "conv2d"][0].inputs["Bias"] = ["conv_b"]
    return main, startup, out


def _bn_state(scope, prog, rng):
    """Random running stats and affine params for every batch_norm."""
    arrays = {}
    for op in prog.global_block().ops:
        if op.type == "batch_norm":
            for slot, make in (("Scale", lambda n: rng.rand(n) + 0.5),
                               ("Bias", lambda n: rng.randn(n)),
                               ("Mean", lambda n: rng.randn(n)),
                               ("Variance", lambda n: rng.rand(n) + 0.1)):
                name = op.inputs[slot][0]
                n = np.asarray(scope.find_var(name)).shape[0]
                arrays[name] = make(n).astype(np.float32)
    return arrays


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
def test_conv_bn_fold_matches_jax(bias):
    jmain, jstart, jout = _conv_bn(pt, bias)
    jexe = pt.Executor(pt.CPUPlace(), scope=pt.Scope())
    jexe.run(jstart)
    rng = np.random.RandomState(1)
    for n, a in _bn_state(jexe.scope, jmain, rng).items():
        jexe.scope.set_var(n, jnp.asarray(a))
    if bias:
        jexe.scope.set_var("conv_b", jnp.asarray(
            rng.randn(6).astype(np.float32)))
    state = {v.name: np.asarray(jexe.scope.find_var(v.name))
             for v in jmain.list_vars() if v.persistable}
    tmain, _, tout = _conv_bn(ptt, bias)
    tscope = ptt.Scope()
    ptt.io.params_from_numpy(tscope, state, ptt.CPUPlace())
    texe = ptt.Executor(ptt.CPUPlace(), scope=tscope)
    feed = {"img": rng.rand(2, 3, 10, 10).astype(np.float32)}
    before, = texe.run(tmain, feed=feed, fetch_list=[tout])
    jtest, ttest = jmain.clone(for_test=True), tmain.clone(for_test=True)
    JIT().transpile(jtest, scope=jexe.scope)
    InferenceTranspiler().transpile(ttest, scope=tscope)
    assert _op_view(ttest) == _op_view(jtest)
    assert _var_view(ttest) == _var_view(jtest)
    types = [op.type for op in ttest.global_block().ops]
    assert "batch_norm" not in types and "assign" in types
    conv = [op for op in ttest.global_block().ops if op.type == "conv2d"][0]
    for n in conv.inputs["Filter"] + conv.inputs["Bias"]:
        np.testing.assert_array_equal(tscope.find_var(n).numpy(),
                                      np.asarray(jexe.scope.find_var(n)),
                                      err_msg=n)
    after, = texe.run(ttest, feed=feed, fetch_list=[tout])
    assert _rel(after, before) <= FOLD_RTOL
    # the conv's own output is fetchable and holds the folded value
    via_conv, = texe.run(ttest, feed=feed,
                         fetch_list=[conv.outputs["Output"][0]])
    np.testing.assert_array_equal(via_conv, after)
    want, = jexe.run(jtest, feed=feed, fetch_list=[jout])
    assert _rel(after, np.asarray(want)) <= FOLD_RTOL


def test_conv_bn_fold_skipped_where_the_conv_output_is_read_elsewhere():
    main, startup, _ = _conv_bn(ptt, bias=False, reuse=True)
    exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    exe.run(startup)
    test = main.clone(for_test=True)
    w_name = [op for op in test.global_block().ops
              if op.type == "conv2d"][0].inputs["Filter"][0]
    w = exe.scope.find_var(w_name).clone()
    InferenceTranspiler().transpile(test, scope=exe.scope)
    assert any(op.type == "batch_norm" for op in test.global_block().ops)
    assert torch.equal(exe.scope.find_var(w_name), w)


def test_memory_optimize_and_release_memory_return_the_program():
    p = ptt.Program()
    assert memory_optimize(p) is p
    assert memory_optimize(p, skip_opt_set={"x"}, print_log=True) is p
    assert release_memory(p) is p


def _jax_frozen(qd, conv, tmp_path):
    """A QAT net trained and frozen to `qd` in JAX, saved with
    save_inference_model: (dir, feed, JAX's eager outputs)."""
    j = _train_jax(conv, "moving_average_abs_max", 4)
    frozen = j["qt"].freeze_program(j["test"], scope=j["exe"].scope,
                                    quantize_dtype=qd)
    feed = _feed(conv, 7)
    feed.pop("y")
    d = str(tmp_path / f"jax_{qd}")
    pt.io.save_inference_model(d, list(feed), [j["pred"]], j["exe"],
                               main_program=frozen)
    jflags.set_flag("check_nan_inf_per_op", True)
    try:
        pruned = frozen.clone(for_test=True).prune(list(feed),
                                                   [j["pred"].name])
        want, = j["exe"].run(pruned, feed=feed, fetch_list=[j["pred"].name])
    finally:
        jflags.set_flag("check_nan_inf_per_op", False)
    return d, feed, np.asarray(want)


@pytest.mark.parametrize("conv", [False, True], ids=["fc", "conv"])
@pytest.mark.parametrize("qd", ["int8", "e4m3", "e5m2"])
def test_jax_saved_frozen_models_serve_in_the_port(qd, conv, tmp_path):
    d, feed, want = _jax_frozen(qd, conv, tmp_path)
    with open(os.path.join(d, "__params__.npz.dtypes")) as f:
        names = set(json.load(f).values())
    assert ({"int8": "int8", "e4m3": "float8_e4m3fn",
             "e5m2": "float8_e5m2"}[qd]) in names
    p = create_predictor(AnalysisConfig(d, use_gpu=False))
    kinds = {op.type for op in p.program.global_block().ops}
    assert "quantized_matmul" in kinds
    assert ("quantized_conv2d" in kinds) == conv
    got, = p.run(feed)
    if qd == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        assert _rel(got, want) <= FP8_RTOL
        # the reference cannot read back its own fp8 file (ROADMAP C)
        with pytest.raises((TypeError, ValueError)):
            jax_predictor(JaxConfig(model_dir=d, use_tpu=False))


@pytest.mark.parametrize("qd", ["int8", "e4m3", "e5m2"])
def test_port_saved_frozen_models_round_trip(qd, tmp_path):
    d, feed, _ = _jax_frozen(qd, False, tmp_path)
    first = create_predictor(AnalysisConfig(d, use_gpu=False))
    out, = first.run(feed)
    d2 = str(tmp_path / "port")
    exe = ptt.Executor(ptt.CPUPlace(), scope=ptt.Scope())
    prog, feeds, fetches = ptt.io.load_inference_model(d, exe)
    ptt.io.save_inference_model(d2, feeds, fetches, exe, main_program=prog)
    with open(os.path.join(d2, "__params__.npz.dtypes")) as f:
        dtypes = json.load(f)
    with np.load(os.path.join(d2, "__params__.npz")) as data:
        for n, dt in dtypes.items():
            if dt.startswith("float8"):
                assert data[n].dtype == np.uint8
                np.testing.assert_array_equal(
                    data[n], _bits(exe.scope.find_var(n)))
    again, = create_predictor(AnalysisConfig(d2, use_gpu=False)).run(feed)
    np.testing.assert_array_equal(again, out)


def test_params_from_numpy_takes_ml_dtypes_fp8():
    rng = np.random.RandomState(0)
    x = rng.randn(5, 7).astype(np.float32) * 10
    arrays = {"a": np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)),
              "b": np.asarray(jnp.asarray(x).astype(jnp.float8_e5m2)),
              "c": np.asarray(jnp.asarray(x).astype(jnp.bfloat16))}
    scope = ptt.Scope()
    ptt.io.params_from_numpy(scope, arrays, ptt.CPUPlace())
    assert scope.find_var("a").dtype == torch.float8_e4m3fn
    assert scope.find_var("b").dtype == torch.float8_e5m2
    assert scope.find_var("c").dtype == torch.bfloat16
    for n in "ab":
        np.testing.assert_array_equal(_bits(scope.find_var(n)),
                                      _bits(arrays[n]))
        np.testing.assert_array_equal(
            ptt.framework.executor.to_numpy(scope.find_var(n)),
            arrays[n].astype(np.float32))
