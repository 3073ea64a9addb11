"""The unfused LM build of the port (the serving engine's weights and its
full-forward oracle) against the JAX package's.

A tiny unfused LM (V 97, L 2, H 2, D 16, F 32, T 24) is built and
initialised in paddle_tpu on the CPU and saved with save_inference_model.
The port's Predictor on that dir must return the JAX Predictor's logits
(rtol 1e-4, atol 1e-4: the same f32 math, summed in another order); the
port's own unfused build must serialize like the JAX build, and
lm_program_spec must map both builds' parameters to the same roles.
"""
import json

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.inference import predictor as jpred
from paddle_tpu.models import transformer as jtr
from paddle_tpu_torch.inference import AnalysisConfig, create_predictor
from paddle_tpu_torch.models import transformer as ttr

TOL = dict(rtol=1e-4, atol=1e-4)
T = 24


def tiny_cfg(mod):
    return mod.TransformerConfig(src_vocab_size=97, tgt_vocab_size=97,
                                 max_length=32, n_layer=2, n_head=2,
                                 d_model=16, d_inner=32, dropout=0.0)


def build(pkg, mod, fused_attention=False, fused_head=False):
    pkg.reset_default_programs()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.program_guard(main, startup):
        _, _, logits = mod.build_lm_net(tiny_cfg(mod), T, is_test=True,
                                        fused_attention=fused_attention,
                                        fused_head=fused_head)
    return main, startup, logits


def tokens(batch=3, seed=0):
    return np.random.RandomState(seed).randint(
        1, 97, (batch, T)).astype("int64")


@pytest.fixture(autouse=True)
def fresh_port_programs():
    ptt.reset_default_programs()
    yield
    ptt.reset_default_programs()


@pytest.fixture(scope="module")
def jax_unfused(tmp_path_factory):
    main, startup, logits = build(pt, jtr)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace(), scope=scope)
    exe.run(startup)
    d = str(tmp_path_factory.mktemp("unfused_lm"))
    pt.io.save_inference_model(d, ["tokens"], [logits], exe,
                               main_program=main)
    p = jpred.create_predictor(jpred.AnalysisConfig(d, use_tpu=False))
    want, = p.run({"tokens": tokens()})
    return dict(dir=d, main=main, startup=startup, logits=np.asarray(want))


def test_port_predictor_serves_the_jax_saved_unfused_lm(jax_unfused):
    p = create_predictor(AnalysisConfig(jax_unfused["dir"], use_gpu=False))
    ops = {op.type for op in p.program.global_block().ops}
    assert {"matmul", "softmax", "transpose", "split", "cast",
            "greater_than", "assign_value"} <= ops
    got, = p.run({"tokens": tokens()})
    assert got.shape == (3, T, 97)
    np.testing.assert_allclose(got, jax_unfused["logits"], **TOL)


def test_predictor_result_survives_the_next_run(jax_unfused):
    """The array a run returns is the caller's: a later run with other
    tokens leaves it as it was."""
    p = create_predictor(AnalysisConfig(jax_unfused["dir"], use_gpu=False))
    first, = p.run({"tokens": tokens()})
    kept = first.copy()
    second, = p.run({"tokens": tokens(seed=5)})
    assert not np.array_equal(second, kept)
    np.testing.assert_array_equal(first, kept)


def _op_view(prog):
    return [(op.type, op.inputs, op.outputs,
             json.loads(json.dumps(op.to_dict()["attrs"])))
            for op in prog.global_block().ops]


def _var_view(prog):
    return {v.name: (tuple(v.shape or ()), v.persistable,
                     type(v).__name__) for v in prog.list_vars()}


def test_port_unfused_build_serializes_like_jax_build(jax_unfused):
    main, startup, _ = build(ptt, ttr)
    for mine, theirs in ((main, jax_unfused["main"]),
                         (startup, jax_unfused["startup"])):
        assert _op_view(mine) == _op_view(theirs)
        assert _var_view(mine) == _var_view(theirs)
    assert ({p.name: (tuple(p.shape), p.dtype)
             for p in main.all_parameters()}
            == {p.name: (tuple(p.shape), p.dtype)
                for p in jax_unfused["main"].all_parameters()})
    # JAX computes int64 on its 32-bit plane; every float var agrees
    for v in jax_unfused["main"].list_vars():
        if v.dtype.startswith("float") or v.dtype == "bool":
            assert main.global_block().var(v.name).dtype == v.dtype


def test_lm_program_spec_maps_both_builds_alike(jax_unfused):
    main, _, _ = build(ptt, ttr)
    spec = ttr.lm_program_spec(main)
    assert spec == jtr.lm_program_spec(jax_unfused["main"])
    assert spec["n_layer"] == 2 and len(spec["layers"]) == 2
    params = {p.name for p in main.all_parameters()}
    roles = [spec["emb"], spec["w_head"], *spec["ln_f"]]
    for lay in spec["layers"]:
        roles += [*lay["ln1"], *lay["ln2"]] + [
            lay[k] for k in ("w_qkv", "w_o", "w_fc1", "b_fc1", "w_fc2",
                             "b_fc2")]
    assert set(roles) <= params and len(set(roles)) == len(roles)


@pytest.mark.parametrize("fused_head", [False, True])
def test_lm_program_spec_refuses_a_fused_build(fused_head):
    main, _, _ = build(ptt, ttr, fused_attention=True,
                       fused_head=fused_head)
    with pytest.raises(ValueError, match="unfused"):
        ttr.lm_program_spec(main)


def test_unfused_build_refuses_dropout():
    """Dropout is ported: the unfused build no longer refuses it and puts
    the JAX build's dropout ops where JAX puts them (the embedding, and a
    layer's attention probabilities, FFN hidden layer and both sublayer
    outputs), none at is_test; the refusal left is the fused attention
    build's, JAX's ValueError."""
    ptt.reset_default_programs()
    cfg = tiny_cfg(ttr)
    cfg.dropout = 0.1
    for is_test, n_drop in ((False, 1 + 4 * cfg.n_layer), (True, 0)):
        main = ptt.Program()
        with ptt.program_guard(main, ptt.Program()):
            ttr.build_lm_net(cfg, T, is_test=is_test, fused_attention=False)
        drops = [op for op in main.global_block().ops
                 if op.type == "dropout"]
        assert len(drops) == n_drop
        assert all(op.attrs["dropout_implementation"] == "upscale_in_train"
                   and op.attrs["dropout_prob"] == 0.1 for op in drops)
    with pytest.raises(ValueError, match="attention-prob dropout"):
        with ptt.program_guard(ptt.Program(), ptt.Program()):
            ttr.build_lm_net(cfg, T, is_test=False, fused_attention=True)
