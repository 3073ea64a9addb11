"""Each op lowering of the port against the JAX package's lowering of the
same op, on the same seeded numpy inputs and attrs.

The JAX side runs on the CPU with its Pallas kernels in interpret mode (a
LowerContext without a place picks interpret off-TPU), as its own tests do.
Tolerance: 1e-5 for elementwise math; 1e-4 relative for ops with matrix
products (another summation order); CONV (rtol 1e-4, atol 1e-5) for
convolutions and batch norm (sums over a window or a channel's N*H*W
entries, in another order); exact for max pooling, top_k and accuracy
(no arithmetic, or integer counts).  The gradient cases of the conv
plane (``test_conv_plane_grad_matches_jax``) hold torch autograd
against jax.vjp of the JAX lowering under one seeded cotangent at CONV.
DeepFM's ops and the sparse plane's (``CTR_CASES``, with gradients in
``test_ctr_op_grad_matches_jax`` and dtypes under FLAGS_amp_bf16 in
``test_ctr_ops_amp_dtypes_match_jax``) and the optimizer update ops
(``OPT_CASES``) join ``test_op_matches_jax``: elementwise math at EXACT,
the whole-tensor norms of ``lars_momentum`` and ``lamb`` at MATMUL, the
integer hash and the gathers SAME.  JAX hashes an id as its int32 feed
keeps it (the low 32 bits, wrapped), so ids above 2^31, above 2^32 and
below 0 go through both packages' int32 and int64 paths.  The conv
builds' ``lrn`` and ``concat`` and the recurrent family (``lstm``,
``gru``, ``lstm_unit``, ``gru_unit``; ``RNN_CONV_CASES``) join too, with
gradients of several outputs at once in
``test_rnn_conv_op_grad_matches_jax`` (readings up to 3.3e-7 of max |JAX|
against MATMUL's 1e-4) and bf16 inputs beside f32 weights in
``test_rnn_conv_ops_bf16_match_jax``.  The machine-translation and book
ops (``SEQ_CASES``) join too: ``static_rnn_scan`` runs a one-step
sub-block (both contexts given the program and the live env, as the
Executor gives them), ``beam_search`` on planted ties (lax.top_k's order:
the lower flat index first) and on finished beams, ``sequence_pool`` in
every pooltype over a ragged mask, the CRF pair with and without a mask
and on tied Viterbi scores; their gradients are in
``test_seq_op_grad_matches_jax``.  The rest of the conv family
(``CONV_EXTRA_CASES``: conv3d, the two transposes and the depthwise one,
pool3d, the index pools on planted ties, group and instance norm), the
comparison and logical ops under While and Switch, the binary ops of the
Variable operators and the schedules' two ops join too; their gradients
and AMP cases are in ``tests/test_torch_conv_extras.py``.  The
sequence, LoD-array, CTC, sampling, selected-rows and vision planes and
the host ops (``SEQ_PLANE_CASES``, part of ``SEQ_CASES``) join too, with
their indices wrapped, clamped and dropped, repeated ids, ties and kinks
planted; their gradients, meta evaluations and random ops are in
``tests/test_torch_sequence_ops.py``.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.framework.registry import LowerContext as JaxCtx
from paddle_tpu.framework.registry import get_op_def as jax_op
from paddle_tpu_torch.framework.registry import LowerContext as TorchCtx
from paddle_tpu_torch.framework.registry import get_op_def as torch_op
from paddle_tpu_torch.kernels.flash_attention import flash_attention_hdt
from paddle_tpu_torch.kernels.layer_norm import layer_norm

EXACT = dict(rtol=1e-5, atol=1e-5)
MATMUL = dict(rtol=1e-4, atol=1e-5)
CONV = dict(rtol=1e-4, atol=1e-5)
SAME = dict(rtol=0, atol=0)


def _scan_program(pkg):
    """A program whose block 1 is one tanh RNN step, h = tanh(x_t W + m),
    ending as StaticRNN's steps end, with ``assign h -> m``."""
    prog = pkg.Program()
    sub = prog.create_block()
    sub.append_op("mul", {"X": ["x_t"], "Y": ["W"]}, {"Out": ["a"]}, {})
    sub.append_op("elementwise_add", {"X": ["a"], "Y": ["m"]},
                  {"Out": ["s"]}, {"axis": -1})
    sub.append_op("tanh", {"X": ["s"]}, {"Out": ["h"]}, {})
    sub.append_op("assign", {"X": ["h"]}, {"Out": ["m"]}, {})
    prog.rollback()
    return prog


def _contexts(op, jins, tins):
    """The two lowering contexts; a static_rnn_scan's get the program of
    its sub-block and the live env holding the step's weight W (its ``W``
    slot, which the op itself does not read), as the Executor sets
    them."""
    jctx = JaxCtx(jax.random.PRNGKey(0))
    tctx = TorchCtx(0, torch.device("cpu"))
    if op == "static_rnn_scan":
        import paddle_tpu as pt
        import paddle_tpu_torch as ptt
        jctx.program, jctx.env = _scan_program(pt), {"W": jins["W"][0]}
        tctx.program, tctx.env = _scan_program(ptt), {"W": tins["W"][0]}
    return jctx, tctx


def _run_both(op, ins, attrs):
    jins = {k: [jnp.asarray(a.astype(np.int32) if a.dtype == np.int64
                            else a) for a in v] for k, v in ins.items()}
    # np.array keeps a 0-d input 0-d (ascontiguousarray makes it 1-d)
    tins = {k: [torch.from_numpy(np.array(a, order="C")) for a in v]
            for k, v in ins.items()}
    jctx, tctx = _contexts(op, jins, tins)
    jouts = jax_op(op).lower(jctx, jins, attrs)
    touts = torch_op(op).lower(tctx, tins, attrs)
    return jouts, touts


def _compare(jouts, touts, slots, tol):
    for slot in slots:
        assert len(jouts[slot]) == len(touts[slot]), slot
        for j, t in zip(jouts[slot], touts[slot]):
            j = np.asarray(j)
            t = t.numpy()
            assert j.shape == t.shape, (slot, j.shape, t.shape)
            if j.dtype.kind in "bu" or t.dtype.kind in "bu":
                # bool (a comparison) and uint8 (a dropout Mask): exact
                assert t.dtype == j.dtype, (slot, t.dtype, j.dtype)
                np.testing.assert_array_equal(t, j, err_msg=slot)
                continue
            np.testing.assert_allclose(t, j, err_msg=slot, **tol)


def _rand(rng, *shape):
    return rng.randn(*shape).astype("float32")


def _softmax_rows(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype("float32")


# (op, input builder, attrs, compared slots, tolerance)
CASES = {
    "add_same_rank_broadcast": (
        "elementwise_add", lambda r: {"X": [_rand(r, 2, 3, 4)],
                                      "Y": [_rand(r, 1, 3, 4)]},
        {"axis": -1}, ["Out"], EXACT),
    "add_axis1_bias": (
        "elementwise_add", lambda r: {"X": [_rand(r, 2, 3, 4)],
                                      "Y": [_rand(r, 3)]},
        {"axis": 1}, ["Out"], EXACT),
    "add_axis1_2d": (
        "elementwise_add", lambda r: {"X": [_rand(r, 2, 3, 4)],
                                      "Y": [_rand(r, 3, 4)]},
        {"axis": 1}, ["Out"], EXACT),
    "add_axis0": (
        "elementwise_add", lambda r: {"X": [_rand(r, 2, 3, 4)],
                                      "Y": [_rand(r, 2)]},
        {"axis": 0}, ["Out"], EXACT),
    "add_trailing": (
        "elementwise_add", lambda r: {"X": [_rand(r, 2, 3, 4)],
                                      "Y": [_rand(r, 4)]},
        {"axis": -1}, ["Out"], EXACT),
    "add_fc_bias_axis2": (
        "elementwise_add", lambda r: {"X": [_rand(r, 2, 5, 7)],
                                      "Y": [_rand(r, 7)]},
        {"axis": 2}, ["Out"], EXACT),
    # the rest of the _binary family, the ops gradient accumulation emits
    "sub_broadcast": (
        "elementwise_sub", lambda r: {"X": [_rand(r, 2, 3, 4)],
                                      "Y": [_rand(r, 3, 1)]},
        {"axis": 1}, ["Out"], EXACT),
    "mul_scalar_gate": (
        "elementwise_mul", lambda r: {"X": [_rand(r, 5, 6)],
                                      "Y": [np.ones(1, "float32")]},
        {"axis": -1}, ["Out"], EXACT),
    "mul_trailing": (
        "elementwise_mul", lambda r: {"X": [_rand(r, 2, 3, 4)],
                                      "Y": [_rand(r, 4)]},
        {"axis": -1}, ["Out"], EXACT),
    # the divisor's sign, as jnp.mod gives it (torch.fmod would not)
    "mod_signs": (
        "elementwise_mod", lambda r: {
            "X": [_rand(r, 4, 5) * 7],
            "Y": [np.where(r.rand(4, 5) < 0.5, -1.0, 1.0).astype("float32")
                  * (1.5 + r.rand(4, 5).astype("float32"))]},
        {"axis": -1}, ["Out"], EXACT),
    "mod_counter": (
        "elementwise_mod", lambda r: {"X": [np.array([7.0], "float32")],
                                      "Y": [np.array([2.0], "float32")]},
        {}, ["Out"], EXACT),
    "equal_bool": (
        "equal", lambda r: {"X": [r.randint(0, 3, (4, 5)).astype("float32")],
                            "Y": [r.randint(0, 3, (5,)).astype("float32")]},
        {"axis": -1}, ["Out"], EXACT),
    "increment": ("increment", lambda r: {"X": [_rand(r, 1)]},
                  {"step": 1.0}, ["Out"], EXACT),
    "increment_step": ("increment", lambda r: {"X": [_rand(r, 3, 2)]},
                       {"step": -2.5}, ["Out"], EXACT),
    "assign": ("assign", lambda r: {"X": [_rand(r, 3, 4)]}, {}, ["Out"],
               EXACT),
    # dropout at is_test draws nothing: exact for both implementations
    "dropout_test_downgrade": (
        "dropout", lambda r: {"X": [_rand(r, 4, 6)]},
        {"dropout_prob": 0.3, "is_test": True,
         "dropout_implementation": "downgrade_in_infer"},
        ["Out", "Mask"], EXACT),
    "dropout_test_upscale": (
        "dropout", lambda r: {"X": [_rand(r, 4, 6)]},
        {"dropout_prob": 0.3, "is_test": True,
         "dropout_implementation": "upscale_in_train"},
        ["Out", "Mask"], EXACT),
    "dropout_rate_0": (
        "dropout", lambda r: {"X": [_rand(r, 4, 6)]},
        {"dropout_prob": 0.0, "is_test": False,
         "dropout_implementation": "upscale_in_train"},
        ["Out", "Mask"], EXACT),
    "mul_flatten2": (
        "mul", lambda r: {"X": [_rand(r, 2, 5, 6)], "Y": [_rand(r, 6, 7)]},
        {"x_num_col_dims": 2, "y_num_col_dims": 1}, ["Out"], MATMUL),
    "mul_2d": (
        "mul", lambda r: {"X": [_rand(r, 4, 6)], "Y": [_rand(r, 6, 3)]},
        {}, ["Out"], MATMUL),
    "mul_flatten1_3d": (
        "mul", lambda r: {"X": [_rand(r, 3, 2, 4)], "Y": [_rand(r, 8, 5)]},
        {"x_num_col_dims": 1}, ["Out"], MATMUL),
    "scale_after": (
        "scale", lambda r: {"X": [_rand(r, 3, 4)]},
        {"scale": 2.5, "bias": 0.5, "bias_after_scale": True}, ["Out"],
        EXACT),
    "scale_before": (
        "scale", lambda r: {"X": [_rand(r, 3, 4)]},
        {"scale": -1.5, "bias": 2.0, "bias_after_scale": False}, ["Out"],
        EXACT),
    "mean": ("mean", lambda r: {"X": [_rand(r, 5, 6)]}, {}, ["Out"], EXACT),
    "relu": ("relu", lambda r: {"X": [_rand(r, 5, 6)]}, {}, ["Out"], EXACT),
    "reshape_copy_dim": (
        "reshape", lambda r: {"X": [_rand(r, 2, 3, 4)]},
        {"shape": [0, -1]}, ["Out"], EXACT),
    "reshape_flatten": (
        "reshape", lambda r: {"X": [_rand(r, 2, 3, 4)]},
        {"shape": [-1, 4]}, ["Out"], EXACT),
    "reshape_split": (
        "reshape", lambda r: {"X": [_rand(r, 2, 3, 4)]},
        {"shape": [0, 0, 2, 2]}, ["Out"], EXACT),
    "unsqueeze_0": ("unsqueeze", lambda r: {"X": [_rand(r, 3, 4)]},
                    {"axes": [0]}, ["Out"], EXACT),
    "unsqueeze_12": ("unsqueeze", lambda r: {"X": [_rand(r, 3, 4)]},
                     {"axes": [2, 1]}, ["Out"], EXACT),
    "lookup_table": (
        "lookup_table", lambda r: {"W": [_rand(r, 10, 8)],
                                   "Ids": [r.randint(0, 10, (3, 5))]},
        {"padding_idx": -1}, ["Out"], EXACT),
    "lookup_table_trailing1_padding": (
        "lookup_table", lambda r: {"W": [_rand(r, 10, 8)],
                                   "Ids": [r.randint(0, 4, (6, 1))]},
        {"padding_idx": 2}, ["Out"], EXACT),
    "layer_norm_trailing_axis": (
        "layer_norm", lambda r: {"X": [_rand(r, 2, 5, 16) * 3 + 1],
                                 "Scale": [_rand(r, 16)],
                                 "Bias": [_rand(r, 16)]},
        {"begin_norm_axis": 2, "epsilon": 1e-5},
        ["Y", "Mean", "Variance"], EXACT),
    "layer_norm_two_axes": (
        "layer_norm", lambda r: {"X": [_rand(r, 2, 5, 16)],
                                 "Scale": [_rand(r, 80)],
                                 "Bias": [_rand(r, 80)]},
        {"begin_norm_axis": 1, "epsilon": 1e-5},
        ["Y", "Mean", "Variance"], EXACT),
    "layer_norm_no_affine": (
        "layer_norm", lambda r: {"X": [_rand(r, 4, 16)]},
        {"begin_norm_axis": 1, "epsilon": 1e-5},
        ["Y", "Mean", "Variance"], EXACT),
    "xent_hard_label": (
        "softmax_with_cross_entropy",
        lambda r: {"Logits": [_rand(r, 6, 9)],
                   "Label": [np.array([[0], [3], [8], [-100], [4], [1]])]},
        {"ignore_index": -100}, ["Loss", "Softmax"], EXACT),
    "xent_soft_label": (
        "softmax_with_cross_entropy",
        lambda r: {"Logits": [_rand(r, 6, 9)],
                   "Label": [np.abs(_rand(r, 6, 9)) / 9]},
        {"soft_label": True}, ["Loss", "Softmax"], EXACT),
    "fill_constant": ("fill_constant", lambda r: {},
                      {"shape": [3, 4], "dtype": "float32", "value": 1.5},
                      ["Out"], EXACT),
    "assign_value": ("assign_value", lambda r: {},
                     {"shape": [2, 3], "dtype": "float32",
                      "values": np.arange(6, dtype="float32") / 7},
                     ["Out"], EXACT),
    "adam": (
        "adam", lambda r: {"Param": [_rand(r, 3, 4)],
                           "Grad": [_rand(r, 3, 4)],
                           "Moment1": [_rand(r, 3, 4) * 0.1],
                           "Moment2": [np.abs(_rand(r, 3, 4)) * 0.01],
                           "Beta1Pow": [np.array([0.9 ** 3], "float32")],
                           "Beta2Pow": [np.array([0.999 ** 3], "float32")],
                           "LearningRate": [np.array([1e-3], "float32")]},
        {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
        ["ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
         "Beta2PowOut"], EXACT),
    # the unfused LM's ops (the serving engine's oracle build)
    "cast_bool_to_f32": (
        "cast", lambda r: {"X": [_rand(r, 4, 5) > 0]},
        {"out_dtype": "float32"}, ["Out"], EXACT),
    "cast_f32_to_int": (
        "cast", lambda r: {"X": [_rand(r, 4, 5) * 10]},
        {"out_dtype": "int64"}, ["Out"], EXACT),
    "greater_than_broadcast": (
        "greater_than", lambda r: {"X": [_rand(r, 1, 7)],
                                   "Y": [_rand(r, 7, 1)]},
        {}, ["Out"], EXACT),
    "greater_than_axis1": (
        "greater_than", lambda r: {"X": [_rand(r, 2, 3, 4)],
                                   "Y": [_rand(r, 3)]},
        {"axis": 1}, ["Out"], EXACT),
    "matmul_batched": (
        "matmul", lambda r: {"X": [_rand(r, 2, 3, 5, 4)],
                             "Y": [_rand(r, 2, 3, 4, 6)]},
        {}, ["Out"], MATMUL),
    "matmul_transpose_y_alpha": (
        "matmul", lambda r: {"X": [_rand(r, 2, 3, 5, 4)],
                             "Y": [_rand(r, 2, 3, 6, 4)]},
        {"transpose_Y": True, "alpha": 0.5}, ["Out"], MATMUL),
    "matmul_transpose_both": (
        "matmul", lambda r: {"X": [_rand(r, 3, 4, 5)],
                             "Y": [_rand(r, 3, 6, 4)]},
        {"transpose_X": True, "transpose_Y": True, "alpha": -2.0},
        ["Out"], MATMUL),
    "matmul_1d_x": (
        "matmul", lambda r: {"X": [_rand(r, 4)], "Y": [_rand(r, 4, 6)]},
        {}, ["Out"], MATMUL),
    "matmul_1d_both": (
        "matmul", lambda r: {"X": [_rand(r, 5)], "Y": [_rand(r, 5)]},
        {"alpha": 3.0}, ["Out"], MATMUL),
    "softmax_last": ("softmax", lambda r: {"X": [_rand(r, 2, 3, 9) * 4]},
                     {"axis": -1}, ["Out"], EXACT),
    "softmax_axis1": ("softmax", lambda r: {"X": [_rand(r, 2, 5, 3)]},
                      {"axis": 1}, ["Out"], EXACT),
    "split_num": ("split", lambda r: {"X": [_rand(r, 2, 3, 12)]},
                  {"num": 3, "sections": [], "axis": -1}, ["Out"], EXACT),
    "split_sections": ("split", lambda r: {"X": [_rand(r, 7, 4)]},
                       {"num": 0, "sections": [2, 4, 1], "axis": 0},
                       ["Out"], EXACT),
    "transpose_0213": ("transpose", lambda r: {"X": [_rand(r, 2, 3, 4, 5)]},
                       {"axis": [0, 2, 1, 3]}, ["Out"], EXACT),
    "transpose_2d": ("transpose", lambda r: {"X": [_rand(r, 3, 4)]},
                     {"axis": [1, 0]}, ["Out"], EXACT),
    # gradient clipping, regularization and fc over several inputs
    "sum_three_left_to_right": (
        "sum", lambda r: {"X": [_rand(r, 4, 5), _rand(r, 4, 5) * 1e4,
                                _rand(r, 4, 5) * 1e-4]},
        {}, ["Out"], dict(rtol=0, atol=0)),
    "sum_scalars": ("sum", lambda r: {"X": [np.array(r.rand(), "float32"),
                                            np.array(r.rand(), "float32")]},
                    {}, ["Out"], EXACT),
    "clip": ("clip", lambda r: {"X": [_rand(r, 6, 7)]},
             {"min": -0.5, "max": 0.8}, ["Out"], dict(rtol=0, atol=0)),
    "clip_by_norm_bites": ("clip_by_norm", lambda r: {"X": [_rand(r, 6, 7)]},
                           {"max_norm": 1.5}, ["Out"], EXACT),
    "clip_by_norm_passes": (
        "clip_by_norm", lambda r: {"X": [_rand(r, 6, 7) * 1e-2]},
        {"max_norm": 1.5}, ["Out"], dict(rtol=0, atol=0)),
    "squared_l2_norm": ("squared_l2_norm",
                        lambda r: {"X": [_rand(r, 33, 17)]}, {}, ["Out"],
                        EXACT),
    "sqrt": ("sqrt", lambda r: {"X": [np.abs(_rand(r, 5, 6))]}, {}, ["Out"],
             EXACT),
    "sign": ("sign", lambda r: {"X": [np.concatenate(
        [_rand(r, 5, 6), np.zeros((1, 6), "float32")])]}, {}, ["Out"],
        dict(rtol=0, atol=0)),
    "div_broadcast": ("elementwise_div",
                      lambda r: {"X": [_rand(r, 2, 3, 4)],
                                 "Y": [np.abs(_rand(r, 3)) + 0.5]},
                      {"axis": 1}, ["Out"], EXACT),
    "div_scalars": ("elementwise_div",
                    lambda r: {"X": [np.array(0.7, "float32")],
                               "Y": [np.array(r.rand() + 1, "float32")]},
                    {"axis": -1}, ["Out"], EXACT),
    "max_broadcast": ("elementwise_max",
                      lambda r: {"X": [_rand(r, 2, 3, 4)],
                                 "Y": [_rand(r, 4)]},
                      {"axis": -1}, ["Out"], dict(rtol=0, atol=0)),
    # N % 256 == 0: the JAX lowering takes its Pallas head
    "fused_lm_head_loss_pallas": (
        "fused_lm_head_loss",
        lambda r: {"X": [_rand(r, 256, 16)], "W": [_rand(r, 16, 300) * 0.2],
                   "Label": [r.randint(-1, 300, 256)]},
        {"chunk_size": 128}, ["Loss"], MATMUL),
    # any other N: the JAX lowering's chunked scan
    "fused_lm_head_loss_scan": (
        "fused_lm_head_loss",
        lambda r: {"X": [_rand(r, 200, 16)], "W": [_rand(r, 16, 77) * 0.2],
                   "Label": [r.randint(-1, 77, 200)]},
        {"chunk_size": 64}, ["Loss"], MATMUL),
    # the conv plane (ops/nn_ops.py)
    "conv2d_stride_pad": (
        "conv2d", lambda r: {"Input": [_rand(r, 2, 3, 9, 9)],
                             "Filter": [_rand(r, 4, 3, 3, 3)]},
        {"strides": [2, 2], "paddings": [1, 1]}, ["Output"], CONV),
    "conv2d_dilation_groups": (
        "conv2d", lambda r: {"Input": [_rand(r, 2, 4, 11, 10)],
                             "Filter": [_rand(r, 6, 2, 3, 2)]},
        {"strides": [1, 2], "paddings": [2, 1], "dilations": [2, 1],
         "groups": 2}, ["Output"], CONV),
    "conv2d_same_stride2_odd_pad": (
        "conv2d", lambda r: {"Input": [_rand(r, 2, 3, 10, 9)],
                             "Filter": [_rand(r, 5, 3, 4, 3)]},
        {"strides": [2, 2], "paddings": "SAME"}, ["Output"], CONV),
    "conv2d_same_dilated": (
        "conv2d", lambda r: {"Input": [_rand(r, 1, 2, 8, 8)],
                             "Filter": [_rand(r, 3, 2, 3, 3)]},
        {"paddings": "same", "dilations": [2, 2]}, ["Output"], CONV),
    "conv2d_valid_bias": (
        "conv2d", lambda r: {"Input": [_rand(r, 2, 3, 7, 8)],
                             "Filter": [_rand(r, 4, 3, 3, 3)],
                             "Bias": [_rand(r, 4)]},
        {"paddings": "VALID"}, ["Output"], CONV),
    "conv2d_1x1_int_attrs": (
        "conv2d", lambda r: {"Input": [_rand(r, 3, 8, 5, 5)],
                             "Filter": [_rand(r, 16, 8, 1, 1)]},
        {"strides": 1, "paddings": 0, "dilations": 1}, ["Output"], CONV),
    "depthwise_conv2d": (
        "depthwise_conv2d", lambda r: {"Input": [_rand(r, 2, 4, 8, 8)],
                                       "Filter": [_rand(r, 4, 1, 3, 3)]},
        {"strides": [1, 1], "paddings": [1, 1]}, ["Output"], CONV),
    "depthwise_conv2d_multiplier": (
        "depthwise_conv2d", lambda r: {"Input": [_rand(r, 2, 3, 9, 9)],
                                       "Filter": [_rand(r, 6, 1, 3, 3)]},
        {"strides": [2, 2], "paddings": "SAME"}, ["Output"], CONV),
    **{f"pool2d_{t}_p{p}_{'ceil' if c else 'floor'}_"
       f"{'excl' if e else 'incl'}": (
           "pool2d", lambda r, h=h: {"X": [_rand(r, 2, 3, h, h + 1)]},
           {"pooling_type": t, "ksize": [3, 3], "strides": [2, 2],
            "paddings": [p, p], "ceil_mode": c, "exclusive": e},
           ["Out"], SAME if t == "max" else EXACT)
       for t in ("max", "avg") for p in (0, 1) for c in (False, True)
       for e in (True, False) for h in (8,)},
    # windows wider than torch's native padding (pad > k / 2), a window
    # that starts in the high padding under ceil_mode, and a 2 x 2 grid
    "pool2d_max_wide_pad": (
        "pool2d", lambda r: {"X": [_rand(r, 2, 2, 7, 7)]},
        {"pooling_type": "max", "ksize": [2, 2], "strides": [1, 1],
         "paddings": [2, 2]}, ["Out"], SAME),
    "pool2d_avg_wide_pad_excl": (
        "pool2d", lambda r: {"X": [_rand(r, 2, 2, 7, 7)]},
        {"pooling_type": "avg", "ksize": [2, 2], "strides": [1, 1],
         "paddings": [2, 2], "exclusive": True}, ["Out"], EXACT),
    "pool2d_avg_ceil_window_in_pad": (
        "pool2d", lambda r: {"X": [_rand(r, 1, 2, 5, 5)]},
        {"pooling_type": "avg", "ksize": [2, 2], "strides": [3, 3],
         "paddings": [1, 1], "ceil_mode": True, "exclusive": False},
        ["Out"], EXACT),
    "pool2d_max_2x2": (
        "pool2d", lambda r: {"X": [_rand(r, 2, 3, 8, 6)]},
        {"pooling_type": "max", "ksize": [2, 2], "strides": [2, 2]},
        ["Out"], SAME),
    **{f"pool2d_global_{t}": (
        "pool2d", lambda r: {"X": [_rand(r, 2, 5, 7, 6)]},
        {"pooling_type": t, "ksize": [1, 1], "global_pooling": True,
         "ceil_mode": True, "paddings": [1, 1]}, ["Out"], EXACT)
       for t in ("max", "avg")},
    **{f"batch_norm_{mode}_{layout}": (
        "batch_norm", lambda r, layout=layout: {
            "X": [_rand(r, *((4, 3, 5, 6) if layout == "NCHW"
                             else (4, 5, 6, 3))) * 2 + 0.5],
            "Scale": [_rand(r, 3)], "Bias": [_rand(r, 3)],
            "Mean": [_rand(r, 3) * 0.1],
            "Variance": [np.abs(_rand(r, 3)) + 0.5]},
        {"momentum": 0.9, "epsilon": 1e-5, "data_layout": layout,
         "is_test": mode == "test",
         "use_global_stats": mode == "global_stats"},
        ["Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"],
        CONV)
       for mode in ("train", "test", "global_stats")
       for layout in ("NCHW", "NHWC")},
    "batch_norm_fc_rows": (
        "batch_norm", lambda r: {
            "X": [_rand(r, 16, 7)], "Scale": [_rand(r, 7)],
            "Bias": [_rand(r, 7)], "Mean": [np.zeros(7, "float32")],
            "Variance": [np.ones(7, "float32")]},
        {"momentum": 0.5, "epsilon": 1e-3},
        ["Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"],
        CONV),
    "cross_entropy_hard": (
        "cross_entropy",
        lambda r: {"X": [_softmax_rows(_rand(r, 6, 9))],
                   "Label": [np.array([[0], [3], [8], [5], [4], [1]])]},
        {}, ["Y"], EXACT),
    "cross_entropy_ignore_index": (
        "cross_entropy",
        lambda r: {"X": [_softmax_rows(_rand(r, 6, 9))],
                   "Label": [np.array([[0], [3], [-100], [7], [-100], [1]])]},
        {"ignore_index": -100}, ["Y"], EXACT),
    "cross_entropy_ignore_in_range": (
        "cross_entropy",
        lambda r: {"X": [_softmax_rows(_rand(r, 5, 4))],
                   "Label": [np.array([[0], [2], [3], [2], [1]])]},
        {"ignore_index": 2}, ["Y"], EXACT),
    "cross_entropy_soft": (
        "cross_entropy",
        lambda r: {"X": [_softmax_rows(_rand(r, 6, 9))],
                   "Label": [_softmax_rows(_rand(r, 6, 9))]},
        {"soft_label": True}, ["Y"], EXACT),
    "top_k_ties": (
        "top_k", lambda r: {"X": [r.randint(0, 4, (5, 12)).astype(
            "float32")]},
        {"k": 5}, ["Out", "Indices"], SAME),
    "top_k_1": ("top_k", lambda r: {"X": [_rand(r, 2, 3, 10)]}, {"k": 1},
                ["Out", "Indices"], SAME),
    "accuracy_top1": (
        "accuracy", lambda r: {"Out": [_rand(r, 8, 1)],
                               "Indices": [r.randint(0, 4, (8, 1))],
                               "Label": [r.randint(0, 4, (8, 1))]},
        {}, ["Accuracy", "Correct", "Total"], SAME),
    "accuracy_top3": (
        "accuracy", lambda r: {"Out": [_rand(r, 10, 3)],
                               "Indices": [r.randint(0, 6, (10, 3))],
                               "Label": [r.randint(0, 6, (10, 1))]},
        {}, ["Accuracy", "Correct", "Total"], SAME),
    "sgd": ("sgd", lambda r: {"Param": [_rand(r, 3, 4)],
                              "Grad": [_rand(r, 3, 4)],
                              "LearningRate": [np.array([0.01], "float32")]},
            {}, ["ParamOut"], EXACT),
    **{f"momentum{'_nesterov' if n else ''}": (
        "momentum", lambda r: {"Param": [_rand(r, 3, 4)],
                               "Grad": [_rand(r, 3, 4)],
                               "Velocity": [_rand(r, 3, 4) * 0.1],
                               "LearningRate": [np.array([0.1], "float32")]},
        {"mu": 0.9, "use_nesterov": n}, ["ParamOut", "VelocityOut"], EXACT)
       for n in (False, True)},
    # the NMT and BERT builds' ops: the reductions (a full one is 0-d, as
    # jnp.sum(axis=None) gives it), one_hot (a zero row outside [0,
    # depth), as jax.nn.one_hot gives it), label_smooth, slice, gather,
    # gelu and tanh
    "reduce_sum_all": (
        "reduce_sum", lambda r: {"X": [_rand(r, 3, 4, 5)]},
        {"reduce_all": True, "dim": [0], "keep_dim": False}, ["Out"], EXACT),
    "reduce_sum_all_keep": (
        "reduce_sum", lambda r: {"X": [_rand(r, 3, 4)]},
        {"reduce_all": True, "dim": [0], "keep_dim": True}, ["Out"], EXACT),
    "reduce_sum_neg_dims_keep": (
        "reduce_sum", lambda r: {"X": [_rand(r, 3, 4, 5)]},
        {"dim": [-1, 0], "keep_dim": True}, ["Out"], EXACT),
    "reduce_sum_int_dim": (
        "reduce_sum", lambda r: {"X": [_rand(r, 3, 4, 5)]},
        {"dim": 1}, ["Out"], EXACT),
    "reduce_sum_0d": (
        "reduce_sum", lambda r: {"X": [np.array(2.5, "float32")]},
        {"reduce_all": True}, ["Out"], EXACT),
    "reduce_mean_dim": (
        "reduce_mean", lambda r: {"X": [_rand(r, 3, 4, 5)]},
        {"dim": [1]}, ["Out"], EXACT),
    "reduce_mean_all": (
        "reduce_mean", lambda r: {"X": [_rand(r, 6, 7)]},
        {"reduce_all": True}, ["Out"], EXACT),
    "reduce_max_dim": (
        "reduce_max", lambda r: {"X": [_rand(r, 3, 4, 5)]},
        {"dim": [-2], "keep_dim": True}, ["Out"], SAME),
    "reduce_min_all": (
        "reduce_min", lambda r: {"X": [_rand(r, 3, 4, 5)]},
        {"reduce_all": True}, ["Out"], SAME),
    "reduce_prod_dims": (
        "reduce_prod", lambda r: {
            "X": [(0.5 + r.rand(3, 4, 5)).astype("float32")]},
        {"dim": [0, 2]}, ["Out"], EXACT),
    "reduce_all_dim": (
        "reduce_all", lambda r: {"X": [r.rand(4, 3) < 0.8]},
        {"dim": [1]}, ["Out"], SAME),
    "reduce_any_all": (
        "reduce_any", lambda r: {"X": [r.rand(4, 3) < 0.1]},
        {"reduce_all": True}, ["Out"], SAME),
    "one_hot_trailing_1": (
        "one_hot", lambda r: {"X": [r.randint(0, 7, (6, 1))]},
        {"depth": 7}, ["Out"], SAME),
    "one_hot_2d": (
        "one_hot", lambda r: {"X": [r.randint(0, 5, (2, 3))]},
        {"depth": 5}, ["Out"], SAME),
    "one_hot_out_of_range": (
        "one_hot", lambda r: {"X": [np.array([-1, 5, 2, 7, 0], "int64")]},
        {"depth": 5}, ["Out"], SAME),
    "label_smooth_uniform": (
        "label_smooth", lambda r: {
            "X": [np.eye(6, dtype="float32")[r.randint(0, 6, 4)]]},
        {"epsilon": 0.1}, ["Out"], EXACT),
    "label_smooth_prior": (
        "label_smooth", lambda r: {
            "X": [np.eye(6, dtype="float32")[r.randint(0, 6, 4)]],
            "PriorDist": [_softmax_rows(_rand(r, 1, 6))]},
        {"epsilon": 0.2}, ["Out"], EXACT),
    "slice_negative_and_clamped": (
        "slice", lambda r: {"Input": [_rand(r, 4, 5, 6)]},
        {"axes": [0, 2], "starts": [-3, 1], "ends": [100, -1]}, ["Out"],
        SAME),
    "slice_decrease_axis": (
        "slice", lambda r: {"Input": [_rand(r, 4, 5, 6)]},
        {"axes": [1], "starts": [0], "ends": [1], "decrease_axis": [1]},
        ["Out"], SAME),
    "slice_start_past_end": (
        "slice", lambda r: {"Input": [_rand(r, 4, 5)]},
        {"axes": [1], "starts": [4], "ends": [2]}, ["Out"], SAME),
    "gather_rows": (
        "gather", lambda r: {"X": [_rand(r, 7, 4)],
                             "Index": [r.randint(0, 7, 9)]},
        {}, ["Out"], SAME),
    "gather_column_index": (
        "gather", lambda r: {"X": [_rand(r, 7, 4)],
                             "Index": [r.randint(0, 7, (5, 1))]},
        {"axis": 0}, ["Out"], SAME),
    "gather_axis1": (
        "gather", lambda r: {"X": [_rand(r, 3, 6, 2)],
                             "Index": [r.randint(0, 6, 4)]},
        {"axis": 1}, ["Out"], SAME),
    "gelu_erf": ("gelu", lambda r: {"X": [_rand(r, 4, 5) * 3]}, {},
                 ["Out"], EXACT),
    "gelu_tanh": ("gelu", lambda r: {"X": [_rand(r, 4, 5) * 3]},
                  {"approximate": True}, ["Out"], EXACT),
    "tanh": ("tanh", lambda r: {"X": [_rand(r, 4, 5) * 2]}, {}, ["Out"],
             EXACT),
}


# ids far outside the table, as raw CTR ids are: above 2^31, above 2^32
# and below 0 (JAX's int32 feed keeps their low 32 bits)
WIDE_IDS = np.array([[2**31 + 7, 2**32 + 3, -5, 2**40 + 11],
                     [-2**35 - 1, 0, 12345678901, 2**31 - 1],
                     [2**32, -1, 2**63 - 1, -2**63]], dtype=np.int64)

CTR_CASES = {
    "sigmoid": ("sigmoid", lambda r: {"X": [_rand(r, 4, 5) * 4]}, {},
                ["Out"], EXACT),
    "square": ("square", lambda r: {"X": [_rand(r, 4, 5) * 3]}, {},
               ["Out"], EXACT),
    "squeeze_axis": ("squeeze", lambda r: {"X": [_rand(r, 3, 1, 4, 1)]},
                     {"axes": [1]}, ["Out"], SAME),
    # a listed axis of size 4 stays; the negative one goes
    "squeeze_neg_and_non1": ("squeeze",
                             lambda r: {"X": [_rand(r, 3, 1, 4, 1)]},
                             {"axes": [-1, 2]}, ["Out"], SAME),
    "squeeze_all": ("squeeze", lambda r: {"X": [_rand(r, 1, 3, 1, 4)]},
                    {"axes": []}, ["Out"], SAME),
    "sigmoid_xent": ("sigmoid_cross_entropy_with_logits", lambda r: {
        "X": [_rand(r, 6, 1) * 3],
        "Label": [r.randint(0, 2, (6, 1)).astype("float32")]},
        {}, ["Out"], EXACT),
    "sigmoid_xent_soft": ("sigmoid_cross_entropy_with_logits", lambda r: {
        "X": [_rand(r, 4, 3) * 5],
        "Label": [r.rand(4, 3).astype("float32")]}, {}, ["Out"], EXACT),
    "sigmoid_xent_ignore_normalize": (
        "sigmoid_cross_entropy_with_logits", lambda r: {
            "X": [_rand(r, 8, 1) * 3],
            "Label": [np.where(r.rand(8, 1) < 0.3, -1.0,
                               r.randint(0, 2, (8, 1))).astype("float32")]},
        {"ignore_index": -1, "normalize": True}, ["Out"], EXACT),
    "greater_equal_ties": (
        "greater_equal", lambda r: {
            "X": [r.randint(0, 3, (4, 5)).astype("float32")],
            "Y": [r.randint(0, 3, (5,)).astype("float32")]},
        {"axis": -1}, ["Out"], SAME),
    "sparse_lookup_plain": (
        "sparse_embedding_lookup", lambda r: {
            "W": [_rand(r, 10, 8)], "Ids": [r.randint(0, 10, (3, 5))]},
        {"hash_bucket": False}, ["Out"], SAME),
    "sparse_lookup_hash_wide_ids": (
        "sparse_embedding_lookup", lambda r: {
            "W": [_rand(r, 37, 4)], "Ids": [WIDE_IDS]},
        {"hash_bucket": True}, ["Out"], SAME),
    "sparse_lookup_hash_trailing1": (
        "sparse_embedding_lookup", lambda r: {
            "W": [_rand(r, 1000, 3)],
            "Ids": [r.randint(-2**62, 2**62, (6, 1), dtype=np.int64)]},
        {"hash_bucket": True}, ["Out"], SAME),
    # row 3 three times and row 0 twice: the adds accumulate
    "sparse_scatter_duplicates": (
        "sparse_scatter_update", lambda r: {
            "W": [_rand(r, 10, 4)],
            "Ids": [np.array([0, 3, 3, 7, 3, 0], np.int64)],
            "Grad": [_rand(r, 6, 4)]},
        {"learning_rate": 0.1}, ["Out"], EXACT),
}


def _opt_ins(r, *slots, shape=(4, 5), pos=(), pows=(), lr=True):
    """An update op's inputs: Param, Grad, the learning rate [1], the
    accumulators in `slots` (any sign), those in `pos` (positive, as
    squared sums are) and the [1] pows in `pows`."""
    ins = {"Param": [_rand(r, *shape)], "Grad": [_rand(r, *shape)]}
    if lr:
        ins["LearningRate"] = [np.array([0.05], "float32")]
    for slot in slots:
        ins[slot] = [_rand(r, *shape) * 0.1]
    for slot in pos:
        ins[slot] = [np.abs(_rand(r, *shape)) + 0.1]
    for slot, v in pows:
        ins[slot] = [np.array([v], "float32")]
    return ins


_ADAM_OUT = ["ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
             "Beta2PowOut"]
_POWS = (("Beta1Pow", 0.9 ** 2), ("Beta2Pow", 0.999 ** 2))

OPT_CASES = {
    "lars_momentum": (
        "lars_momentum", lambda r: _opt_ins(r, "Velocity"),
        {"mu": 0.9, "lars_coeff": 1e-3, "lars_weight_decay": 5e-4},
        ["ParamOut", "VelocityOut"], MATMUL),
    # a zero gradient takes the plain lr branch
    "lars_momentum_zero_grad": (
        "lars_momentum", lambda r: dict(_opt_ins(r, "Velocity"),
                                        Grad=[np.zeros((4, 5), "float32")]),
        {"mu": 0.9}, ["ParamOut", "VelocityOut"], MATMUL),
    "adamw": ("adamw", lambda r: _opt_ins(r, "Moment1", pos=("Moment2",),
                                          pows=_POWS),
              {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
               "coeff": 0.01}, _ADAM_OUT, EXACT),
    "adamax": ("adamax", lambda r: _opt_ins(r, "Moment", pos=("InfNorm",),
                                            pows=_POWS[:1]),
               {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
               ["ParamOut", "MomentOut", "InfNormOut", "Beta1PowOut"],
               EXACT),
    "adagrad": ("adagrad", lambda r: _opt_ins(r, pos=("Moment",)),
                {"epsilon": 1e-6}, ["ParamOut", "MomentOut"], EXACT),
    "decayed_adagrad": ("decayed_adagrad",
                        lambda r: _opt_ins(r, pos=("Moment",)),
                        {"decay": 0.95, "epsilon": 1e-6},
                        ["ParamOut", "MomentOut"], EXACT),
    "adadelta": ("adadelta", lambda r: _opt_ins(
        r, pos=("AvgSquaredGrad", "AvgSquaredUpdate"), lr=False),
        {"rho": 0.95, "epsilon": 1e-6},
        ["ParamOut", "AvgSquaredGradOut", "AvgSquaredUpdateOut"], EXACT),
    "rmsprop": ("rmsprop", lambda r: _opt_ins(r, "Moment",
                                              pos=("MeanSquare",)),
                {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.9},
                ["ParamOut", "MeanSquareOut", "MomentOut"], EXACT),
    "rmsprop_centered": (
        "rmsprop", lambda r: _opt_ins(r, "Moment", "MeanGrad",
                                      pos=("MeanSquare",)),
        {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.5, "centered": True},
        ["ParamOut", "MeanSquareOut", "MomentOut", "MeanGradOut"], EXACT),
    "ftrl": ("ftrl", lambda r: _opt_ins(r, "LinearAccumulator",
                                        pos=("SquaredAccumulator",)),
             {"l1": 0.1, "l2": 0.01, "lr_power": -0.5},
             ["ParamOut", "SquaredAccumOut", "LinearAccumOut"], EXACT),
    "ftrl_lr_power": ("ftrl", lambda r: _opt_ins(
        r, "LinearAccumulator", pos=("SquaredAccumulator",)),
        {"l1": 0.05, "l2": 0.02, "lr_power": -0.7},
        ["ParamOut", "SquaredAccumOut", "LinearAccumOut"], EXACT),
    "proximal_gd": ("proximal_gd", lambda r: _opt_ins(r),
                    {"l1": 0.5, "l2": 0.1}, ["ParamOut"], EXACT),
    "proximal_adagrad": ("proximal_adagrad",
                         lambda r: _opt_ins(r, pos=("Moment",)),
                         {"l1": 0.1, "l2": 0.01},
                         ["ParamOut", "MomentOut"], EXACT),
    "lamb": ("lamb", lambda r: _opt_ins(r, "Moment1", pos=("Moment2",),
                                        pows=_POWS),
             {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
              "weight_decay": 0.01}, _ADAM_OUT, MATMUL),
}


def _mask(r, B, T):
    """A [B, T] mask with ragged right pads and a hole mid-sequence."""
    m = (np.arange(T)[None, :] < r.randint(T // 2, T + 1, (B, 1))).astype(
        "float32")
    m[0, 1] = 0.0
    return m


def _lstm_ins(r, B=3, T=6, H=4, mask=False, h0=False, c0=False):
    ins = {"Input": [_rand(r, B, T, 4 * H)],
           "Weight": [_rand(r, H, 4 * H) * 0.5]}
    if mask:
        ins["Mask"] = [_mask(r, B, T)]
    if h0:
        ins["H0"] = [_rand(r, B, H)]
    if c0:
        ins["C0"] = [_rand(r, B, H)]
    return ins


def _gru_ins(r, B=3, T=6, H=4, mask=False, h0=False):
    ins = {"Input": [_rand(r, B, T, 3 * H)],
           "Weight": [_rand(r, H, 3 * H) * 0.5]}
    if mask:
        ins["Mask"] = [_mask(r, B, T)]
    if h0:
        ins["H0"] = [_rand(r, B, H)]
    return ins


_LSTM_OUT = ["Hidden", "Cell", "LastH", "LastC"]
_GRU_OUT = ["Hidden", "LastH"]

# the conv builds' lrn and concat, and the recurrent family: MATMUL where
# a step's recurrent product enters, EXACT for lrn's window sums and the
# one-step units without one, SAME for concat (no arithmetic)
RNN_CONV_CASES = {
    "lrn_n5": ("lrn", lambda r: {"X": [_rand(r, 2, 7, 4, 4) * 3]},
               {"n": 5, "k": 2.0, "alpha": 1e-2, "beta": 0.75},
               ["Out", "MidOut"], EXACT),
    "lrn_n3_k1": ("lrn", lambda r: {"X": [_rand(r, 2, 6, 3, 5) * 3]},
                  {"n": 3, "k": 1.0, "alpha": 0.05, "beta": 0.5},
                  ["Out", "MidOut"], EXACT),
    "concat_axis0": ("concat", lambda r: {
        "X": [_rand(r, 2, 3), _rand(r, 4, 3), _rand(r, 1, 3)]},
        {"axis": 0}, ["Out"], SAME),
    "concat_axis1": ("concat", lambda r: {
        "X": [_rand(r, 2, c, 3, 3) for c in (1, 4, 2)]},
        {"axis": 1}, ["Out"], SAME),
    "concat_neg1": ("concat", lambda r: {
        "X": [_rand(r, 2, 3, 5), _rand(r, 2, 3, 1)]},
        {"axis": -1}, ["Out"], SAME),
    # an int block promotes to the float one's dtype in both packages
    "concat_mixed_int_float": ("concat", lambda r: {
        "X": [_rand(r, 2, 3), r.randint(-5, 5, (2, 2))]},
        {"axis": 1}, ["Out"], SAME),
    "lstm_plain": ("lstm", lambda r: _lstm_ins(r), {}, _LSTM_OUT, MATMUL),
    "lstm_mask": ("lstm", lambda r: _lstm_ins(r, mask=True), {},
                  _LSTM_OUT, MATMUL),
    "lstm_reverse_mask_h0_c0": (
        "lstm", lambda r: _lstm_ins(r, mask=True, h0=True, c0=True),
        {"is_reverse": True}, _LSTM_OUT, MATMUL),
    "lstm_activations": (
        "lstm", lambda r: _lstm_ins(r, h0=True),
        {"gate_activation": "sigmoid", "cell_activation": "relu",
         "candidate_activation": "identity"}, _LSTM_OUT, MATMUL),
    "gru_plain": ("gru", lambda r: _gru_ins(r), {}, _GRU_OUT, MATMUL),
    "gru_mask": ("gru", lambda r: _gru_ins(r, mask=True), {}, _GRU_OUT,
                 MATMUL),
    "gru_reverse_mask_h0": (
        "gru", lambda r: _gru_ins(r, mask=True, h0=True),
        {"is_reverse": True}, _GRU_OUT, MATMUL),
    "gru_activations": (
        "gru", lambda r: _gru_ins(r, h0=True),
        {"gate_activation": "sigmoid", "activation": "relu"}, _GRU_OUT,
        MATMUL),
    "lstm_unit_forget_bias": ("lstm_unit", lambda r: {
        "X": [_rand(r, 4, 16) * 2], "C_prev": [_rand(r, 4, 4)]},
        {"forget_bias": 1.0}, ["C", "H"], EXACT),
    "gru_unit": ("gru_unit", lambda r: {
        "Input": [_rand(r, 4, 12)], "HiddenPrev": [_rand(r, 4, 4)],
        "Weight": [_rand(r, 4, 12) * 0.5]},
        {}, ["Hidden", "Gate", "ResetHiddenPrev"], MATMUL),
}


def _beam_ins(r, B=3, K=3, V=7, ties=False, finished=False, state=True):
    """beam_search's inputs: cumulative scores, last tokens (end_id 1 in
    some beams where `finished`), next-token log-probs (integer-valued,
    so equal candidates abound, where `ties`), and a [B, K, 2] state."""
    if ties:
        lp = -r.randint(0, 3, (B, K, V)).astype("float32")
        pre = -r.randint(0, 2, (B, K)).astype("float32")
    else:
        lp = np.log(_softmax_rows(_rand(r, B, K, V) * 2))
        pre = np.sort(_rand(r, B, K), axis=1)[:, ::-1].copy()
    ids = r.randint(2, V, (B, K)).astype("int64")
    if finished:
        ids[0, 0] = ids[1, 2] = ids[2, 1] = 1
    ins = {"PreScores": [pre], "PreIds": [ids], "LogProbs": [lp]}
    if state:
        ins["State"] = [_rand(r, B, K, 2)]
    return ins


def _crf_ins(r, B=3, T=6, N=4, mask=True, tied=False, label3=False):
    em = (r.randint(-2, 3, (B, T, N)).astype("float32") if tied
          else _rand(r, B, T, N))
    tr = (r.randint(-1, 2, (N + 2, N)).astype("float32") if tied
          else _rand(r, N + 2, N) * 0.5)
    lab = r.randint(0, N, (B, T, 1) if label3 else (B, T))
    ins = {"Emission": [em], "Transition": [tr], "Label": [lab]}
    if mask:
        ins["Mask"] = [_mask(r, B, T)]
    return ins


def _pool_case(ptype, mask="mask"):
    def build(r):
        ins = {"X": [_rand(r, 4, 6, 3)]}
        if mask == "mask":
            ins["Mask"] = [_mask(r, 4, 6)]
        elif mask == "length":
            ins["Length"] = [np.array([6, 1, 3, 4], np.int64)]
        return ins
    return ("sequence_pool", build, {"pooltype": ptype}, ["Out"], EXACT)


_BEAM_OUT = ["Scores", "Ids", "Parents", "StateOut"]
_CRF_OUT = ["LogLikelihood", "Alpha", "EmissionExps", "TransitionExps"]

# the machine-translation decode's ops and the book's: MATMUL where a
# product or a recurrence enters, EXACT for elementwise math and the
# pools, SAME for the integer bookkeeping (beam search's indices, the
# backtrack, Viterbi paths, fills, tiles)
SEQ_CASES = {
    "static_rnn_scan": ("static_rnn_scan", lambda r: {
        "Init": [_rand(r, 3, 4)], "X": [_rand(r, 5, 3, 2)],
        "W": [_rand(r, 2, 4)]},
        {"sub_block": 1, "carry_vars": ["m"], "x_inner_vars": ["x_t"],
         "y_vars": ["h", "a"]}, ["Ys", "CarryOut"], MATMUL),
    "beam_search": ("beam_search", lambda r: _beam_ins(r),
                    {"beam_size": 3, "end_id": 1}, _BEAM_OUT, EXACT),
    "beam_search_planted_ties": (
        "beam_search", lambda r: _beam_ins(r, B=4, ties=True),
        {"beam_size": 3, "end_id": 1}, _BEAM_OUT, SAME),
    "beam_search_finished_beams": (
        "beam_search", lambda r: _beam_ins(r, finished=True),
        {"beam_size": 3, "end_id": 1}, _BEAM_OUT, EXACT),
    "beam_search_no_state": (
        "beam_search", lambda r: _beam_ins(r, K=2, V=5, state=False),
        {"beam_size": 2, "end_id": 1}, _BEAM_OUT[:3], EXACT),
    "beam_search_decode": ("beam_search_decode", lambda r: {
        "Ids": [r.randint(0, 9, (5, 3, 4))],
        "Parents": [r.randint(0, 4, (5, 3, 4))],
        "Scores": [_rand(r, 3, 4)]}, {},
        ["SentenceIds", "SentenceScores"], SAME),
    "expand": ("expand", lambda r: {"X": [_rand(r, 2, 1, 3)]},
               {"expand_times": [1, 4, 2]}, ["Out"], SAME),
    "expand_int_rank_up": ("expand", lambda r: {
        "X": [r.randint(0, 9, (2, 3))]}, {"expand_times": [2, 1, 3]},
        ["Out"], SAME),
    "fill_cbsl_int32": ("fill_constant_batch_size_like", lambda r: {
        "Input": [_rand(r, 5, 3)]},
        {"shape": [-1, 4], "dtype": "int32", "value": 7.0}, ["Out"], SAME),
    "fill_cbsl_dims": ("fill_constant_batch_size_like", lambda r: {
        "Input": [_rand(r, 2, 6, 3)]},
        {"shape": [2, -1, 1], "dtype": "float32", "value": -1e9,
         "input_dim_idx": 1, "output_dim_idx": 1}, ["Out"], SAME),
    "log_softmax": ("log_softmax", lambda r: {"X": [_rand(r, 4, 7) * 3]},
                    {"axis": -1}, ["Out"], EXACT),
    "log_softmax_axis1": ("log_softmax",
                          lambda r: {"X": [_rand(r, 2, 5, 3) * 3]},
                          {"axis": 1}, ["Out"], EXACT),
    "square_error_cost": ("square_error_cost", lambda r: {
        "X": [_rand(r, 6, 1)], "Label": [_rand(r, 6, 1)]}, {}, ["Out"],
        EXACT),
    "cos_sim": ("cos_sim", lambda r: {"X": [_rand(r, 5, 8)],
                                      "Y": [_rand(r, 5, 8)]}, {},
                ["Out", "XNorm", "YNorm"], EXACT),
    "cos_sim_broadcast_zero_row": ("cos_sim", lambda r: {
        "X": [np.concatenate([_rand(r, 3, 6), np.zeros((1, 6), "float32")])],
        "Y": [_rand(r, 1, 6)]}, {}, ["Out", "XNorm", "YNorm"], EXACT),
    "sequence_conv": ("sequence_conv", lambda r: {
        "X": [_rand(r, 3, 6, 4)], "Filter": [_rand(r, 12, 5)]},
        {"contextLength": 3, "contextStart": -1, "contextStride": 1},
        ["Out"], MATMUL),
    "sequence_conv_len4_default_start": ("sequence_conv", lambda r: {
        "X": [_rand(r, 2, 5, 3)], "Filter": [_rand(r, 12, 2)]},
        {"contextLength": 4}, ["Out"], MATMUL),
    "linear_chain_crf_mask": ("linear_chain_crf", lambda r: _crf_ins(r),
                              {}, _CRF_OUT, MATMUL),
    "linear_chain_crf_label3": (
        "linear_chain_crf", lambda r: _crf_ins(r, mask=False, label3=True),
        {}, _CRF_OUT, MATMUL),
    "crf_decoding_mask": ("crf_decoding", lambda r: {
        k: v for k, v in _crf_ins(r).items() if k != "Label"}, {},
        ["ViterbiPath"], SAME),
    "crf_decoding_tied": ("crf_decoding", lambda r: {
        k: v for k, v in _crf_ins(r, B=4, T=7, mask=False,
                                  tied=True).items() if k != "Label"},
        {}, ["ViterbiPath"], SAME),
    "crf_decoding_label": ("crf_decoding", lambda r: _crf_ins(r), {},
                           ["ViterbiPath"], SAME),
}
for _p in ("AVERAGE", "SUM", "SQRT", "MAX", "LAST", "FIRST"):
    SEQ_CASES[f"sequence_pool_{_p.lower()}_mask"] = _pool_case(_p)
SEQ_CASES["sequence_pool_last_length"] = _pool_case("LAST", "length")
SEQ_CASES["sequence_pool_average_nomask"] = _pool_case("AVERAGE", None)


def _i64(r, *shape, lo=0, hi=10):
    return r.randint(lo, hi, shape).astype("int64")


def _lengths(*v):
    return np.array(v, "int64")


def _ctc_ins(r, B=4, T=9, C=5, S=3, logits_len=None, label_len=None,
             label=None):
    """warpctc's inputs: seeded logits, labels over 1 .. C-1 (blank 0)
    with a repeated pair planted (no skip between them)."""
    lab = _i64(r, B, S, lo=1, hi=C) if label is None else label
    if label is None:
        lab[0, 1] = lab[0, 0]
    ins = {"Logits": [_rand(r, B, T, C) * 2], "Label": [lab]}
    if logits_len is not None:
        ins["LogitsLength"] = [_lengths(*logits_len)]
    if label_len is not None:
        ins["LabelLength"] = [_lengths(*label_len)]
    return ins


def _cudnn_w(r, D, H, L, ndir):
    n, din = 0, D
    for _ in range(L):
        n += ndir * (din * 4 * H + H * 4 * H + 4 * H)
        din = H * ndir
    return _rand(r, n) * 0.4


def _zero_rows(a, *rows):
    a[list(rows)] = 0.0
    return a


_CHUNK_OUT = ["Precision", "Recall", "F1-Score", "NumInferChunks",
              "NumLabelChunks", "NumCorrectChunks"]

# the sequence, LoD-array, CTC, sampling and selected-rows planes and the
# vision and host extras (JAX's tests/test_op_sweep.py SPECS shapes, and
# planted cases: indices wrapped, clamped and dropped, repeated ids,
# ties, a clip's bounds, 0 in a stable cross entropy, CTC's frozen rows
# and empty labels, excluded chunk types).  SAME for copies, indices and
# integers; EXACT for elementwise math and short sums; MATMUL where a
# product or a recurrence enters.  add_position_encoding at EXACT's atol
# 1e-5: XLA's pow, sin and cos on the CPU and torch's may part by ulps
# of the angle, up to T (64 here)
SEQ_PLANE_CASES = {
    "sequence_mask": ("sequence_mask", lambda r: {
        "X": [_i64(r, 3, lo=1, hi=5)]}, {"maxlen": 5}, ["Y"], SAME),
    "sequence_mask_zero_and_past_maxlen_f32": (
        "sequence_mask", lambda r: {"X": [np.array([[0], [7], [3]],
                                                   "int64")]},
        {"maxlen": 5, "out_dtype": "float32"}, ["Y"], SAME),
    "sequence_softmax": ("sequence_softmax", lambda r: {
        "X": [_rand(r, 3, 5)]}, {}, ["Out"], EXACT),
    "sequence_softmax_mask": ("sequence_softmax", lambda r: {
        "X": [_rand(r, 4, 6) * 3], "Mask": [_mask(r, 4, 6)]}, {}, ["Out"],
        EXACT),
    "sequence_softmax_length_3d": ("sequence_softmax", lambda r: {
        "X": [_rand(r, 3, 5, 2)], "Length": [_lengths(5, 1, 3)]}, {},
        ["Out"], EXACT),
    "sequence_expand": ("sequence_expand", lambda r: {
        "X": [_rand(r, 2, 3)], "Y": [_rand(r, 2, 4, 3)]}, {"ref_level": -1},
        ["Out"], SAME),
    "sequence_expand_as_3d": ("sequence_expand_as", lambda r: {
        "X": [_rand(r, 2, 3, 2)], "Y": [_rand(r, 2, 5)]}, {}, ["Out"], SAME),
    "sequence_reverse": ("sequence_reverse", lambda r: {
        "X": [_rand(r, 2, 4, 3)]}, {}, ["Y"], SAME),
    "sequence_reverse_length": ("sequence_reverse", lambda r: {
        "X": [_rand(r, 4, 5, 2)], "Length": [_lengths(5, 0, 1, 3)]}, {},
        ["Y"], SAME),
    "sequence_concat": ("sequence_concat", lambda r: {
        "X": [_rand(r, 2, 3, 4), _rand(r, 2, 2, 4)]}, {}, ["Out"], SAME),
    "sequence_slice": ("sequence_slice", lambda r: {
        "X": [_rand(r, 3, 5, 2)]}, {"offset": 1, "length": 2}, ["Out"],
        SAME),
    "sequence_slice_past_end": ("sequence_slice", lambda r: {
        "X": [_rand(r, 3, 5, 2)]}, {"offset": 3, "length": 4}, ["Out"],
        SAME),
    "sequence_pad_longer": ("sequence_pad", lambda r: {
        "X": [_rand(r, 2, 4, 3)], "Length": [_i64(r, 2, lo=1, hi=4)]},
        {"padded_length": 6, "pad_value": 1.5}, ["Out", "Length"], SAME),
    "sequence_pad_shorter_no_length": ("sequence_pad", lambda r: {
        "X": [_rand(r, 2, 5, 3)]}, {"padded_length": 3},
        ["Out", "Length"], SAME),
    # the layer's default padded_length -1 drops the last step in both
    "sequence_pad_default": ("sequence_pad", lambda r: {
        "X": [_rand(r, 2, 4)]}, {"padded_length": -1, "pad_value": 0.0},
        ["Out", "Length"], SAME),
    "sequence_unpad": ("sequence_unpad", lambda r: {
        "X": [_rand(r, 2, 5, 3)], "Length": [_i64(r, 2, lo=1, hi=5)]}, {},
        ["Out"], SAME),
    "sequence_enumerate": ("sequence_enumerate", lambda r: {
        "X": [_i64(r, 2, 5, hi=9)]}, {"win_size": 3, "pad_value": 7},
        ["Out"], SAME),
    "sequence_reshape": ("sequence_reshape", lambda r: {
        "X": [_rand(r, 2, 4, 6)]}, {"new_dim": 3}, ["Out"], SAME),
    # ids -1 (wraps into the last step), 6 and -7 (dropped), a repeat
    "sequence_scatter_planted_ids": ("sequence_scatter", lambda r: {
        "X": [_rand(r, 3, 6)],
        "Ids": [np.array([[1, 1, -1, 6], [0, 5, -7, 2], [3, 3, 3, -6]],
                         "int64")],
        "Updates": [_rand(r, 3, 4)]}, {}, ["Out"], EXACT),
    "sequence_scatter_3d": ("sequence_scatter", lambda r: {
        "X": [_rand(r, 2, 6, 3)], "Ids": [_i64(r, 2, 3, hi=6)],
        "Updates": [_rand(r, 2, 3, 3)]}, {}, ["Out"], EXACT),
    "lod_reset": ("lod_reset", lambda r: {"X": [_rand(r, 4, 3)]},
                  {"target_lod": []}, ["Out"], SAME),
    "row_conv": ("row_conv", lambda r: {
        "X": [_rand(r, 2, 5, 3)], "Filter": [_rand(r, 3, 3) * 0.3]}, {},
        ["Out"], EXACT),
    "add_position_encoding": ("add_position_encoding", lambda r: {
        "X": [_rand(r, 2, 5, 4)]}, {}, ["Out"], EXACT),
    "add_position_encoding_t64_alpha_beta": (
        "add_position_encoding", lambda r: {"X": [_rand(r, 2, 64, 16)]},
        {"alpha": 0.5, "beta": 2.0}, ["Out"], EXACT),
    # the LoD arrays
    "lod_rank_table_mask_ties": ("lod_rank_table", lambda r: {
        "X": [np.array([[1, 1, 0, 0], [1, 1, 1, 0], [1, 1, 0, 0],
                        [1, 1, 1, 1]], "float32")]}, {},
        ["Out", "Lengths"], SAME),
    "lod_rank_table_lengths": ("lod_rank_table", lambda r: {
        "X": [_lengths(2, 5, 2, 1, 5)]}, {}, ["Out", "Lengths"], SAME),
    "max_sequence_len": ("max_sequence_len", lambda r: {
        "X": [np.array([[1, 1, 0], [1, 1, 1]], "float32")]}, {}, ["Out"],
        SAME),
    "max_sequence_len_rank_table": ("max_sequence_len", lambda r: {
        "RankTable": [_lengths(3, 7, 2)]}, {}, ["Out"], SAME),
    "reorder_lod_tensor_by_rank": ("reorder_lod_tensor_by_rank", lambda r: {
        "X": [_rand(r, 4, 3)], "RankTable": [_lengths(2, 0, 3, 1)]}, {},
        ["Out"], SAME),
    "tensor_array_to_tensor": ("tensor_array_to_tensor", lambda r: {
        "X": [_rand(r, 2, 3), _rand(r, 2, 3)]}, {"axis": 0},
        ["Out", "OutIndex"], SAME),
    "tensor_array_to_tensor_axis1": ("tensor_array_to_tensor", lambda r: {
        "X": [_rand(r, 2, 3), _rand(r, 2, 1), _rand(r, 2, 2)]},
        {"axis": 1}, ["Out", "OutIndex"], SAME),
    "tensor_array_to_tensor_stack": ("tensor_array_to_tensor", lambda r: {
        "X": [_rand(r, 2, 3), _rand(r, 2, 3)]},
        {"axis": 1, "use_stack": True}, ["Out", "OutIndex"], SAME),
    "split_lod_tensor": ("split_lod_tensor", lambda r: {
        "X": [_rand(r, 4, 3)], "Mask": [np.array([[True], [False],
                                                  [True], [False]])]}, {},
        ["OutTrue", "OutFalse"], SAME),
    "merge_lod_tensor": ("merge_lod_tensor", lambda r: {
        "InTrue": [_rand(r, 4, 3, 2)], "InFalse": [_rand(r, 4, 3, 2)],
        "Mask": [_i64(r, 4, 1, hi=2).astype(bool)]}, {}, ["Out"], SAME),
    "lod_array_length": ("lod_array_length", lambda r: {
        "X": [_rand(r, 2, 3), _rand(r, 2, 3), _rand(r, 2, 3)]}, {},
        ["Out"], SAME),
    "lod_tensor_to_array": ("lod_tensor_to_array", lambda r: {
        "X": [_rand(r, 3, 4, 2)], "RankTable": [_lengths(2, 0, 1)]}, {},
        ["Out"], SAME),
    "array_to_lod_tensor": ("array_to_lod_tensor", lambda r: {
        "X": [_rand(r, 3, 2) for _ in range(4)],
        "RankTable": [_lengths(2, 0, 1)]}, {}, ["Out"], SAME),
    "shrink_rnn_memory": ("shrink_rnn_memory", lambda r: {
        "X": [_rand(r, 3, 4, 2)], "RankTable": [_lengths(4, 3, 1)],
        "I": [_lengths(2)]}, {}, ["Out"], SAME),
    "rnn_memory_helper": ("rnn_memory_helper", lambda r: {
        "X": [_rand(r, 2, 3)]}, {}, ["Out"], SAME),
    "write_to_array_fresh": ("write_to_array", lambda r: {
        "X": [_rand(r, 3, 4)], "I": [_lengths(1)]}, {"array_len": 4},
        ["Out"], SAME),
    # lax's rule on a length-3 array: 5 clamps to row 2, -1 wraps to row 2,
    # -5 wraps to -2 and clamps to row 0
    **{f"write_to_array_index_{i}": ("write_to_array", lambda r, i=i: {
        "X": [_rand(r, 2, 4)], "I": [_lengths(i)],
        "Array": [_rand(r, 3, 2, 4)]}, {}, ["Out"], SAME)
       for i in (2, 5, -1, -5)},
    **{f"read_from_array_index_{i}": ("read_from_array", lambda r, i=i: {
        "X": [_rand(r, 3, 2)], "I": [_lengths(i)]}, {}, ["Out"], SAME)
       for i in (1, 7, -1, -4)},
    # the recurrent extras
    "sequence_context_len3": ("sequence_context", lambda r: {
        "X": [_rand(r, 2, 5, 3)]}, {"context_length": 3}, ["Out"], SAME),
    "sequence_context_len4_default_start": ("sequence_context", lambda r: {
        "X": [_rand(r, 2, 5, 2)]}, {"context_length": 4}, ["Out"], SAME),
    "sequence_context_start0": ("sequence_context", lambda r: {
        "X": [_rand(r, 2, 4, 2)]}, {"context_length": 2, "context_start": 0},
        ["Out"], SAME),
    "conv_shift": ("conv_shift", lambda r: {
        "X": [_rand(r, 2, 6)], "Y": [_rand(r, 2, 3)]}, {}, ["Out"], EXACT),
    "lstmp": ("lstmp", lambda r: {
        "Input": [_rand(r, 2, 4, 8)], "Weight": [_rand(r, 3, 8) * 0.5],
        "ProjWeight": [_rand(r, 2, 3) * 0.5]}, {},
        ["Projection", "Cell", "LastH", "LastC"], MATMUL),
    "lstmp_h0_c0": ("lstmp", lambda r: {
        "Input": [_rand(r, 3, 5, 12)], "Weight": [_rand(r, 2, 12) * 0.5],
        "ProjWeight": [_rand(r, 3, 2) * 0.5], "H0": [_rand(r, 3, 2)],
        "C0": [_rand(r, 3, 3)]}, {},
        ["Projection", "Cell", "LastH", "LastC"], MATMUL),
    "cudnn_lstm": ("cudnn_lstm", lambda r: {
        "Input": [_rand(r, 2, 4, 3)], "W": [_cudnn_w(r, 3, 5, 1, 1)]},
        {"hidden_size": 5, "num_layers": 1}, ["Out", "LastH", "LastC"],
        MATMUL),
    "cudnn_lstm_2layer_bidirec_init": ("cudnn_lstm", lambda r: {
        "Input": [_rand(r, 3, 5, 4)], "W": [_cudnn_w(r, 4, 3, 2, 2)],
        "InitH": [_rand(r, 4, 3, 3)], "InitC": [_rand(r, 4, 3, 3)]},
        {"hidden_size": 3, "num_layers": 2, "is_bidirec": True},
        ["Out", "LastH", "LastC"], MATMUL),
    # CTC and chunks
    "warpctc": ("warpctc", lambda r: _ctc_ins(r), {}, ["Loss"], MATMUL),
    # frozen rows (LogitsLength < T), an empty label, LabelLength < S
    "warpctc_lengths_empty_label": ("warpctc", lambda r: _ctc_ins(
        r, logits_len=(9, 4, 6, 7), label_len=(3, 0, 2, 1)),
        {"norm_by_times": True}, ["Loss"], MATMUL),
    # no LabelLength: the labels' lengths count entries >= 0, not blank
    "warpctc_padded_labels_blank2": ("warpctc", lambda r: _ctc_ins(
        r, label=np.array([[[1], [3], [-1]], [[0], [4], [4]], [[-1], [-1],
                                                          [-1]],
                           [[3], [1], [1]]], "int64")),
        {"blank": 2}, ["Loss"], MATMUL),
    "ctc_align_runs_blanks": ("ctc_align", lambda r: {
        "Input": [np.array([[0, 1, 1, 0, 1, 2, 2, 0], [0, 0, 0, 0, 0, 0, 0,
                                                        0],
                            [3, 3, 3, 1, 0, 0, 1, 3]], "int64")]}, {},
        ["Output"], SAME),
    "ctc_align_blank2_pad": ("ctc_align", lambda r: {
        "Input": [_i64(r, 3, 7, 1, hi=4)]},
        {"blank": 2, "padding_value": -1}, ["Output"], SAME),
    "chunk_eval": ("chunk_eval", lambda r: {
        "Inference": [_i64(r, 2, 9, hi=5)], "Label": [_i64(r, 2, 9, hi=5)]},
        {"num_chunk_types": 2}, _CHUNK_OUT, EXACT),
    "chunk_eval_excluded_mask": ("chunk_eval", lambda r: {
        "Inference": [_i64(r, 3, 8, 1, hi=7)],
        "Label": [_i64(r, 3, 8, 1, hi=7)], "Mask": [_mask(r, 3, 8)]},
        {"num_chunk_types": 3, "excluded_chunk_types": [1]}, _CHUNK_OUT,
        EXACT),
    "chunk_eval_planted": ("chunk_eval", lambda r: {
        "Inference": [np.array([[0, 1, 1, 4, 2, 3, 1, 0]], "int64")],
        "Label": [np.array([[0, 1, 1, 4, 2, 3, 4, 0]], "int64")]},
        {"num_chunk_types": 2}, _CHUNK_OUT, EXACT),
    # sampling: a zero row of X puts z = 0 in the cross entropy
    "hierarchical_sigmoid": ("hierarchical_sigmoid", lambda r: {
        "X": [_zero_rows(_rand(r, 3, 4), 1)], "W": [_rand(r, 7, 4)],
        "Label": [_i64(r, 3, hi=8)]}, {"num_classes": 8},
        ["Out", "PreOut"], MATMUL),
    "hierarchical_sigmoid_6_bias": ("hierarchical_sigmoid", lambda r: {
        "X": [_rand(r, 5, 4)], "W": [_rand(r, 5, 4)],
        "Label": [np.array([[0], [5], [3], [4], [1]], "int64")],
        "Bias": [_rand(r, 5)]}, {"num_classes": 6}, ["Out", "PreOut"],
        MATMUL),
    # hard labels at z = 0, soft ones at the clip's bounds and beyond
    "teacher_student_planted": ("teacher_student_sigmoid_loss", lambda r: {
        "X": [np.array([[0.0], [0.0], [15.0], [-15.0], [20.0], [-3.0],
                        [0.7], [2.0]], "float32")],
        "Label": [np.array([[0.0], [1.0], [0.3], [0.6], [0.9], [0.0],
                            [1.0], [0.5]], "float32")]},
        {"soft_max_up_bound": 15.0, "soft_max_lower_bound": -15.0}, ["Y"],
        EXACT),
    "teacher_student_sigmoid_loss": ("teacher_student_sigmoid_loss",
                                     lambda r: {
        "X": [_rand(r, 4, 1)], "Label": [r.rand(4, 1).astype("float32")]},
        {}, ["Y"], EXACT),
    "positive_negative_pair_ties": ("positive_negative_pair", lambda r: {
        "Score": [np.round(r.rand(8, 1) * 3).astype("float32")],
        "Label": [_i64(r, 8, 1, hi=3).astype("float32")],
        "QueryID": [_i64(r, 8, 1, hi=2)]}, {},
        ["PositivePair", "NegativePair", "NeutralPair"], SAME),
    # selected rows and ids
    "unique": ("unique", lambda r: {"X": [_i64(r, 6, hi=4)]}, {},
               ["Out", "Index", "Count"], SAME),
    "unique_float": ("unique", lambda r: {
        "X": [np.array([1.5, -2.0, 1.5, 0.0, -2.0, 3.0], "float32")]}, {},
        ["Out", "Index", "Count"], SAME),
    "unique_with_counts": ("unique_with_counts", lambda r: {
        "X": [_i64(r, 9, hi=4)]}, {},
        ["Out", "Index", "Count", "UniqueCount"], SAME),
    "hash": ("hash", lambda r: {"X": [_i64(r, 4, 2, hi=100)]},
             {"num_hash": 2, "mod_by": 1000}, ["Out"], SAME),
    "hash_wide_ids": ("hash", lambda r: {
        "X": [np.array([[2**31 + 7, 5, 9], [-5, 2**32 + 3, 0],
                        [123456789, -1, 2**40 + 11]], "int64")]},
        {"num_hash": 3, "mod_by": 100003}, ["Out"], SAME),
    "lookup_sparse_table": ("lookup_sparse_table", lambda r: {
        "W": [_rand(r, 10, 4)], "Ids": [_i64(r, 5)]}, {}, ["Out"], SAME),
    "split_ids_negative": ("split_ids", lambda r: {
        "Ids": [np.array([5, -3, 0, 17, -8, 2], "int64")]},
        {"num_shards": 3}, ["Out"], SAME),
    "merge_ids": ("merge_ids", lambda r: {
        "X": [_rand(r, 4, 2), _rand(r, 4, 2)]}, {}, ["Out"], SAME),
    "merge_selected_rows_repeats": ("merge_selected_rows", lambda r: {
        "Ids": [np.array([3, 1, 3, 3, 0, 1], "int64")],
        "Values": [_rand(r, 6, 2)]}, {}, ["OutIds", "Out"], EXACT),
    "split_selected_rows": ("split_selected_rows", lambda r: {
        "Ids": [_i64(r, 6, hi=10)], "Values": [_rand(r, 6, 2)]},
        {"height_sections": [4, 6]}, ["OutIds", "Out"], SAME),
    # -1 (the shards' pad) and 6 (past height) add nothing; 2 repeats
    "get_tensor_from_selected_rows_planted": (
        "get_tensor_from_selected_rows", lambda r: {
            "Ids": [np.array([2, -1, 6, 2, 0], "int64")],
            "Values": [_rand(r, 5, 3)]}, {"height": 6}, ["Out"], EXACT),
    # vision
    "affine_channel": ("affine_channel", lambda r: {
        "X": [_rand(r, 2, 3, 2, 2)], "Scale": [_rand(r, 3)],
        "Bias": [_rand(r, 3)]}, {}, ["Out"], EXACT),
    "im2sequence": ("im2sequence", lambda r: {"X": [_rand(r, 1, 1, 4, 4)]},
                    {"kernels": [2, 2], "strides": [2, 2],
                     "paddings": [0, 0, 0, 0]}, ["Out"], SAME),
    "im2sequence_padded_per_example": ("im2sequence", lambda r: {
        "X": [_rand(r, 2, 3, 5, 4)]},
        {"kernels": [3, 2], "strides": [1, 2], "paddings": [1, 0, 1, 1],
         "per_example": True}, ["Out"], SAME),
    # coordinates past the edges and on the pixel grid (x = 0, +-1)
    "grid_sampler": ("grid_sampler", lambda r: {
        "X": [_rand(r, 1, 2, 4, 4)], "Grid": [_rand(r, 1, 3, 3, 2) * 0.4]},
        {}, ["Output"], EXACT),
    "grid_sampler_edges": ("grid_sampler", lambda r: {
        "X": [_rand(r, 2, 3, 5, 4)],
        "Grid": [np.concatenate([_rand(r, 2, 3, 4, 2) * 1.3, np.tile(
            np.array([0.0, 1.0, -1.0, 1 / 3], "float32")[None, None, :,
                                                          None],
            (2, 1, 1, 2))], axis=1)]}, {}, ["Output"], EXACT),
    "pad3d": ("pad3d", lambda r: {"X": [_rand(r, 1, 2, 3, 3, 3)]},
              {"paddings": [1, 0, 2, 1, 0, 2], "value": 0.5}, ["Out"],
              SAME),
    "shuffle_channel": ("shuffle_channel", lambda r: {
        "X": [_rand(r, 2, 6, 2, 3)]}, {"group": 3}, ["Out"], SAME),
    "similarity_focus_ties": ("similarity_focus", lambda r: {
        "X": [np.round(r.rand(2, 3, 3, 4) * 2).astype("float32")]},
        {"axis": 1, "indexes": [0, 2]}, ["Out"], SAME),
    "similarity_focus_axis2": ("similarity_focus", lambda r: {
        "X": [_rand(r, 2, 3, 4, 5)]}, {"axis": 2, "indexes": [1]}, ["Out"],
        SAME),
    "spp_max": ("spp", lambda r: {"X": [_rand(r, 2, 2, 7, 5)]},
                {"pyramid_height": 3}, ["Out"], SAME),
    "spp_avg": ("spp", lambda r: {"X": [_rand(r, 1, 2, 4, 4)]},
                {"pyramid_height": 2, "pooling_type": "avg"}, ["Out"],
                EXACT),
    # a repeated index sums, -1 wraps to the last cell, 16 is dropped
    "unpool_planted": ("unpool", lambda r: {
        "X": [_rand(r, 1, 2, 2, 2)],
        "Indices": [np.array([[[[0, 3], [12, 15]], [[5, 5], [-1, 16]]]],
                             "int64")]},
        {"unpooled_height": 4, "unpooled_width": 4}, ["Out"], EXACT),
    "scale_sub_region": ("scale_sub_region", lambda r: {
        "X": [_rand(r, 2, 3, 4, 4)],
        "Indices": [np.array([[1, 2, 2, 3, 1, 4], [3, 3, 1, 1, 2, 2]],
                             "int64")]}, {"value": 2.5}, ["Out"], SAME),
    # host ops
    "fill": ("fill", lambda r: {}, {"shape": [2, 2], "dtype": "float32",
                                    "value": [1.0, 2.0, 3.0, 4.0]},
             ["Out"], SAME),
    "fill_int32": ("fill", lambda r: {}, {"shape": [3], "dtype": "int32",
                                          "value": [7, -1, 2]}, ["Out"],
                   SAME),
    "print": ("print", lambda r: {"X": [_rand(r, 2, 2)]},
              {"message": "sweep: "}, ["Out"], SAME),
    "delete_var": ("delete_var", lambda r: {"X": [_rand(r, 2, 2)]}, {}, [],
                   SAME),
}
for _name in SEQ_PLANE_CASES:
    assert _name not in SEQ_CASES, _name
SEQ_CASES.update(SEQ_PLANE_CASES)



def _ties(r, *shape):
    """Small integers: every window of the index pools holds ties."""
    return np.round(r.rand(*shape) * 3).astype("float32")


# the rest of the conv family (slice 23): test_op_sweep.py's shapes
# (:376-411, :833-888) first, then grouped, dilated, strided and padded
# variants; CONV where the op sums, SAME for the index pools (no
# arithmetic; the Mask holds JAX's tie order: the first maximum in window
# order) and max pooling
CONV_EXTRA_CASES = {
    "conv3d_sweep": ("conv3d", lambda r: {
        "Input": [_rand(r, 1, 2, 4, 4, 4)],
        "Filter": [_rand(r, 3, 2, 2, 2, 2)]}, {}, ["Output"], CONV),
    "conv3d_pad_stride_dilation": ("conv3d", lambda r: {
        "Input": [_rand(r, 2, 2, 6, 7, 8)],
        "Filter": [_rand(r, 4, 2, 3, 2, 3)]},
        {"strides": [2, 1, 2], "paddings": [1, 0, 2],
         "dilations": [1, 2, 1]}, ["Output"], CONV),
    "conv3d_groups_same": ("conv3d", lambda r: {
        "Input": [_rand(r, 2, 4, 5, 6, 7)],
        "Filter": [_rand(r, 6, 2, 3, 3, 2)]},
        {"strides": [2, 1, 2], "paddings": "SAME", "groups": 2},
        ["Output"], CONV),
    "conv2d_transpose_sweep": ("conv2d_transpose", lambda r: {
        "Input": [_rand(r, 1, 2, 4, 4)],
        "Filter": [_rand(r, 2, 3, 3, 3)]}, {}, ["Output"], CONV),
    "conv2d_transpose_stride_pad": ("conv2d_transpose", lambda r: {
        "Input": [_rand(r, 2, 4, 5, 6)],
        "Filter": [_rand(r, 4, 3, 4, 4)]},
        {"strides": [2, 2], "paddings": [1, 1]}, ["Output"], CONV),
    # a padding past k_eff - 1: JAX's pad k_eff - 1 - p is negative
    "conv2d_transpose_wide_pad_dilated": ("conv2d_transpose", lambda r: {
        "Input": [_rand(r, 2, 4, 6, 7)],
        "Filter": [_rand(r, 4, 3, 3, 3)]},
        {"strides": [2, 1], "paddings": [3, 2], "dilations": [1, 2]},
        ["Output"], CONV),
    "conv2d_transpose_groups": ("conv2d_transpose", lambda r: {
        "Input": [_rand(r, 2, 4, 5, 6)],
        "Filter": [_rand(r, 4, 3, 3, 2)]},
        {"strides": [2, 3], "paddings": [0, 1], "groups": 2},
        ["Output"], CONV),
    "depthwise_conv2d_transpose_sweep": ("depthwise_conv2d_transpose",
                                         lambda r: {
        "Input": [_rand(r, 1, 3, 5, 5)],
        "Filter": [_rand(r, 3, 1, 2, 2)]},
        {"strides": 2, "paddings": 0}, ["Output"], CONV),
    "depthwise_conv2d_transpose_multiplier": ("depthwise_conv2d_transpose",
                                              lambda r: {
        "Input": [_rand(r, 2, 3, 5, 6)],
        "Filter": [_rand(r, 3, 2, 3, 3)]},
        {"strides": [2, 2], "paddings": [1, 1]}, ["Output"], CONV),
    "conv3d_transpose_sweep": ("conv3d_transpose", lambda r: {
        "Input": [_rand(r, 1, 2, 3, 3, 3)],
        "Filter": [_rand(r, 2, 3, 2, 2, 2)]}, {}, ["Output"], CONV),
    "conv3d_transpose_stride_pad": ("conv3d_transpose", lambda r: {
        "Input": [_rand(r, 2, 3, 4, 5, 3)],
        "Filter": [_rand(r, 3, 2, 3, 2, 3)]},
        {"strides": [2, 1, 2], "paddings": [1, 0, 1]}, ["Output"], CONV),
    "pool3d_sweep_avg": ("pool3d", lambda r: {"X": [_rand(r, 1, 2, 4, 4, 4)]},
                         {"ksize": [2, 2, 2], "pooling_type": "avg"},
                         ["Out"], CONV),
    "pool3d_default_window_max": ("pool3d", lambda r: {
        "X": [_rand(r, 2, 3, 5, 6, 4)]}, {"pooling_type": "max"},
        ["Out"], SAME),
    "pool3d_max_pad_ceil": ("pool3d", lambda r: {
        "X": [_rand(r, 2, 2, 5, 7, 6)]},
        {"pooling_type": "max", "ksize": 3, "strides": 2, "paddings": 1,
         "ceil_mode": True}, ["Out"], SAME),
    "pool3d_avg_pad_excl": ("pool3d", lambda r: {
        "X": [_rand(r, 2, 2, 5, 7, 6)]},
        {"pooling_type": "avg", "ksize": [3, 2, 3], "strides": [2, 1, 2],
         "paddings": [1, 1, 0]}, ["Out"], CONV),
    "pool3d_avg_incl_ceil": ("pool3d", lambda r: {
        "X": [_rand(r, 1, 3, 5, 5, 5)]},
        {"pooling_type": "avg", "ksize": 2, "strides": 2, "paddings": 1,
         "exclusive": False, "ceil_mode": True}, ["Out"], CONV),
    "pool3d_global_avg": ("pool3d", lambda r: {
        "X": [_rand(r, 2, 3, 3, 4, 5)]},
        {"pooling_type": "avg", "global_pooling": True}, ["Out"], CONV),
    "pool2d_with_index_sweep": ("pool2d_with_index", lambda r: {
        "X": [_rand(r, 1, 2, 4, 4)]}, {"ksize": [2, 2]}, ["Out", "Mask"],
        SAME),
    "pool2d_with_index_ties_pad": ("pool2d_with_index", lambda r: {
        "X": [_ties(r, 2, 3, 7, 8)]},
        {"ksize": 3, "strides": 2, "paddings": 1}, ["Out", "Mask"], SAME),
    "pool2d_with_index_all_equal": ("pool2d_with_index", lambda r: {
        "X": [np.full((1, 2, 5, 5), 2.0, "float32")]},
        {"ksize": [3, 2], "strides": [1, 2], "paddings": [1, 0]},
        ["Out", "Mask"], SAME),
    "max_pool2d_with_index_sweep": ("max_pool2d_with_index", lambda r: {
        "X": [_rand(r, 2, 3, 8, 8)]}, {"ksize": 2, "strides": 2},
        ["Out", "Mask"], SAME),
    "max_pool2d_with_index_ties_stem": ("max_pool2d_with_index", lambda r: {
        "X": [_ties(r, 2, 4, 12, 12)]},
        {"ksize": 3, "strides": 2, "paddings": 1}, ["Out", "Mask"], SAME),
    "max_pool3d_with_index_sweep": ("max_pool3d_with_index", lambda r: {
        "X": [_rand(r, 1, 2, 4, 4, 4)]}, {"ksize": 2, "strides": 2},
        ["Out", "Mask"], SAME),
    # XLA visits a window row-major, but for the last dim with a window
    # of 2 and a padding of 1, which it visits first: ties planted for
    # each order
    "max_pool3d_with_index_ties_pad": ("max_pool3d_with_index", lambda r: {
        "X": [_ties(r, 2, 2, 5, 6, 7)]},
        {"ksize": [2, 3, 2], "strides": [2, 2, 1], "paddings": [0, 1, 1]},
        ["Out", "Mask"], SAME),
    "max_pool3d_with_index_ties_k2p1_middle": ("max_pool3d_with_index",
                                               lambda r: {
        "X": [_ties(r, 2, 2, 5, 6, 7)]},
        {"ksize": [2, 2, 3], "strides": 1, "paddings": [1, 1, 1]},
        ["Out", "Mask"], SAME),
    "pool2d_with_index_ties_k2p1_last": ("pool2d_with_index", lambda r: {
        "X": [_ties(r, 2, 3, 7, 8)]},
        {"ksize": [3, 2], "strides": [2, 1], "paddings": [1, 1]},
        ["Out", "Mask"], SAME),
    "pool2d_with_index_ties_k2p1_both": ("pool2d_with_index", lambda r: {
        "X": [_ties(r, 2, 3, 6, 7)]},
        {"ksize": 2, "strides": 1, "paddings": 1}, ["Out", "Mask"], SAME),
    "group_norm_sweep": ("group_norm", lambda r: {
        "X": [_rand(r, 2, 4, 3, 3)], "Scale": [_rand(r, 4)],
        "Bias": [_rand(r, 4)]}, {"groups": 2},
        ["Y", "Mean", "Variance"], CONV),
    "group_norm_no_affine_3d": ("group_norm", lambda r: {
        "X": [_rand(r, 3, 6, 2, 3, 4) * 3 + 1]},
        {"groups": 3, "epsilon": 1e-3}, ["Y", "Mean", "Variance"], CONV),
    "group_norm_g1": ("group_norm", lambda r: {
        "X": [_rand(r, 2, 5, 4, 4) * 2], "Scale": [_rand(r, 5)]},
        {"groups": 1}, ["Y", "Mean", "Variance"], CONV),
    "instance_norm_sweep": ("instance_norm", lambda r: {
        "X": [_rand(r, 2, 3, 4, 4)]}, {}, ["Y"], CONV),
    "instance_norm_affine": ("instance_norm", lambda r: {
        "X": [_rand(r, 3, 4, 5, 6) * 4 - 1], "Scale": [_rand(r, 4)],
        "Bias": [_rand(r, 4)]}, {"epsilon": 1e-3}, ["Y"], CONV),
    # the comparison and logical ops of While and Switch (bool out)
    "less_than_broadcast": ("less_than", lambda r: {
        "X": [r.randint(0, 3, (4, 5)).astype("float32")],
        "Y": [r.randint(0, 3, (5,)).astype("float32")]}, {"axis": -1},
        ["Out"], SAME),
    "less_equal_axis1": ("less_equal", lambda r: {
        "X": [r.randint(0, 3, (2, 3, 4)).astype("float32")],
        "Y": [r.randint(0, 3, (3,)).astype("float32")]}, {"axis": 1},
        ["Out"], SAME),
    "not_equal": ("not_equal", lambda r: {
        "X": [r.randint(0, 3, (4, 5)).astype("float32")],
        "Y": [r.randint(0, 3, (4, 5)).astype("float32")]}, {}, ["Out"],
        SAME),
    "logical_and": ("logical_and", lambda r: {
        "X": [r.rand(4, 5) < 0.5], "Y": [r.rand(4, 5) < 0.5]}, {},
        ["Out"], SAME),
    "logical_or_broadcast": ("logical_or", lambda r: {
        "X": [r.rand(4, 5) < 0.5], "Y": [r.rand(5) < 0.5]}, {}, ["Out"],
        SAME),
    "logical_xor": ("logical_xor", lambda r: {
        "X": [r.rand(4, 5) < 0.5], "Y": [r.rand(4, 5) < 0.5]}, {},
        ["Out"], SAME),
    "logical_not": ("logical_not", lambda r: {"X": [r.rand(3, 4) < 0.5]},
                    {}, ["Out"], SAME),
    # the binary ops the Variable operators build
    "pow": ("elementwise_pow", lambda r: {
        "X": [np.abs(_rand(r, 4, 5)) + 0.1], "Y": [_rand(r, 4, 5)]}, {},
        ["Out"], EXACT),
    "min_broadcast": ("elementwise_min", lambda r: {
        "X": [_rand(r, 2, 3, 4)], "Y": [_rand(r, 3, 1)]}, {"axis": 1},
        ["Out"], EXACT),
    "floordiv_signs": ("elementwise_floordiv", lambda r: {
        "X": [_rand(r, 4, 5) * 7],
        "Y": [np.where(r.rand(4, 5) < 0.5, -1.0, 1.0).astype("float32")
              * (1.5 + r.rand(4, 5).astype("float32"))]}, {}, ["Out"],
        EXACT),
    "increment_loop_counter": ("increment_loop_counter", lambda r: {
        "X": [np.array([41], "int64")]}, {"step": 1}, ["Out"], SAME),
    "lr_schedule_noam": ("lr_schedule", lambda r: {
        "Step": [np.array([3000], "int64")]},
        {"kind": "noam", "d_model": 512, "warmup_steps": 4000}, ["Out"],
        dict(rtol=1e-6, atol=0)),
    "lr_schedule_piecewise": ("lr_schedule", lambda r: {
        "Step": [np.array([4], "int64")]},
        {"kind": "piecewise", "boundaries": [2, 4],
         "values": [0.1, 0.01, 0.001]}, ["Out"], dict(rtol=1e-6, atol=0)),
}


# the dense op plane (slice 25): test_op_sweep.py's shapes (:54-330,
# :481-579) first, then the kinks, ties and modes where the port could
# part from JAX planted.  Pointwise math, reductions and losses at EXACT
# (MATMUL where a product sums), movement, index and integer ops SAME
def _planted(r, shape, points, scale=1.0):
    """Seeded normals with `points` planted at the first entries."""
    x = (r.randn(*shape) * scale).astype("float32")
    flat = x.reshape(-1)
    flat[:len(points)] = points
    return x


def _unary_case(op, points=(0.0,), attrs=None, positive=False, scale=0.8,
                shape=(2, 6), tol=EXACT):
    def build(r):
        x = _planted(r, shape, points, scale)
        return {"X": [np.abs(x) + 0.5 if positive else x]}
    return (op, build, attrs or {}, ["Out"], tol)


def _tied_rows(r, rows, cols):
    """Rows of small integers, so that most rows hold ties."""
    return r.randint(0, 3, (rows, cols)).astype("float32")


DENSE_CASES = {
    # activation.py's unary functors, each kink planted
    "act_abs": _unary_case("abs"),
    "act_ceil": _unary_case("ceil", (0.5, -0.5, 1.0, -2.0)),
    "act_floor": _unary_case("floor", (0.5, -0.5, 1.0, -2.0)),
    "act_round_half_even": _unary_case("round", (0.5, 1.5, 2.5, -0.5,
                                                 -1.5), scale=3.0),
    "act_cos": _unary_case("cos"),
    "act_sin": _unary_case("sin"),
    "act_exp": _unary_case("exp"),
    "act_erf": _unary_case("erf"),
    "act_log": _unary_case("log", (), positive=True),
    "act_rsqrt": _unary_case("rsqrt", (), positive=True),
    "act_reciprocal": _unary_case("reciprocal", (), positive=True),
    "act_logsigmoid": _unary_case("logsigmoid", (0.0, 30.0, -30.0)),
    "act_tanh_shrink": _unary_case("tanh_shrink"),
    "act_softplus": _unary_case("softplus", (0.0, 30.0, -30.0)),
    "act_softsign": _unary_case("softsign"),
    "act_brelu": _unary_case("brelu", (-1.0, 1.0, 0.0),
                             {"t_min": -1.0, "t_max": 1.0}),
    "act_brelu_default": _unary_case("brelu", (0.0, 24.0), scale=10.0),
    "act_leaky_relu": _unary_case("leaky_relu", (0.0,), {"alpha": 0.1}),
    "act_soft_relu": _unary_case("soft_relu", (-1.0, 1.0, 0.0),
                                 {"threshold": 1.0}),
    "act_soft_relu_default": _unary_case("soft_relu", (40.0, -40.0),
                                         scale=20.0),
    "act_elu": _unary_case("elu", (0.0,), {"alpha": 0.7}),
    "act_relu6": _unary_case("relu6", (0.0, 6.0), scale=4.0),
    "act_relu6_threshold": _unary_case("relu6", (0.0, 2.0),
                                       {"threshold": 2.0}, scale=2.0),
    "act_pow2": _unary_case("pow", (0.0,), {"factor": 2.0}),
    "act_pow_frac": _unary_case("pow", (), {"factor": 1.5}, positive=True),
    "act_stanh": _unary_case("stanh", (0.0,), {"scale_a": 0.5,
                                               "scale_b": 2.0}),
    "act_hard_shrink": _unary_case("hard_shrink", (0.5, -0.5, 0.0),
                                   {"threshold": 0.5}),
    "act_softshrink": _unary_case("softshrink", (0.3, -0.3, 0.0),
                                  {"lambda": 0.3}),
    "act_hard_sigmoid": _unary_case("hard_sigmoid", (-2.5, 2.5, 0.0),
                                    scale=3.0),
    "act_swish": _unary_case("swish", (0.0,), {"beta": 1.5}),
    "act_hard_swish": _unary_case("hard_swish", (-3.0, 3.0, 0.0),
                                  scale=4.0),
    "act_mish": _unary_case("mish"),
    "act_thresholded_relu": _unary_case("thresholded_relu", (0.3, -0.3),
                                        {"threshold": 0.3}),
    "act_selu": _unary_case("selu"),
    "prelu_all": ("prelu", lambda r: {
        "X": [_planted(r, (2, 6), (0.0,))],
        "Alpha": [np.array([0.1], "float32")]}, {"mode": "all"}, ["Out"],
        EXACT),
    "prelu_channel": ("prelu", lambda r: {
        "X": [_planted(r, (2, 3, 4, 4), (0.0,))],
        "Alpha": [_rand(r, 3) * 0.2]}, {"mode": "channel"}, ["Out"], EXACT),
    "prelu_element": ("prelu", lambda r: {
        "X": [_rand(r, 2, 3, 4)], "Alpha": [_rand(r, 12) * 0.2]},
        {"mode": "element"}, ["Out"], EXACT),
    "maxout_sweep": ("maxout", lambda r: {"X": [_rand(r, 2, 8, 3, 3)]},
                     {"groups": 2}, ["Out"], SAME),
    "maxout_ties": ("maxout", lambda r: {
        "X": [_tied_rows(r, 2 * 6, 9).reshape(2, 6, 3, 3)]},
        {"groups": 3}, ["Out"], SAME),
    # tensor_manip.py
    "reshape2": ("reshape2", lambda r: {"X": [_rand(r, 2, 6)]},
                 {"shape": [0, 3, -1]}, ["Out", "XShape"], SAME),
    "transpose2": ("transpose2", lambda r: {"X": [_rand(r, 2, 3, 4)]},
                   {"axis": [0, 2, 1]}, ["Out", "XShape"], SAME),
    "squeeze2": ("squeeze2", lambda r: {"X": [_rand(r, 2, 1, 4)]},
                 {"axes": [1]}, ["Out", "XShape"], SAME),
    "unsqueeze2": ("unsqueeze2", lambda r: {"X": [_rand(r, 2, 4)]},
                   {"axes": [1, 3]}, ["Out", "XShape"], SAME),
    "stack_axis1": ("stack", lambda r: {"X": [_rand(r, 2, 3),
                                              _rand(r, 2, 3),
                                              _rand(r, 2, 3)]},
                    {"axis": 1}, ["Y"], SAME),
    "unstack_axis1": ("unstack", lambda r: {"X": [_rand(r, 2, 3, 4)]},
                      {"axis": 1}, ["Y"], SAME),
    "unbind": ("unbind", lambda r: {"X": [_rand(r, 2, 3)]}, {"axis": 0},
               ["Y"], SAME),
    "flatten": ("flatten", lambda r: {"X": [_rand(r, 2, 3, 4)]},
                {"axis": 2}, ["Out"], SAME),
    "flatten_axis0": ("flatten", lambda r: {"X": [_rand(r, 2, 3, 4)]},
                      {"axis": 0}, ["Out"], SAME),
    "flatten2": ("flatten2", lambda r: {"X": [_rand(r, 2, 3, 4)]},
                 {"axis": 1}, ["Out", "XShape"], SAME),
    "flatten_contiguous_range": ("flatten_contiguous_range", lambda r: {
        "X": [_rand(r, 2, 3, 4, 5)]}, {"start_axis": 1, "stop_axis": -2},
        ["Out"], SAME),
    "expand_as": ("expand_as", lambda r: {"X": [_rand(r, 1, 3)],
                                          "Y": [_rand(r, 4, 3)]}, {},
                  ["Out"], SAME),
    "expand_as_target_tensor": ("expand_as", lambda r: {
        "X": [_rand(r, 2, 1, 3)], "target_tensor": [_rand(r, 2, 5, 3)]},
        {}, ["Out"], SAME),
    "tile": ("tile", lambda r: {"X": [_rand(r, 1, 3)]},
             {"repeat_times": [2, 2]}, ["Out"], SAME),
    "strided_slice": ("strided_slice", lambda r: {"Input": [_rand(r, 4, 6)]},
                      {"axes": [1], "starts": [0], "ends": [6],
                       "strides": [2]}, ["Out"], SAME),
    "strided_slice_negative": ("strided_slice", lambda r: {
        "Input": [_rand(r, 5, 7, 3)]},
        {"axes": [0, 1], "starts": [4, -2], "ends": [0, 1],
         "strides": [-2, -1]}, ["Out"], SAME),
    "gather_nd": ("gather_nd", lambda r: {
        "X": [_rand(r, 3, 4)], "Index": [r.randint(0, 3, (2, 2))]}, {},
        ["Out"], SAME),
    "gather_nd_partial": ("gather_nd", lambda r: {
        "X": [_rand(r, 3, 4, 5)],
        "Index": [np.array([[[0], [2]], [[1], [1]]], "int64")]}, {},
        ["Out"], SAME),
    "scatter_overwrite": ("scatter", lambda r: {
        "X": [_rand(r, 5, 3)], "Ids": [np.array([3, 1], "int64")],
        "Updates": [_rand(r, 2, 3)]}, {}, ["Out"], SAME),
    # a repeated id keeps its last update, as XLA's in-order scatter
    "scatter_overwrite_repeats": ("scatter", lambda r: {
        "X": [_rand(r, 6, 3)],
        "Ids": [np.array([[0], [0], [2], [5], [2], [0]], "int64")],
        "Updates": [_rand(r, 6, 3)]}, {"overwrite": True}, ["Out"], SAME),
    "scatter_add_repeats": ("scatter", lambda r: {
        "X": [_rand(r, 5, 3)], "Ids": [np.array([1, 4, 1, 1], "int64")],
        "Updates": [_rand(r, 4, 3)]}, {"overwrite": False}, ["Out"],
        EXACT),
    "scatter_nd_add": ("scatter_nd_add", lambda r: {
        "X": [_rand(r, 5, 3)], "Index": [np.array([[1], [3], [1]], "int64")],
        "Updates": [_rand(r, 3, 3)]}, {}, ["Out"], EXACT),
    "scatter_nd_add_2d_index": ("scatter_nd_add", lambda r: {
        "X": [_rand(r, 4, 5)],
        "Index": [np.array([[[0, 1], [3, 4]], [[0, 1], [2, 2]]], "int64")],
        "Updates": [_rand(r, 2, 2)]}, {}, ["Out"], EXACT),
    "pad": ("pad", lambda r: {"X": [_rand(r, 2, 3)]},
            {"paddings": [1, 1, 0, 2], "pad_value": 0.5}, ["Out"], SAME),
    "pad2d_constant": ("pad2d", lambda r: {"X": [_rand(r, 1, 2, 3, 3)]},
                       {"paddings": [1, 0, 2, 1], "pad_value": -1.0},
                       ["Out"], SAME),
    "pad2d_reflect": ("pad2d", lambda r: {"X": [_rand(r, 2, 2, 4, 5)]},
                      {"paddings": [2, 1, 1, 3], "mode": "reflect"},
                      ["Out"], SAME),
    "pad2d_edge": ("pad2d", lambda r: {"X": [_rand(r, 2, 2, 4, 5)]},
                   {"paddings": [1, 2, 3, 0], "mode": "edge"}, ["Out"],
                   SAME),
    "pad_constant_like": ("pad_constant_like", lambda r: {
        "X": [_rand(r, 4, 5)], "Y": [_rand(r, 2, 3)]}, {"pad_value": 0.5},
        ["Out"], SAME),
    "crop": ("crop", lambda r: {"X": [_rand(r, 4, 5)]},
             {"offsets": [1, 1], "shape": [2, 3]}, ["Out"], SAME),
    "crop_keep_batch": ("crop", lambda r: {"X": [_rand(r, 4, 5, 6)]},
                        {"offsets": [0, 2, 1], "shape": [-1, 2, 4]},
                        ["Out"], SAME),
    "reverse": ("reverse", lambda r: {"X": [_rand(r, 3, 4)]},
                {"axis": [0]}, ["Out"], SAME),
    "flip_two_axes": ("flip", lambda r: {"X": [_rand(r, 3, 4, 2)]},
                      {"axis": [1, 2]}, ["Out"], SAME),
    "roll": ("roll", lambda r: {"X": [_rand(r, 3, 4)]},
             {"shifts": [1], "axis": [1]}, ["Out"], SAME),
    "roll_two_axes": ("roll", lambda r: {"X": [_rand(r, 3, 4)]},
                      {"shifts": [-1, 5], "axis": [0, 1]}, ["Out"], SAME),
    "multiplex": ("multiplex", lambda r: {
        "Ids": [r.randint(0, 3, (4, 1))],
        "X": [_rand(r, 4, 3), _rand(r, 4, 3), _rand(r, 4, 3)]}, {},
        ["Out"], SAME),
    "where": ("where", lambda r: {
        "Condition": [r.rand(2, 3) < 0.5], "X": [_rand(r, 2, 3)],
        "Y": [_rand(r, 2, 3)]}, {}, ["Out"], SAME),
    "where_index": ("where_index", lambda r: {
        "Condition": [r.rand(3, 4) < 0.4]}, {}, ["Out"], SAME),
    "where_index_1d_none": ("where_index", lambda r: {
        "Condition": [np.zeros(4, bool)]}, {}, ["Out"], SAME),
    "space_to_depth": ("space_to_depth", lambda r: {
        "X": [_rand(r, 2, 3, 4, 6)]}, {"blocksize": 2}, ["Out"], SAME),
    "pixel_shuffle": ("pixel_shuffle", lambda r: {
        "X": [_rand(r, 1, 8, 3, 3)]}, {"upscale_factor": 2}, ["Out"], SAME),
    "is_empty": ("is_empty", lambda r: {"X": [_rand(r, 2, 3)]}, {},
                 ["Out"], SAME),
    "is_empty_true": ("is_empty", lambda r: {
        "X": [np.zeros((0, 3), "float32")]}, {}, ["Out"], SAME),
    "shard_index": ("shard_index", lambda r: {
        "X": [r.randint(0, 16, (6, 1))]},
        {"index_num": 16, "nshards": 3, "shard_id": 1, "ignore_value": -1},
        ["Out"], SAME),
    # reduce_ops.py: the first index of a tie, a stable sort
    "arg_max_ties": ("arg_max", lambda r: {"X": [_tied_rows(r, 6, 5)]},
                     {"axis": 1}, ["Out"], SAME),
    "arg_min_ties_axis0": ("arg_min", lambda r: {"X": [_tied_rows(r, 6, 5)]},
                           {"axis": 0}, ["Out"], SAME),
    "argsort": ("argsort", lambda r: {"X": [_rand(r, 3, 5)]}, {"axis": 1},
                ["Out", "Indices"], SAME),
    "argsort_ties": ("argsort", lambda r: {"X": [_tied_rows(r, 4, 7)]},
                     {"axis": -1}, ["Out", "Indices"], SAME),
    "argsort_ties_descending_axis0": ("argsort", lambda r: {
        "X": [_tied_rows(r, 7, 3)]}, {"axis": 0, "descending": True},
        ["Out", "Indices"], SAME),
    # math_ops.py
    "dot": ("dot", lambda r: {"X": [_rand(r, 3, 4)], "Y": [_rand(r, 3, 4)]},
            {}, ["Out"], EXACT),
    "minus": ("minus", lambda r: {"X": [_rand(r, 2, 6)],
                                  "Y": [_rand(r, 2, 6)]}, {}, ["Out"],
              EXACT),
    "clip_bounds": ("clip", lambda r: {
        "X": [_planted(r, (2, 6), (-0.5, 0.5, 0.0))]},
        {"min": -0.5, "max": 0.5}, ["Out"], EXACT),
    "cumsum": ("cumsum", lambda r: {"X": [_rand(r, 2, 5)]}, {"axis": 1},
               ["Out"], EXACT),
    "cumsum_exclusive_reverse": ("cumsum", lambda r: {
        "X": [_rand(r, 3, 4, 5)]},
        {"axis": 1, "exclusive": True, "reverse": True}, ["Out"], EXACT),
    "cumsum_flatten_exclusive": ("cumsum", lambda r: {
        "X": [_rand(r, 3, 4)]}, {"flatten": True, "exclusive": True},
        ["Out"], EXACT),
    "isfinite": ("isfinite", lambda r: {"X": [_rand(r, 2, 3)]}, {},
                 ["Out"], SAME),
    "isfinite_inf": ("isfinite", lambda r: {
        "X": [_planted(r, (2, 3), (np.inf,))]}, {}, ["Out"], SAME),
    "squared_l2_distance": ("squared_l2_distance", lambda r: {
        "X": [_rand(r, 4, 6)], "Y": [_rand(r, 4, 6)]}, {},
        ["Out", "sub_result"], EXACT),
    "l1_norm": ("l1_norm", lambda r: {"X": [_rand(r, 2, 6)]}, {}, ["Out"],
                EXACT),
    "norm": ("norm", lambda r: {"X": [_rand(r, 2, 6)]}, {"axis": 1},
             ["Out", "Norm"], EXACT),
    "norm_axis0_eps": ("norm", lambda r: {"X": [_rand(r, 3, 4, 2)]},
                       {"axis": 0, "epsilon": 1e-4}, ["Out", "Norm"],
                       EXACT),
    "bilinear_tensor_product": ("bilinear_tensor_product", lambda r: {
        "X": [_rand(r, 2, 3)], "Y": [_rand(r, 2, 4)],
        "Weight": [_rand(r, 5, 3, 4)]}, {}, ["Out"], MATMUL),
    "bilinear_tensor_product_bias": ("bilinear_tensor_product", lambda r: {
        "X": [_rand(r, 3, 3)], "Y": [_rand(r, 3, 4)],
        "Weight": [_rand(r, 5, 3, 4)], "Bias": [_rand(r, 1, 5)]}, {},
        ["Out"], MATMUL),
    # creation.py (the random ops are held by their distribution below)
    "fill_zeros_like": ("fill_zeros_like", lambda r: {"X": [_rand(r, 2, 3)]},
                        {}, ["Out"], SAME),
    "fill_any_like": ("fill_any_like", lambda r: {"X": [_rand(r, 2, 3)]},
                      {"value": 3.0}, ["Out"], SAME),
    "fill_any_like_dtype": ("fill_any_like", lambda r: {
        "X": [_rand(r, 2, 3)]}, {"value": 7.0, "dtype": "int32"}, ["Out"],
        SAME),
    "shape": ("shape", lambda r: {"Input": [_rand(r, 2, 3, 4)]}, {},
              ["Out"], SAME),
    "range": ("range", lambda r: {"Start": [np.zeros((1,), "float32")],
                                  "End": [np.full((1,), 5.0, "float32")],
                                  "Step": [np.ones((1,), "float32")]},
              {"len": 5}, ["Out"], SAME),
    "range_fractional": ("range", lambda r: {
        "Start": [np.full((1,), -1.5, "float32")],
        "End": [np.full((1,), 2.0, "float32")],
        "Step": [np.full((1,), 0.7, "float32")]}, {"len": 5}, ["Out"],
        SAME),
    "eye": ("eye", lambda r: {}, {"num_rows": 3, "dtype": "float32"},
            ["Out"], SAME),
    "eye_rect": ("eye", lambda r: {}, {"num_rows": 3, "num_columns": 5,
                                       "dtype": "float32"}, ["Out"], SAME),
    "linspace": ("linspace", lambda r: {}, {"start": 0.0, "stop": 1.0,
                                            "num": 5, "dtype": "float32"},
                 ["Out"], SAME),
    "linspace_wide": ("linspace", lambda r: {}, {"start": 0.0, "stop": 223.0,
                                                 "num": 57,
                                                 "dtype": "float32"},
                      ["Out"], SAME),
    # XLA's CPU code may fuse the add into an FMA: EXACT, not SAME
    "linspace_odd": ("linspace", lambda r: {}, {"start": -0.3, "stop": 7.1,
                                                "num": 13,
                                                "dtype": "float32"},
                     ["Out"], EXACT),
    "linspace_one": ("linspace", lambda r: {}, {"start": 2.0, "stop": 3.0,
                                                "num": 1,
                                                "dtype": "float32"},
                     ["Out"], SAME),
    # loss_ops.py
    "mse_loss": ("mse_loss", lambda r: {"X": [_rand(r, 4, 3)],
                                        "Label": [_rand(r, 4, 3)]}, {},
                 ["Out"], EXACT),
    "smooth_l1_loss": ("smooth_l1_loss", lambda r: {
        "X": [_rand(r, 4, 3)], "Y": [_rand(r, 4, 3)]}, {},
        ["Out", "Diff"], EXACT),
    "smooth_l1_loss_weights_sigma": ("smooth_l1_loss", lambda r: {
        "X": [_rand(r, 4, 2, 3)], "Y": [_rand(r, 4, 2, 3)],
        "InsideWeight": [np.abs(_rand(r, 4, 2, 3))],
        "OutsideWeight": [np.abs(_rand(r, 4, 2, 3))]}, {"sigma": 2.0},
        ["Out", "Diff"], EXACT),
    "huber_loss": ("huber_loss", lambda r: {
        "X": [_rand(r, 4, 1)], "Y": [_rand(r, 4, 1)]}, {"delta": 1.0},
        ["Out", "Residual"], EXACT),
    "huber_loss_at_delta": ("huber_loss", lambda r: {
        "X": [np.array([[0.0], [0.0], [1.0], [2.0]], "float32")],
        "Y": [np.array([[0.5], [-0.5], [0.0], [2.5]], "float32")]},
        {"delta": 0.5}, ["Out", "Residual"], EXACT),
    "log_loss": ("log_loss", lambda r: {
        "Predicted": [r.rand(4, 1).astype("float32") * 0.8 + 0.1],
        "Labels": [r.randint(0, 2, (4, 1)).astype("float32")]}, {},
        ["Loss"], EXACT),
    "hinge_loss": ("hinge_loss", lambda r: {
        "Logits": [_planted(r, (4, 1), (1.0, -1.0))],
        "Labels": [np.array([[1], [0], [1], [0]], "float32")]}, {},
        ["Loss"], EXACT),
    "modified_huber_loss": ("modified_huber_loss", lambda r: {
        "X": [_planted(r, (6, 1), (-1.0, 1.0, 3.0), 2.0)],
        "Y": [np.array([[1], [1], [0], [1], [0], [1]], "float32")]}, {},
        ["Out", "IntermediateVal"], EXACT),
    "bpr_loss": ("bpr_loss", lambda r: {
        "X": [np.abs(_rand(r, 3, 4)) + 0.1],
        "Label": [r.randint(0, 4, (3, 1))]}, {}, ["Y"], EXACT),
    "margin_rank_loss": ("margin_rank_loss", lambda r: {
        "X1": [_rand(r, 4, 1)], "X2": [_rand(r, 4, 1)],
        "Label": [np.sign(_rand(r, 4, 1))]}, {"margin": 0.1},
        ["Out", "Activated"], EXACT),
    "rank_loss": ("rank_loss", lambda r: {
        "Left": [_rand(r, 4, 1)], "Right": [_rand(r, 4, 1)],
        "Label": [r.randint(0, 2, (4, 1)).astype("float32")]}, {},
        ["Out"], EXACT),
    **{f"kldiv_loss_{red}": ("kldiv_loss", lambda r: {
        "X": [np.log(r.rand(3, 4).astype("float32") + 0.1)],
        "Target": [r.rand(3, 4).astype("float32")]}, {"reduction": red},
        ["Loss"], EXACT) for red in ("mean", "sum", "batchmean", "none")},
    # lax.abs's gradient is 1 at 0: the stable log1p(exp(-|x|)) term's
    "sigmoid_xent_zero_logits": ("sigmoid_cross_entropy_with_logits",
                                 lambda r: {
        "X": [_planted(r, (3, 4), (0.0, 0.0, 0.0))],
        "Label": [np.array([[1, 0, 0.3, 1], [0, 1, 1, 0], [1, 1, 0, 0]],
                           "float32")]}, {}, ["Out"], EXACT),
    "npair_loss": ("npair_loss", lambda r: {
        "Anchor": [_rand(r, 3, 4)], "Positive": [_rand(r, 3, 4)],
        "Labels": [np.array([0, 2, 0], "float32")]}, {}, ["Out"], MATMUL),
    # metric_ops.py: auc on a state already holding counts
    "auc": ("auc", lambda r: {
        "Predict": [r.rand(6, 2).astype("float32")],
        "Label": [r.randint(0, 2, (6, 1))],
        "StatPos": [np.zeros((4096,), "float32")],
        "StatNeg": [np.zeros((4096,), "float32")]}, {},
        ["AUC", "StatPosOut", "StatNegOut"], SAME),
    "auc_state_one_column": ("auc", lambda r: {
        "Predict": [np.concatenate([r.rand(40, 1), [[0.0], [1.0]]]).astype(
            "float32")],
        "Label": [r.randint(0, 2, (42, 1)).astype("float32")],
        "StatPos": [r.randint(0, 5, (101,)).astype("float32")],
        "StatNeg": [r.randint(0, 5, (101,)).astype("float32")]},
        {"num_thresholds": 100}, ["AUC", "StatPosOut", "StatNegOut"], SAME),
    "auc_one_class": ("auc", lambda r: {
        "Predict": [r.rand(5, 1).astype("float32")],
        "Label": [np.ones((5, 1), "int64")],
        "StatPos": [np.zeros((11,), "float32")],
        "StatNeg": [np.zeros((11,), "float32")]}, {"num_thresholds": 10},
        ["AUC", "StatPosOut", "StatNegOut"], SAME),
    "mean_iou": ("mean_iou", lambda r: {
        "Predictions": [r.randint(0, 3, (8,))],
        "Labels": [r.randint(0, 3, (8,))]}, {"num_classes": 3},
        ["OutMeanIou", "OutWrong", "OutCorrect"], EXACT),
    "mean_iou_absent_class": ("mean_iou", lambda r: {
        "Predictions": [r.randint(0, 3, (4, 5))],
        "Labels": [r.randint(0, 3, (4, 5))]}, {"num_classes": 5},
        ["OutMeanIou", "OutWrong", "OutCorrect"], EXACT),
    "precision_recall": ("precision_recall", lambda r: {
        "MaxProbs": [r.rand(4, 1).astype("float32")],
        "Indices": [r.randint(0, 2, (4, 1))],
        "Labels": [r.randint(0, 2, (4, 1))],
        "StatesInfo": [np.zeros((2, 3), "float32")]}, {"class_number": 2},
        ["BatchMetrics", "AccumMetrics", "AccumStatesInfo"], EXACT),
    "precision_recall_state": ("precision_recall", lambda r: {
        "Indices": [r.randint(0, 4, (9, 1))],
        "Labels": [r.randint(0, 4, (9, 1))],
        "StatesInfo": [r.randint(0, 6, (4, 3)).astype("float32")]}, {},
        ["BatchMetrics", "AccumMetrics", "AccumStatesInfo"], EXACT),
    "edit_distance": ("edit_distance", lambda r: {
        "Hyps": [r.randint(0, 5, (2, 4))], "Refs": [r.randint(0, 5, (2, 4))]},
        {}, ["Out", "SequenceNum"], SAME),
    "edit_distance_ragged_normalized": ("edit_distance", lambda r: {
        "Hyps": [r.randint(0, 3, (5, 7))], "Refs": [r.randint(0, 3, (5, 4))]},
        {"normalized": True}, ["Out", "SequenceNum"], SAME),
    "edit_distance_1d": ("edit_distance", lambda r: {
        "Hyps": [np.array([1, 2, 3, 4, 5], "int64")],
        "Refs": [np.array([2, 3, 5], "int64")]}, {}, ["Out"], SAME),
    "sequence_erase": ("sequence_erase", lambda r: {
        "X": [r.randint(0, 6, (3, 5))]}, {"tokens": [2, 5]}, ["Out"], SAME),
    # nn_ops.py: the resizes in each of JAX's modes; shrinking bilinear
    # without align_corners antialiases, as jax.image.resize does
    "interpolate_sweep": ("interpolate", lambda r: {
        "X": [_rand(r, 1, 2, 4, 4)]},
        {"out_h": 8, "out_w": 8, "interp_method": "bilinear"}, ["Out"],
        EXACT),
    "bilinear_interp": ("bilinear_interp", lambda r: {
        "X": [_rand(r, 2, 2, 5, 7)]}, {"out_h": 3, "out_w": 11}, ["Out"],
        EXACT),
    "bilinear_interp_scale": ("bilinear_interp", lambda r: {
        "X": [_rand(r, 1, 3, 4, 6)]}, {"scale": 1.5}, ["Out"], EXACT),
    "bilinear_no_align_up": ("bilinear_interp", lambda r: {
        "X": [_rand(r, 2, 2, 4, 5)]},
        {"out_h": 8, "out_w": 7, "align_corners": False}, ["Out"], EXACT),
    "bilinear_no_align_shrink_8_4": ("bilinear_interp", lambda r: {
        "X": [_rand(r, 2, 2, 8, 8)]},
        {"out_h": 4, "out_w": 5, "align_corners": False}, ["Out"], EXACT),
    "nearest_interp": ("nearest_interp", lambda r: {
        "X": [_rand(r, 1, 2, 4, 4)]}, {"out_h": 8, "out_w": 8}, ["Out"],
        SAME),
    "nearest_interp_shrink_8_5": ("nearest_interp", lambda r: {
        "X": [_rand(r, 2, 3, 8, 8)]}, {"out_h": 5, "out_w": 3}, ["Out"],
        SAME),
    "interpolate_bicubic": ("interpolate", lambda r: {
        "X": [_rand(r, 1, 2, 5, 6)]},
        {"out_h": 9, "out_w": 4, "interp_method": "bicubic",
         "align_corners": False}, ["Out"], EXACT),
    "lookup_table_v2": ("lookup_table_v2", lambda r: {
        "W": [_rand(r, 10, 4)], "Ids": [r.randint(0, 10, (3, 2))]},
        {"padding_idx": 3}, ["Out"], SAME),
}

for _name in DENSE_CASES:
    assert _name not in CASES, _name
CASES.update(DENSE_CASES)

CASES.update(CTR_CASES)
CASES.update(OPT_CASES)
CASES.update(CONV_EXTRA_CASES)
CASES.update(RNN_CONV_CASES)
CASES.update(SEQ_CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    op, build, attrs, slots, tol = CASES[name]
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    jouts, touts = _run_both(op, build(rng), attrs)
    _compare(jouts, touts, slots, tol)


def _mha_inputs(rng, B, T, D, E, Tk=None, Dk=None):
    ins = {"X": [_rand(rng, B, T, D)],
           "Wq": [_rand(rng, D, E) * 0.2],
           "Wk": [_rand(rng, Dk or D, E) * 0.2],
           "Wv": [_rand(rng, Dk or D, E) * 0.2],
           "Wo": [_rand(rng, E, D) * 0.2]}
    if Tk is not None:
        ins["XKV"] = [_rand(rng, B, Tk, Dk or D)]
    return ins


@pytest.mark.parametrize("T", [72, 128])
def test_fused_mha_causal_matches_jax(T):
    """T=72 is the odd length of the JAX package's own fused_mha test:
    JAX pads it to 128 for Mosaic, the port masks the ragged tile."""
    rng = np.random.RandomState(T)
    jouts, touts = _run_both("fused_mha", _mha_inputs(rng, 2, T, 32, 32),
                             {"n_head": 4, "causal": True})
    _compare(jouts, touts, ["Out"], MATMUL)


def test_fused_mha_cross_attention_matches_jax():
    rng = np.random.RandomState(5)
    ins = _mha_inputs(rng, 2, 16, 32, 32, Tk=24, Dk=48)
    jouts, touts = _run_both("fused_mha", ins, {"n_head": 2,
                                                "causal": False})
    _compare(jouts, touts, ["Out"], MATMUL)


@pytest.mark.parametrize("T,causal,scale", [(72, True, 0.0),
                                             (128, False, 0.2)])
def test_fused_attention_matches_jax(T, causal, scale):
    """Q/K/V [B, T, H*d]: JAX splits heads with a transpose copy and runs
    its Pallas flash kernel (T 72 padded to 128); the port hands the kernel
    [B, H, T, d] views and writes o straight into [B, T, H*d]."""
    rng = np.random.RandomState(T)
    ins = {s: [_rand(rng, 2, T, 32)] for s in ("Q", "K", "V")}
    attrs = {"n_head": 4, "causal": causal}
    if scale:
        attrs["scale"] = scale
    jouts, touts = _run_both("fused_attention", ins, attrs)
    _compare(jouts, touts, ["Out"], MATMUL)


def test_kernel_ops_on_cpu_launch_nothing():
    n_ln, n_fa = layer_norm.launches, flash_attention_hdt.launches
    rng = np.random.RandomState(1)
    _run_both("fused_mha", _mha_inputs(rng, 1, 40, 32, 32),
              {"n_head": 2, "causal": True})
    _run_both("layer_norm", {"X": [_rand(rng, 3, 8)],
                             "Scale": [_rand(rng, 8)],
                             "Bias": [_rand(rng, 8)]},
              {"begin_norm_axis": 1})
    assert (layer_norm.launches, flash_attention_hdt.launches) == (n_ln, n_fa)


@pytest.mark.parametrize("op,attrs,check", [
    ("uniform_random", {"min": -0.5, "max": 1.5},
     lambda t: (t.min() >= -0.5 and t.max() <= 1.5
                and abs(t.mean() - 0.5) < 0.02
                and abs(t.std() - 2 / np.sqrt(12)) < 0.02)),
    ("gaussian_random", {"mean": 1.0, "std": 2.0},
     lambda t: abs(t.mean() - 1.0) < 0.03 and abs(t.std() - 2.0) < 0.03),
])
def test_random_init_ops_distribution(op, attrs, check):
    """torch's Philox is not JAX's threefry: the random ops are held by
    their distribution, and by determinism under one seed."""
    attrs = dict(attrs, shape=[200, 100], dtype="float32")
    jout = np.asarray(jax_op(op).lower(JaxCtx(jax.random.PRNGKey(0)), {},
                                       attrs)["Out"][0])

    def draw(seed):
        ctx = TorchCtx(seed, torch.device("cpu"))
        return torch_op(op).lower(ctx, {}, attrs)["Out"][0].numpy()

    a, b, c = draw(3), draw(3), draw(4)
    assert a.shape == jout.shape == (200, 100)
    assert a.dtype == jout.dtype == np.float32
    assert check(a) and check(jout)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


# (op, attrs, differentiated input slots, output slot) for the conv
# plane's gradients; the inputs are the CASES entry of the same name
GRAD_CASES = {
    "conv2d_stride_pad": ("Input", "Filter"),
    "conv2d_dilation_groups": ("Input", "Filter"),
    "conv2d_same_stride2_odd_pad": ("Input", "Filter"),
    "conv2d_valid_bias": ("Input", "Filter", "Bias"),
    "depthwise_conv2d": ("Input", "Filter"),
    "pool2d_max_p1_floor_excl": ("X",),
    "pool2d_max_wide_pad": ("X",),
    "pool2d_avg_p1_floor_excl": ("X",),
    "pool2d_avg_p1_ceil_incl": ("X",),
    "pool2d_avg_ceil_window_in_pad": ("X",),
    "pool2d_global_avg": ("X",),
    "batch_norm_train_NCHW": ("X", "Scale", "Bias"),
    "batch_norm_train_NHWC": ("X", "Scale", "Bias"),
    "batch_norm_global_stats_NCHW": ("X", "Scale", "Bias"),
}
_MAIN_OUT = {"conv2d": "Output", "depthwise_conv2d": "Output",
             "pool2d": "Out", "batch_norm": "Y"}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_conv_plane_grad_matches_jax(name):
    """torch autograd through the port's lowering against jax.vjp of the
    JAX lowering, for one seeded cotangent of the main output, at CONV."""
    op, build, attrs, _, _ = CASES[name]
    wrt = GRAD_CASES[name]
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    ins = build(rng)
    out_slot = _MAIN_OUT[op]

    def jax_fn(*diff):
        jins = {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}
        for slot, a in zip(wrt, diff):
            jins[slot] = [a]
        return jax_op(op).lower(JaxCtx(jax.random.PRNGKey(0)), jins,
                                attrs)[out_slot][0]

    out, vjp = jax.vjp(jax_fn, *[jnp.asarray(ins[s][0]) for s in wrt])
    ct = rng.randn(*out.shape).astype("float32")
    jgrads = vjp(jnp.asarray(ct))

    tins = {k: [torch.from_numpy(np.array(a, order="C")) for a in v]
            for k, v in ins.items()}
    leaves = [tins[s][0].requires_grad_(True) for s in wrt]
    tout = torch_op(op).lower(TorchCtx(0, torch.device("cpu")), tins,
                              attrs)[out_slot][0]
    tgrads = torch.autograd.grad(tout, leaves, torch.from_numpy(ct))
    for slot, t, j in zip(wrt, tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=slot,
                                   **CONV)


# the NMT and BERT ops' gradients: (differentiated input slots, output
# slot); the inputs are the CASES entry of the same name
XFMR_GRAD_CASES = {
    "reduce_sum_all": ("X",),
    "reduce_sum_neg_dims_keep": ("X",),
    "reduce_mean_dim": ("X",),
    "reduce_max_dim": ("X",),
    "reduce_prod_dims": ("X",),
    "label_smooth_uniform": ("X",),
    "label_smooth_prior": ("X", "PriorDist"),
    "slice_negative_and_clamped": ("Input",),
    "slice_decrease_axis": ("Input",),
    "gather_rows": ("X",),          # repeated indices: the rows add
    "gather_axis1": ("X",),
    "gelu_erf": ("X",),
    "gelu_tanh": ("X",),
    "tanh": ("X",),
}


@pytest.mark.parametrize("name", sorted(XFMR_GRAD_CASES))
def test_nmt_bert_op_grad_matches_jax(name):
    """torch autograd through the port's lowering against jax.vjp of the
    JAX lowering, for one seeded cotangent of Out, at EXACT (elementwise
    math, and sums of at most 20 terms)."""
    _grad_matches_jax(name, XFMR_GRAD_CASES[name])


# DeepFM's ops and the table lookups: (differentiated input slots); the
# inputs are the CASES entry of the same name.  The lookups' W gradient
# is dense, 0 on every row no id named, a repeated id's rows summed
CTR_GRAD_CASES = {
    "sigmoid": ("X",),
    "square": ("X",),
    "squeeze_neg_and_non1": ("X",),
    "sigmoid_xent": ("X",),
    "sigmoid_xent_soft": ("X", "Label"),
    "sigmoid_xent_ignore_normalize": ("X",),
    "sparse_lookup_plain": ("W",),
    "sparse_lookup_hash_wide_ids": ("W",),
    "sparse_lookup_hash_trailing1": ("W",),
}


@pytest.mark.parametrize("name", sorted(CTR_GRAD_CASES))
def test_ctr_op_grad_matches_jax(name):
    """As test_nmt_bert_op_grad_matches_jax, for DeepFM's ops and the
    sparse lookup, at EXACT."""
    _grad_matches_jax(name, CTR_GRAD_CASES[name])


def _grad_matches_jax(name, wrt):
    op, build, attrs, _, _ = CASES[name]
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    ins = build(rng)

    def jax_in(a):
        return jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)

    def jax_fn(*diff):
        jins = {k: [jax_in(a) for a in v] for k, v in ins.items()}
        for slot, a in zip(wrt, diff):
            jins[slot] = [a]
        return jax_op(op).lower(JaxCtx(jax.random.PRNGKey(0)), jins,
                                attrs)["Out"][0]

    out, vjp = jax.vjp(jax_fn, *[jnp.asarray(ins[s][0]) for s in wrt])
    ct = np.asarray(rng.randn(*out.shape), "float32")   # 0-d for a 0-d out
    jgrads = vjp(jnp.asarray(ct))

    tins = {k: [torch.from_numpy(np.array(a, order="C")) for a in v]
            for k, v in ins.items()}
    leaves = [tins[s][0].requires_grad_(True) for s in wrt]
    tout = torch_op(op).lower(TorchCtx(0, torch.device("cpu")), tins,
                              attrs)["Out"][0]
    assert tout.shape == out.shape
    tgrads = torch.autograd.grad(tout, leaves, torch.from_numpy(ct))
    for slot, t, j in zip(wrt, tgrads, jgrads):
        assert t.shape == j.shape, slot
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=slot,
                                   **EXACT)


def _bf16_values(a):
    return np.asarray(torch.from_numpy(a).to(torch.bfloat16).float())


# (op, inputs, attrs, the input slots that enter as bf16) under
# FLAGS_amp_bf16: the bf16 activations the NMT and BERT steps hand these
# ops, and the f32 operands they meet (the -1e9 pad bias, tgt_mask's
# weights, the one-hot labels)
XFMR_AMP_CASES = {
    "gelu": ("gelu", lambda r: {"X": [_rand(r, 4, 8) * 3]}, {}, ("X",)),
    "tanh": ("tanh", lambda r: {"X": [_rand(r, 4, 8)]}, {}, ("X",)),
    "reduce_sum_all": ("reduce_sum", lambda r: {"X": [_rand(r, 6, 1)]},
                       {"reduce_all": True}, ("X",)),
    "reduce_mean_dim": ("reduce_mean", lambda r: {"X": [_rand(r, 4, 8)]},
                        {"dim": [1]}, ("X",)),
    "slice": ("slice", lambda r: {"Input": [_rand(r, 2, 5, 8)]},
              {"axes": [1], "starts": [0], "ends": [1]}, ("Input",)),
    "gather": ("gather", lambda r: {"X": [_rand(r, 6, 8)],
                                    "Index": [r.randint(0, 6, 4)]},
               {}, ("X",)),
    "one_hot": ("one_hot", lambda r: {"X": [r.randint(0, 9, (5, 1))]},
                {"depth": 9}, ()),
    "label_smooth": ("label_smooth", lambda r: {
        "X": [np.eye(9, dtype="float32")[r.randint(0, 9, 5)]]},
        {"epsilon": 0.1}, ()),
    # bf16 scores + the f32 pad bias: JAX's elementwise AMP rule
    "pad_bias_add": ("elementwise_add", lambda r: {
        "X": [_rand(r, 2, 2, 4, 4)],
        "Y": [np.where(r.rand(2, 1, 1, 4) < 0.3, -1e9, 0.0).astype(
            "float32")]}, {"axis": -1}, ("X",)),
    "cost_times_mask": ("elementwise_mul", lambda r: {
        "X": [_rand(r, 6, 1)],
        "Y": [(r.rand(6, 1) < 0.7).astype("float32")]}, {}, ("X",)),
    "sum_over_count": ("elementwise_div", lambda r: {
        "X": [np.array(7.25, "float32")], "Y": [np.array(5.0, "float32")]},
        {}, ("X",)),
}


@pytest.mark.parametrize("name", sorted(XFMR_AMP_CASES))
def test_nmt_bert_ops_amp_dtypes_match_jax(name):
    """Under FLAGS_amp_bf16 each op returns the dtype the JAX lowering
    returns under the flag, on the same inputs (bf16 activations rounded
    alike), with values within one bf16 step of max |JAX| (2^-7)."""
    _amp_dtype_matches_jax(name, *XFMR_AMP_CASES[name])


# DeepFM's ops under FLAGS_amp_bf16: the bf16 logit (the towers' bf16
# output met the f32 FM terms) into the loss and the sigmoid, the f32
# tables and their bf16 products
CTR_AMP_CASES = {
    "sigmoid": ("sigmoid", lambda r: {"X": [_rand(r, 6, 1) * 3]}, {},
                ("X",)),
    "square": ("square", lambda r: {"X": [_rand(r, 4, 8)]}, {}, ("X",)),
    "squeeze": ("squeeze", lambda r: {"X": [_rand(r, 4, 6, 1)]},
                {"axes": [2]}, ("X",)),
    "sigmoid_xent": ("sigmoid_cross_entropy_with_logits", lambda r: {
        "X": [_rand(r, 6, 1) * 3],
        "Label": [r.randint(0, 2, (6, 1)).astype("float32")]}, {},
        ("X",)),
    "sparse_lookup": ("sparse_embedding_lookup", lambda r: {
        "W": [_rand(r, 37, 4)], "Ids": [WIDE_IDS]}, {"hash_bucket": True},
        ()),
    "fm_terms_sub": ("elementwise_sub", lambda r: {
        "X": [_rand(r, 4, 8)], "Y": [_rand(r, 4, 8)]}, {}, ("X",)),
    "logit_add": ("elementwise_add", lambda r: {
        "X": [_rand(r, 6, 1)], "Y": [_rand(r, 6, 1)]}, {}, ("Y",)),
}


@pytest.mark.parametrize("name", sorted(CTR_AMP_CASES))
def test_ctr_ops_amp_dtypes_match_jax(name):
    """As test_nmt_bert_ops_amp_dtypes_match_jax, for DeepFM's ops."""
    _amp_dtype_matches_jax(name, *CTR_AMP_CASES[name])


def _amp_dtype_matches_jax(name, op, build, attrs, bf16):
    import paddle_tpu as pt
    import paddle_tpu_torch as ptt
    ins = build(np.random.RandomState(zlib.crc32(name.encode())))
    ins = {k: [_bf16_values(a) if k in bf16 else a for a in v]
           for k, v in ins.items()}
    # int64 ids enter JAX as its int32 feed; only the bf16 slots are cast
    # (astype(None) would make ids float)
    jins = {k: [jnp.asarray(a.astype(np.int32) if a.dtype == np.int64
                            else a) for a in v]
            for k, v in ins.items()}
    jins = {k: [a.astype(jnp.bfloat16) for a in v] if k in bf16 else v
            for k, v in jins.items()}
    tins = {k: [torch.from_numpy(np.array(a)).to(torch.bfloat16)
                if k in bf16 else torch.from_numpy(np.array(a)) for a in v]
            for k, v in ins.items()}
    pt.core.flags.set_flag("amp_bf16", True)
    ptt.flags.set_flag("amp_bf16", True)
    try:
        j = jax_op(op).lower(JaxCtx(jax.random.PRNGKey(0)), jins,
                             attrs)["Out"][0]
        t = torch_op(op).lower(TorchCtx(0, torch.device("cpu")), tins,
                               attrs)["Out"][0]
    finally:
        pt.core.flags.set_flag("amp_bf16", False)
        ptt.flags.set_flag("amp_bf16", False)
    assert str(t.dtype).split(".")[-1] == str(j.dtype), (t.dtype, j.dtype)
    j = np.asarray(jnp.asarray(j).astype(jnp.float32))
    t = t.float().numpy()
    assert t.shape == j.shape
    assert np.abs(t - j).max() <= 2.0 ** -7 * max(np.abs(j).max(), 1e-30)


def test_sparse_scatter_update_adds_where_an_overwrite_would_not():
    """Duplicate ids: the port's rows equal JAX's scatter-add, and differ
    from what an indexed assignment (the last write wins) gives."""
    op, build, attrs, _, _ = CASES["sparse_scatter_duplicates"]
    ins = build(np.random.RandomState(3))
    jouts, touts = _run_both(op, ins, attrs)
    got = touts["Out"][0].numpy()
    np.testing.assert_allclose(got, np.asarray(jouts["Out"][0]), **EXACT)
    w, ids, g = ins["W"][0], ins["Ids"][0], ins["Grad"][0]
    over = w.copy()
    over[ids] = w[ids] - attrs["learning_rate"] * g
    assert not np.allclose(got[3], over[3]) and not np.allclose(got[0],
                                                                over[0])
    np.testing.assert_array_equal(got[[1, 2, 4, 5, 6, 8, 9]],
                                  w[[1, 2, 4, 5, 6, 8, 9]])


@pytest.mark.parametrize("num,window", [(3.0, 10.0), (10.0, 10.0),
                                        (0.0, 10000.0)])
def test_average_accumulates_matches_jax(num, window):
    """ModelAverage's op inside its window (the exact sum), at the cap
    (the sliding sum, the count held at the cap) and from 0; the count
    keeps its [1] shape where JAX's lowering returns it 0-d."""
    r = np.random.RandomState(int(num))
    ins = {"param": [_rand(r, 4, 5)], "in_sum_1": [_rand(r, 4, 5)],
           "in_num_accumulates": [np.array([num], "float32")]}
    jouts, touts = _run_both("average_accumulates", ins,
                             {"max_average_window": window})
    np.testing.assert_allclose(touts["out_sum_1"][0].numpy(),
                               np.asarray(jouts["out_sum_1"][0]), **EXACT)
    count = touts["out_num_accumulates"][0]
    assert tuple(count.shape) == (1,)
    assert float(count) == float(np.asarray(
        jouts["out_num_accumulates"][0])) == min(num + 1, window)


def test_adagrad_leaves_zero_gradient_entries_bit_equal():
    """A table row no id named has a gradient of exactly 0: Adagrad
    leaves its parameter and moment bit-equal, in both packages."""
    r = np.random.RandomState(9)
    ins = _opt_ins(r, pos=("Moment",), shape=(6, 4))
    ins["Grad"][0][[1, 4]] = 0.0
    jouts, touts = _run_both("adagrad", ins, {"epsilon": 1e-6})
    for slot, src in (("ParamOut", "Param"), ("MomentOut", "Moment")):
        for out in (touts[slot][0].numpy(), np.asarray(jouts[slot][0])):
            np.testing.assert_array_equal(out[[1, 4]], ins[src][0][[1, 4]])


# the recurrent family's gradients: (differentiated input slots, output
# slots, each given a seeded cotangent); the inputs are the CASES entry of
# the same name
RNN_GRAD_CASES = {
    "lrn_n5": (("X",), ("Out",)),
    "lrn_n3_k1": (("X",), ("Out",)),
    "concat_axis1": (("X",), ("Out",)),
    "lstm_plain": (("Input", "Weight"), ("Hidden", "LastC")),
    "lstm_mask": (("Input", "Weight"), ("Hidden", "LastH", "LastC")),
    "lstm_reverse_mask_h0_c0": (("Input", "Weight", "H0", "C0"),
                                ("Hidden", "Cell", "LastC")),
    "lstm_activations": (("Input", "Weight", "H0"), ("Hidden",)),
    "gru_plain": (("Input", "Weight"), ("Hidden",)),
    "gru_reverse_mask_h0": (("Input", "Weight", "H0"), ("Hidden", "LastH")),
    "gru_activations": (("Input", "Weight", "H0"), ("Hidden",)),
    "lstm_unit_forget_bias": (("X", "C_prev"), ("C", "H")),
    "gru_unit": (("Input", "HiddenPrev", "Weight"),
                 ("Hidden", "Gate", "ResetHiddenPrev")),
}


def _multi_grads(op, ins, attrs, wrt, outs, rng, bf16=()):
    """jax.vjp of the JAX lowering and torch autograd through the port's,
    for seeded cotangents of the `outs` slots: (JAX grads, port grads, JAX
    outputs, port outputs), each a list.  `bf16` slots enter both as bf16
    (their grads come back bf16)."""
    def jax_in(k, a):
        a = jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)
        return a.astype(jnp.bfloat16) if k in bf16 else a

    def jax_fn(*diff):
        jins = {k: [jax_in(k, a) for a in v] for k, v in ins.items()}
        i = 0
        for slot in wrt:
            n = len(ins[slot])
            jins[slot] = list(diff[i:i + n])
            i += n
        res = jax_op(op).lower(JaxCtx(jax.random.PRNGKey(0)), jins, attrs)
        return tuple(res[s][0] for s in outs)

    primals = [jax_in(s, a) for s in wrt for a in ins[s]]
    jout, vjp = jax.vjp(jax_fn, *primals)
    cts = [np.asarray(rng.randn(*o.shape), "float32") for o in jout]
    jgrads = vjp(tuple(jnp.asarray(c).astype(o.dtype)
                       for c, o in zip(cts, jout)))
    tins = {k: [torch.from_numpy(np.array(a, order="C")) for a in v]
            for k, v in ins.items()}
    tins = {k: [t.to(torch.bfloat16) for t in v] if k in bf16 else v
            for k, v in tins.items()}
    leaves = [t.requires_grad_(True) for s in wrt for t in tins[s]]
    res = torch_op(op).lower(TorchCtx(0, torch.device("cpu")), tins, attrs)
    tout = [res[s][0] for s in outs]
    tgrads = torch.autograd.grad(
        tout, leaves, [torch.from_numpy(c).to(o.dtype)
                       for c, o in zip(cts, tout)])
    return list(jgrads), list(tgrads), list(jout), tout


@pytest.mark.parametrize("name", sorted(RNN_GRAD_CASES))
def test_rnn_conv_op_grad_matches_jax(name):
    """torch autograd through the port's lowering against jax.vjp of the
    JAX lowering, for seeded cotangents of the listed outputs at once, at
    the case's tolerance (MATMUL through a recurrence)."""
    op, build, attrs, _, tol = CASES[name]
    wrt, outs = RNN_GRAD_CASES[name]
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    jg, tg, _, _ = _multi_grads(op, build(rng), attrs, wrt, outs, rng)
    assert len(jg) == len(tg)
    for j, t in zip(jg, tg):
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# bf16 activations (the AMP plane's) into lrn, concat and the recurrences,
# the LSTM and GRU weights f32 masters: (op, inputs, attrs, bf16 input
# slots, differentiated slots, output slots, tolerance in bf16 steps of
# max |JAX| for the outputs, and for the grads).  Readings: lrn's outputs
# 0 steps (its grad 0.72), the recurrences' outputs up to 1.29 steps and
# their grads up to 1.16 over six steps of the sequence
RNN_BF16_CASES = {
    "lrn_n5": ("lrn", lambda r: {"X": [_rand(r, 2, 7, 4, 4) * 3]},
               {"n": 5, "k": 2.0, "alpha": 1e-2, "beta": 0.75}, ("X",),
               ("X",), ("Out", "MidOut"), 0, 1),
    "lrn_n3_k1": ("lrn", lambda r: {"X": [_rand(r, 2, 6, 3, 5) * 3]},
                  {"n": 3, "k": 1.0, "alpha": 0.05, "beta": 0.5}, ("X",),
                  ("X",), ("Out", "MidOut"), 0, 1),
    "concat_bf16_f32": ("concat", lambda r: {
        "X": [_rand(r, 2, 3), _rand(r, 2, 2)]}, {"axis": 1}, (),
        (), ("Out",), 0, 0),
    "lstm_mask": ("lstm", lambda r: _lstm_ins(r, mask=True), {}, ("Input",),
                  ("Input", "Weight"), tuple(_LSTM_OUT), 2, 2),
    "lstm_reverse_h0_c0": ("lstm", lambda r: _lstm_ins(r, mask=True, h0=True,
                                                       c0=True),
                           {"is_reverse": True},
                           ("Input", "H0", "C0"), ("Input", "Weight"),
                           tuple(_LSTM_OUT), 2, 2),
    "gru_mask": ("gru", lambda r: _gru_ins(r, mask=True), {}, ("Input",),
                 ("Input", "Weight"), tuple(_GRU_OUT), 2, 2),
}


@pytest.mark.parametrize("name", sorted(RNN_BF16_CASES))
def test_rnn_conv_ops_bf16_match_jax(name):
    """bf16 inputs (an f32 recurrent weight beside them): the port's
    outputs and gradients take JAX's dtypes, and their values lie within
    the case's count of bf16 steps (2^-7) of max |JAX| (lrn and concat
    bit for bit).  The mask is f32 and is cast to the activations' dtype
    in both packages (the AMP regression tests/test_ops_rnn.py guards in
    the JAX package)."""
    op, build, attrs, bf16, wrt, outs, out_steps, grad_steps = \
        RNN_BF16_CASES[name]
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    ins = build(rng)
    if op == "concat":          # one bf16 block, one f32 block
        ins["X"][0] = np.asarray(torch.from_numpy(ins["X"][0]).to(
            torch.bfloat16).float())
        jx = [jnp.asarray(ins["X"][0]).astype(jnp.bfloat16),
              jnp.asarray(ins["X"][1])]
        tx = [torch.from_numpy(ins["X"][0]).to(torch.bfloat16),
              torch.from_numpy(ins["X"][1])]
        j = jax_op(op).lower(JaxCtx(jax.random.PRNGKey(0)), {"X": jx},
                             attrs)["Out"][0]
        t = torch_op(op).lower(TorchCtx(0, torch.device("cpu")), {"X": tx},
                               attrs)["Out"][0]
        assert str(j.dtype) == "float32" and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        return
    jg, tg, jout, tout = _multi_grads(op, ins, attrs, wrt, outs, rng, bf16)
    step = 2.0 ** -7
    for slot, j, t in zip(outs, jout, tout):
        assert str(t.dtype).split(".")[-1] == str(j.dtype) == "bfloat16"
        j, t = _f32(j), _f32(t)
        assert np.abs(t - j).max() <= out_steps * step * np.abs(j).max(), \
            slot
    for slot, j, t in zip(wrt, jg, tg):
        assert str(t.dtype).split(".")[-1] == str(j.dtype), slot
        j, t = _f32(j), _f32(t)
        assert np.abs(t - j).max() <= grad_steps * step * np.abs(j).max(), \
            (slot, np.abs(t - j).max() / np.abs(j).max() / step)


# the gradients of the book's and the decode's differentiable ops through
# autograd against jax.vjp (the inputs are the CASES entry of the same
# name): (differentiated slots, output slots)
SEQ_GRAD_CASES = {
    "static_rnn_scan": (("Init", "X", "W"), ("Ys", "CarryOut")),
    "log_softmax_axis1": (("X",), ("Out",)),
    "square_error_cost": (("X", "Label"), ("Out",)),
    "cos_sim": (("X", "Y"), ("Out",)),
    "sequence_conv": (("X", "Filter"), ("Out",)),
    "linear_chain_crf_mask": (("Emission", "Transition"),
                              ("LogLikelihood",)),
    "linear_chain_crf_label3": (("Emission", "Transition"),
                                ("LogLikelihood", "Alpha")),
    "expand": (("X",), ("Out",)),
    **{f"sequence_pool_{p.lower()}_mask": (("X",), ("Out",))
       for p in ("AVERAGE", "SUM", "SQRT", "MAX", "LAST", "FIRST")},
}


@pytest.mark.parametrize("name", sorted(SEQ_GRAD_CASES))
def test_seq_op_grad_matches_jax(name):
    """torch autograd through the port's lowering (the scan's loop, the
    CRF's recursion) against jax.vjp of the JAX lowering under seeded
    cotangents of the listed outputs, at MATMUL."""
    op, build, attrs, _, _ = CASES[name]
    wrt, outs = SEQ_GRAD_CASES[name]
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    ins = build(rng)
    if op == "static_rnn_scan":
        jg, tg = _scan_grads(ins, attrs, wrt, outs, rng)
    else:
        jg, tg, _, _ = _multi_grads(op, ins, attrs, wrt, outs, rng)
    assert len(jg) == len(tg) == sum(len(ins[s]) for s in wrt)
    for j, t in zip(jg, tg):
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **MATMUL)
        assert np.abs(np.asarray(j)).max() > 0


def _scan_grads(ins, attrs, wrt, outs, rng):
    """_multi_grads for static_rnn_scan: W reaches the step through the
    live env, so both sides put the differentiated W there."""
    def jax_fn(init, x, w):
        jins = {"Init": [init], "X": [x], "W": [w]}
        jctx, _ = _contexts("static_rnn_scan", jins, {"W": [None]})
        res = jax_op("static_rnn_scan").lower(jctx, jins, attrs)
        return tuple(res[s][0] for s in outs)

    primals = [jnp.asarray(ins[s][0]) for s in wrt]
    jout, vjp = jax.vjp(jax_fn, *primals)
    cts = [rng.randn(*o.shape).astype("float32") for o in jout]
    jgrads = vjp(tuple(jnp.asarray(c) for c in cts))
    leaves = [torch.from_numpy(ins[s][0].copy()).requires_grad_(True)
              for s in wrt]
    tins = dict(zip(wrt, ([t] for t in leaves)))
    _, tctx = _contexts("static_rnn_scan", {"W": [None]}, tins)
    res = torch_op("static_rnn_scan").lower(tctx, tins, attrs)
    tout = [res[s][0] for s in outs]
    tgrads = torch.autograd.grad(tout, leaves,
                                 [torch.from_numpy(c) for c in cts])
    return list(jgrads), list(tgrads)


def test_clip_gradient_at_bounds_is_jax_half():
    """The ``clip`` op's gradient at an element sitting exactly on ``min``
    or ``max`` is jnp.clip's 0.5 (lax.max and lax.min split a tie), not
    torch.clamp's 1; inside 1, outside 0."""
    x = np.array([-1.0, -0.5, 0.0, 0.5, 1.0, 0.25], "float32")
    attrs = {"min": -0.5, "max": 0.5}
    jgrad = jax.grad(lambda v: jnp.sum(jax_op("clip").lower(
        JaxCtx(jax.random.PRNGKey(0)), {"X": [v]}, attrs)["Out"][0]))(
            jnp.asarray(x))
    t = torch.from_numpy(x.copy()).requires_grad_(True)
    out = torch_op("clip").lower(TorchCtx(0, torch.device("cpu")),
                                 {"X": [t]}, attrs)["Out"][0]
    tgrad, = torch.autograd.grad(out.sum(), t)
    np.testing.assert_array_equal(np.asarray(jgrad),
                                  [0.0, 0.5, 1.0, 0.5, 0.0, 1.0])
    np.testing.assert_array_equal(tgrad.numpy(), np.asarray(jgrad))
