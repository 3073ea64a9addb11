"""The dense op plane's lowerings (``DENSE_CASES`` of
tests/test_torch_ops.py, which holds their values against JAX's in
``test_op_matches_jax``) beyond their values: their gradients against
jax.vjp of JAX's lowerings with the kinks and ties planted, their
evaluation on ``meta`` tensors (the verifier's shape inference and the
layers' build-time inference run them there), and the random ops'
distributions."""
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
from test_torch_ops import CASES, DENSE_CASES, EXACT, SAME, _multi_grads

# the differentiable ops of the dense plane: (differentiated input slots,
# output slots, each given a seeded cotangent), over the CASES entry of
# the same name, its kinks and ties planted
DENSE_GRAD_CASES = {
    **{n: (("X",), ("Out",)) for n in (
        "act_abs", "act_cos", "act_sin", "act_exp", "act_erf", "act_log",
        "act_rsqrt", "act_reciprocal", "act_logsigmoid", "act_tanh_shrink",
        "act_softplus", "act_softsign", "act_brelu", "act_brelu_default",
        "act_leaky_relu", "act_soft_relu", "act_soft_relu_default",
        "act_elu", "act_relu6", "act_relu6_threshold", "act_pow2",
        "act_pow_frac", "act_stanh", "act_hard_shrink", "act_softshrink",
        "act_hard_sigmoid", "act_swish", "act_hard_swish", "act_mish",
        "act_thresholded_relu", "act_selu", "maxout_sweep", "maxout_ties",
        "flatten", "flatten_contiguous_range", "expand_as", "tile",
        "gather_nd", "gather_nd_partial", "pad",
        "pad2d_constant", "pad2d_reflect", "pad2d_edge", "crop", "reverse",
        "roll_two_axes", "space_to_depth", "pixel_shuffle", "clip_bounds",
        "cumsum", "cumsum_exclusive_reverse", "l1_norm",
        "interpolate_sweep", "bilinear_interp", "bilinear_no_align_up",
        "bilinear_no_align_shrink_8_4", "nearest_interp_shrink_8_5",
        "interpolate_bicubic")},
    "strided_slice_negative": (("Input",), ("Out",)),
    "prelu_all": (("X", "Alpha"), ("Out",)),
    "prelu_channel": (("X", "Alpha"), ("Out",)),
    "prelu_element": (("X", "Alpha"), ("Out",)),
    "reshape2": (("X",), ("Out",)),
    "transpose2": (("X",), ("Out",)),
    "squeeze2": (("X",), ("Out",)),
    "unsqueeze2": (("X",), ("Out",)),
    "flatten2": (("X",), ("Out",)),
    "stack_axis1": (("X",), ("Y",)),
    "scatter_overwrite_repeats": (("X", "Updates"), ("Out",)),
    "scatter_add_repeats": (("X", "Updates"), ("Out",)),
    "scatter_nd_add": (("X", "Updates"), ("Out",)),
    "pad_constant_like": (("Y",), ("Out",)),
    "multiplex": (("X",), ("Out",)),
    "where": (("X", "Y"), ("Out",)),
    # argsort's Out keeps its gradient on the program path (JAX's op-level
    # stop_gradient is read only by the imperative plane)
    "argsort_ties": (("X",), ("Out",)),
    "dot": (("X", "Y"), ("Out",)),
    "minus": (("X", "Y"), ("Out",)),
    "squared_l2_distance": (("X", "Y"), ("Out", "sub_result")),
    "norm": (("X",), ("Out", "Norm")),
    "bilinear_tensor_product_bias": (("X", "Y", "Weight", "Bias"), ("Out",)),
    "range_fractional": (("Start", "Step"), ("Out",)),
    "mse_loss": (("X",), ("Out",)),
    "smooth_l1_loss_weights_sigma": (("X", "Y"), ("Out",)),
    "huber_loss": (("X",), ("Out",)),
    "huber_loss_at_delta": (("X", "Y"), ("Out",)),
    "log_loss": (("Predicted",), ("Loss",)),
    "hinge_loss": (("Logits",), ("Loss",)),
    "modified_huber_loss": (("X",), ("Out",)),
    "bpr_loss": (("X",), ("Y",)),
    "margin_rank_loss": (("X1", "X2"), ("Out",)),
    "rank_loss": (("Left", "Right"), ("Out",)),
    **{f"kldiv_loss_{red}": (("X",), ("Loss",))
       for red in ("mean", "sum", "batchmean", "none")},
    "npair_loss": (("Anchor", "Positive"), ("Out",)),
    "sigmoid_xent_zero_logits": (("X",), ("Out",)),
    "lookup_table_v2": (("W",), ("Out",)),
}


@pytest.mark.parametrize("name", sorted(DENSE_GRAD_CASES))
def test_dense_op_grad_matches_jax(name):
    """torch autograd through the dense plane's lowerings against jax.vjp
    of JAX's, under seeded cotangents of the listed outputs, with the
    kinks and ties of the CASES entry planted: the jnp.clip family's 0.5
    at a bound, leaky_relu's 1 at 0, maxout's even split of a tie,
    argsort's gradient through Out, and an overwriting scatter whose
    repeated id passes the gradient to its last update only.  At the
    case's tolerance (EXACT where the values are compared SAME)."""
    op, build, attrs, _, tol = CASES[name]
    wrt, outs = DENSE_GRAD_CASES[name]
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    ins = build(rng)
    jg, tg, _, _ = _multi_grads(op, ins, attrs, wrt, outs, rng)
    assert len(jg) == len(tg) == sum(len(ins[s]) for s in wrt)
    for j, t in zip(jg, tg):
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                   **(EXACT if tol is SAME else tol))


# (op, inputs, attrs, check of the draw) for the dense plane's random
# ops; a normal cut to [-2, 2] has std 0.87962 of the uncut one's
_TRUNC_STD = 0.8796256610342398


@pytest.mark.parametrize("op,ins,attrs,check", [
    ("truncated_gaussian_random", {},
     {"shape": [200, 100], "mean": 1.0, "std": 2.0},
     lambda t: (t.min() >= -3.0 and t.max() <= 5.0
                and abs(t.mean() - 1.0) < 0.03
                and abs(t.std() - 2 * _TRUNC_STD) < 0.03)),
    ("uniform_random_batch_size_like",
     {"Input": [np.zeros((200, 3), "float32")]},
     {"shape": [-1, 100], "min": -0.5, "max": 1.5},
     lambda t: (t.shape == (200, 100) and t.min() >= -0.5
                and t.max() <= 1.5 and abs(t.mean() - 0.5) < 0.02
                and abs(t.std() - 2 / np.sqrt(12)) < 0.02)),
    ("gaussian_random_batch_size_like",
     {"Input": [np.zeros((4, 200), "float32")]},
     {"shape": [100, -1], "input_dim_idx": 1, "output_dim_idx": 1,
      "mean": 1.0, "std": 2.0},
     lambda t: (t.shape == (100, 200) and abs(t.mean() - 1.0) < 0.03
                and abs(t.std() - 2.0) < 0.03)),
    ("sampling_id",
     {"X": [np.tile(np.array([[0.1, 0.2, 0.0, 0.7]], "float32"),
                    (20000, 1))]}, {},
     lambda t: (t.shape == (20000,) and np.all(np.abs(
         np.bincount(t, minlength=4) / 20000.0
         - [0.1, 0.2, 0.0, 0.7]) < 0.015))),
])
def test_dense_random_ops_distribution(op, ins, attrs, check):
    """The dense plane's random ops, held by their distribution (torch's
    Philox is not JAX's threefry) and by determinism under one seed."""
    attrs = dict(attrs, dtype="float32")
    jins = {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}
    jout = np.asarray(jax_op(op).lower(JaxCtx(jax.random.PRNGKey(0)), jins,
                                       attrs)["Out"][0])

    def draw(seed):
        tins = {k: [torch.from_numpy(a) for a in v] for k, v in ins.items()}
        ctx = TorchCtx(seed, torch.device("cpu"))
        return torch_op(op).lower(ctx, tins, attrs)["Out"][0].numpy()

    a, b, c = draw(3), draw(3), draw(4)
    assert a.shape == jout.shape
    assert check(a) and check(jout)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_dense_op_evaluates_on_meta(name):
    """The verifier's shape inference and the layers' build-time
    inference run each lowering on ``meta`` tensors: every dense-plane
    op evaluates there, to the shapes and dtypes of its CPU run."""
    from paddle_tpu_torch.framework.layer_helper import meta_lower
    op, build, attrs, slots, _ = CASES[name]
    ins = build(np.random.RandomState(zlib.crc32(name.encode())))
    tins = {k: [torch.from_numpy(np.array(a, order="C")) for a in v]
            for k, v in ins.items()}
    want = torch_op(op).lower(TorchCtx(0, torch.device("cpu")), tins, attrs)
    meta = {k: [t.to("meta") for t in v] for k, v in tins.items()}
    got = meta_lower(torch_op(op), meta, attrs)
    for slot in slots:
        assert [(tuple(t.shape), t.dtype) for t in got[slot]] == [
            (tuple(t.shape), t.dtype) for t in want[slot]], slot
