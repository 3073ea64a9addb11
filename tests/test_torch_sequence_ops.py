"""The sequence, LoD-array, CTC, sampling and selected-rows planes and the
vision and host extras (``SEQ_PLANE_CASES`` of tests/test_torch_ops.py,
whose values ``test_op_matches_jax`` holds against JAX's lowerings)
beyond their values: their gradients against jax.vjp of JAX's lowerings
with the planted cases of the table (wrapped, clamped and dropped
indices, repeated ids, ties, a clip's bounds, 0 in a stable cross
entropy, CTC's frozen rows and empty labels), their evaluation on
``meta`` tensors, and the two random ops: nce held on the same samples
as JAX's formula and by its draw's distribution, random_crop by its
offsets' range and by being that slice of X."""
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
from paddle_tpu_torch.ops import sampling_ops
from test_torch_ops import (CASES, EXACT, MATMUL, SAME, SEQ_PLANE_CASES,
                            _multi_grads)

# the differentiable ops of the plane: (differentiated input slots, output
# slots, each given a seeded cotangent) over the CASES entry of the name
SEQ_PLANE_GRAD = {
    "sequence_softmax_mask": (("X",), ("Out",)),
    "sequence_softmax_length_3d": (("X",), ("Out",)),
    "sequence_expand": (("X",), ("Out",)),
    "sequence_expand_as_3d": (("X",), ("Out",)),
    "sequence_reverse_length": (("X",), ("Y",)),
    "sequence_concat": (("X",), ("Out",)),
    "sequence_slice_past_end": (("X",), ("Out",)),
    "sequence_pad_longer": (("X",), ("Out",)),
    "sequence_pad_default": (("X",), ("Out",)),
    "sequence_unpad": (("X",), ("Out",)),
    "sequence_reshape": (("X",), ("Out",)),
    "sequence_scatter_planted_ids": (("X", "Updates"), ("Out",)),
    "sequence_scatter_3d": (("X", "Updates"), ("Out",)),
    "lod_reset": (("X",), ("Out",)),
    "row_conv": (("X", "Filter"), ("Out",)),
    "add_position_encoding_t64_alpha_beta": (("X",), ("Out",)),
    "reorder_lod_tensor_by_rank": (("X",), ("Out",)),
    "tensor_array_to_tensor_axis1": (("X",), ("Out",)),
    "tensor_array_to_tensor_stack": (("X",), ("Out",)),
    "split_lod_tensor": (("X",), ("OutTrue", "OutFalse")),
    "merge_lod_tensor": (("InTrue", "InFalse"), ("Out",)),
    "lod_tensor_to_array": (("X",), ("Out",)),
    "array_to_lod_tensor": (("X",), ("Out",)),
    "shrink_rnn_memory": (("X",), ("Out",)),
    "rnn_memory_helper": (("X",), ("Out",)),
    **{f"write_to_array_index_{i}": (("X", "Array"), ("Out",))
       for i in (2, 5, -1, -5)},
    "write_to_array_fresh": (("X",), ("Out",)),
    **{f"read_from_array_index_{i}": (("X",), ("Out",))
       for i in (1, 7, -1, -4)},
    "sequence_context_len4_default_start": (("X",), ("Out",)),
    "conv_shift": (("X", "Y"), ("Out",)),
    "lstmp_h0_c0": (("Input", "Weight", "ProjWeight", "H0", "C0"),
                    ("Projection", "Cell", "LastH", "LastC")),
    "cudnn_lstm": (("Input", "W"), ("Out", "LastH", "LastC")),
    "cudnn_lstm_2layer_bidirec_init": (("Input", "W", "InitH", "InitC"),
                                       ("Out", "LastH", "LastC")),
    "warpctc": (("Logits",), ("Loss",)),
    "warpctc_lengths_empty_label": (("Logits",), ("Loss",)),
    "warpctc_padded_labels_blank2": (("Logits",), ("Loss",)),
    "hierarchical_sigmoid": (("X", "W"), ("Out", "PreOut")),
    "hierarchical_sigmoid_6_bias": (("X", "W", "Bias"), ("Out",)),
    "teacher_student_planted": (("X",), ("Y",)),
    "teacher_student_sigmoid_loss": (("X",), ("Y",)),
    "lookup_sparse_table": (("W",), ("Out",)),
    "merge_ids": (("X",), ("Out",)),
    "merge_selected_rows_repeats": (("Values",), ("Out",)),
    "split_selected_rows": (("Values",), ("Out",)),
    "get_tensor_from_selected_rows_planted": (("Values",), ("Out",)),
    "affine_channel": (("X", "Scale", "Bias"), ("Out",)),
    "im2sequence_padded_per_example": (("X",), ("Out",)),
    "grid_sampler": (("X", "Grid"), ("Output",)),
    "grid_sampler_edges": (("X", "Grid"), ("Output",)),
    "pad3d": (("X",), ("Out",)),
    "shuffle_channel": (("X",), ("Out",)),
    "spp_max": (("X",), ("Out",)),
    "spp_avg": (("X",), ("Out",)),
    "unpool_planted": (("X",), ("Out",)),
    "scale_sub_region": (("X",), ("Out",)),
    "print": (("X",), ("Out",)),
}


@pytest.mark.parametrize("name", sorted(SEQ_PLANE_GRAD))
def test_seq_plane_grad_matches_jax(name):
    """torch autograd through the plane's lowerings against jax.vjp of
    JAX's, under seeded cotangents of the listed outputs, on the CASES
    entry's planted inputs: the scatters' wrapped and dropped ids (0 for
    a dropped update) and repeats, the tensor array's clamped rows (a
    write's gradient to the array row it overwrote is 0), spp's tied
    maxima split evenly, the cross entropies' lax.abs at z = 0 and
    jnp.clip's 0.5 at a bound, CTC through frozen rows and an empty
    label.  At the case's tolerance, EXACT where it is SAME (a copy's
    gradient may add several cotangents)."""
    op, build, attrs, _, tol = CASES[name]
    wrt, outs = SEQ_PLANE_GRAD[name]
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    ins = build(rng)
    jg, tg, _, _ = _multi_grads(op, ins, attrs, wrt, outs, rng)
    assert len(jg) == len(tg) == sum(len(ins[s]) for s in wrt)
    for j, t in zip(jg, tg):
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                   **(EXACT if tol is SAME else tol))


def test_planted_gradients_are_jax_rules():
    """The planted rules, by value: lax.abs's 1 at 0 in the cross entropy
    (torch.abs gives 0 there, and the hard-label rows at z = 0 would be
    off by 0.5), jnp.clip's 0.5 at a soft label's bound, a dropped
    scatter update's 0, and an array write's 0 to the overwritten row."""
    ctx = TorchCtx(0, torch.device("cpu"))
    x = torch.tensor([[0.0], [0.0], [15.0], [-15.0]], requires_grad=True)
    label = torch.tensor([[0.0], [1.0], [0.3], [0.6]])
    y = torch_op("teacher_student_sigmoid_loss").lower(
        ctx, {"X": [x], "Label": [label]}, {})["Y"][0]
    g, = torch.autograd.grad(y.sum(), x)
    sig = 1 / (1 + np.exp(-15.0))
    # z = 0: 0.5 (the max's tie) - target + d log1p(exp(-|z|)) = -0.5
    # (lax.abs's +1 at 0); at the bounds: half of sigmoid(z) - label
    np.testing.assert_allclose(g.numpy()[:, 0], [0.0, -1.0,
                                                 0.5 * (sig - 0.3),
                                                 0.5 * (1 - sig - 0.6)],
                               rtol=1e-6, atol=1e-7)
    xs = torch.zeros(1, 3)
    upd = torch.ones(1, 3, requires_grad=True)
    out = torch_op("sequence_scatter").lower(
        ctx, {"X": [xs], "Ids": [torch.tensor([[-1, 3, -4]])],
              "Updates": [upd]}, {})["Out"][0]
    np.testing.assert_array_equal(out.detach().numpy(), [[0.0, 0.0, 1.0]])
    g, = torch.autograd.grad(out.sum(), upd)
    np.testing.assert_array_equal(g.numpy(), [[1.0, 0.0, 0.0]])
    arr = torch.ones(3, 2, requires_grad=True)
    out = torch_op("write_to_array").lower(
        ctx, {"X": [torch.zeros(2)], "I": [torch.tensor([5])],
              "Array": [arr]}, {})["Out"][0]
    g, = torch.autograd.grad(out.sum(), arr)
    np.testing.assert_array_equal(g.numpy(), [[1, 1], [1, 1], [0, 0]])


@pytest.mark.parametrize("name", sorted(SEQ_PLANE_CASES))
def test_seq_plane_op_evaluates_on_meta(name):
    """The verifier's shape inference and the layers' build-time
    inference run each lowering on ``meta`` tensors: every op of the
    plane evaluates there (no host read of a value: unique's and
    ctc_align's static shapes, the array index and shrink_rnn_memory's
    step stay tensors), to the shapes and dtypes of its CPU run."""
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


def test_ctc_align_packs_stably_on_its_own_rule():
    """ctc_align on a row with every pattern: a run collapses to one, a
    blank between two equal ids keeps both, the kept ids pack left in
    order and the padding value fills the rest."""
    x = torch.tensor([[1, 1, 0, 1, 2, 2, 2, 0, 0, 3]])
    out = torch_op("ctc_align").lower(TorchCtx(0, torch.device("cpu")),
                                      {"Input": [x]},
                                      {"blank": 0, "padding_value": -1})
    np.testing.assert_array_equal(out["Output"][0].numpy(),
                                  [[1, 1, 2, 3, -1, -1, -1, -1, -1, -1]])


def _nce_inputs(r, B=6, D=5, N=12, k=4):
    x = r.randn(B, D).astype("float32")
    w = r.randn(N, D).astype("float32")
    bias = r.randn(N).astype("float32") * 0.5
    label = r.randint(0, N, (B, 1)).astype("int64")
    # row 0 zero, and the bias of its label log(k / N): its label's
    # adjusted logit is exactly 0, the cross entropy's kink
    x[0] = 0.0
    bias[label[0, 0]] = np.float32(np.log(k / N))
    return {"Input": [x], "Weight": [w], "Bias": [bias], "Label": [label]}


@pytest.mark.parametrize("bias", [True, False])
def test_nce_cost_matches_jax_on_the_same_samples(bias, monkeypatch):
    """nce's cost, its sample logits and the gradients of the cost with
    respect to Input, Weight and Bias against JAX's lowering fed the
    port's draw (jax.random.randint returns the port's negatives), with
    an adjusted logit of exactly 0 planted (lax.abs's gradient there)."""
    attrs = {"num_total_classes": 12, "num_neg_samples": 4}
    r = np.random.RandomState(11)
    ins = _nce_inputs(r)
    if not bias:
        del ins["Bias"]
    wrt = ("Input", "Weight") + (("Bias",) if bias else ())
    tins = {k: [torch.from_numpy(a.copy()) for a in v] for k, v in ins.items()}
    leaves = [tins[s][0].requires_grad_(True) for s in wrt]
    res = torch_op("nce").lower(TorchCtx(5, torch.device("cpu")), tins, attrs)
    samples = res["SampleLabels"][0].numpy()
    assert samples.dtype == np.int64
    np.testing.assert_array_equal(samples[:, 0], ins["Label"][0][:, 0])
    neg = samples[:, 1:]
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(
                            neg, jnp.int32))
    ct = r.randn(6, 1).astype("float32")

    def jax_run(*diff):
        jins = {k: [jnp.asarray(a.astype(np.int32) if a.dtype == np.int64
                                else a) for a in v] for k, v in ins.items()}
        for slot, d in zip(wrt, diff):
            jins[slot] = [d]
        return jax_op("nce").lower(JaxCtx(jax.random.PRNGKey(0)), jins,
                                   attrs)

    primals = [jnp.asarray(ins[slot][0]) for slot in wrt]
    np.testing.assert_array_equal(
        np.asarray(jax_run(*primals)["SampleLabels"][0]), samples)
    (jcost, jlogits), vjp = jax.vjp(
        lambda *d: (jax_run(*d)["Cost"][0], jax_run(*d)["SampleLogits"][0]),
        *primals)
    np.testing.assert_allclose(res["Cost"][0].detach().numpy(),
                               np.asarray(jcost), **MATMUL)
    np.testing.assert_allclose(res["SampleLogits"][0].detach().numpy(),
                               np.asarray(jlogits), **MATMUL)
    jgrads = vjp((jnp.asarray(ct), jnp.zeros_like(jlogits)))
    tgrads = torch.autograd.grad(res["Cost"][0], leaves,
                                 torch.from_numpy(ct))
    for slot, j, t in zip(wrt, jgrads, tgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=slot,
                                   **MATMUL)


def test_nce_draw_is_uniform_and_seeded():
    """nce's negatives (torch's Philox, not JAX's threefry): uniform over
    [0, N) in both packages (each class within 0.01 of 1 / N over 160000
    draws), the label first; the same draw again under one seed, another
    under another."""
    B, N, k = 16000, 16, 10
    ins = {"Input": [np.zeros((B, 2), "float32")],
           "Weight": [np.zeros((N, 2), "float32")],
           "Label": [np.zeros((B, 1), "int64") + 3]}
    attrs = {"num_total_classes": N, "num_neg_samples": k}

    def draw(seed):
        tins = {s: [torch.from_numpy(a) for a in v] for s, v in ins.items()}
        return torch_op("nce").lower(TorchCtx(seed, torch.device("cpu")),
                                     tins, attrs)["SampleLabels"][0].numpy()

    a, b, c = draw(1), draw(1), draw(2)
    jins = {s: [jnp.asarray(v[0].astype(np.int32) if v[0].dtype == np.int64
                            else v[0])] for s, v in ins.items()}
    j = np.asarray(jax_op("nce").lower(JaxCtx(jax.random.PRNGKey(0)), jins,
                                       attrs)["SampleLabels"][0])
    for got in (a, j):
        assert got.shape == (B, 1 + k)
        assert (got[:, 0] == 3).all()
        freq = np.bincount(got[:, 1:].reshape(-1), minlength=N) / (B * k)
        assert freq.shape == (N,) and np.abs(freq - 1 / N).max() < 0.01
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_nce_negatives_helper_is_the_ops_draw():
    """nce_negatives draws what the op's SampleLabels hold after the
    label (the split the tests and the card sweep rely on)."""
    ctx = TorchCtx(9, torch.device("cpu"))
    got = sampling_ops.nce_negatives(ctx, 5, 3, 7, torch.device("cpu"))
    out = torch_op("nce").lower(
        TorchCtx(9, torch.device("cpu")),
        {"Input": [torch.zeros(5, 2)], "Weight": [torch.zeros(7, 2)],
         "Label": [torch.zeros(5, 1, dtype=torch.int64)]},
        {"num_total_classes": 7, "num_neg_samples": 3})
    np.testing.assert_array_equal(out["SampleLabels"][0][:, 1:].numpy(),
                                  got.numpy())


@pytest.mark.parametrize("shape", [(4, 4), (6, 3), (2, 6, 1)])
def test_random_crop_offsets_and_slice(shape):
    """random_crop (torch's Philox, not JAX's threefry): over 200 seeds
    every crop is X's slice at some offset within [0, size - crop] on
    each cropped dim, every offset of that range is drawn, in both
    packages; one seed gives one crop."""
    x = np.arange(2 * 6 * 6 * 1, dtype="float32").reshape(2, 6, 6, 1)
    if len(shape) == 2:
        x = x[..., 0]
    lead = x.ndim - len(shape)
    limits = [x.shape[lead + i] - s for i, s in enumerate(shape)]
    attrs = {"shape": list(shape)}

    def offsets(out):
        # X is arange: the first cropped entry names its offsets
        flat = int(out.reshape(-1)[0])
        idx = np.unravel_index(flat, x.shape)
        off = idx[lead:]
        np.testing.assert_array_equal(
            out, x[(slice(None),) * lead + tuple(
                slice(o, o + s) for o, s in zip(off, shape))])
        return tuple(int(o) for o in off)

    seen = {"port": set(), "jax": set()}
    for seed in range(200):
        t = torch_op("random_crop").lower(
            TorchCtx(seed, torch.device("cpu")),
            {"X": [torch.from_numpy(x)]}, attrs)["Out"][0].numpy()
        j = np.asarray(jax_op("random_crop").lower(
            JaxCtx(jax.random.PRNGKey(seed)), {"X": [jnp.asarray(x)]},
            attrs)["Out"][0])
        seen["port"].add(offsets(t))
        seen["jax"].add(offsets(j))
    want = {tuple(o) for o in np.ndindex(*[lim + 1 for lim in limits])}
    assert seen["port"] == want and seen["jax"] == want
    again = [torch_op("random_crop").lower(
        TorchCtx(4, torch.device("cpu")), {"X": [torch.from_numpy(x)]},
        attrs)["Out"][0].numpy() for _ in range(2)]
    np.testing.assert_array_equal(*again)


def test_fill_bf16_rounds_as_jax():
    """fill in a dtype numpy lacks (bf16): the values JAX's ml_dtypes
    array holds, each rounded to nearest."""
    attrs = {"shape": [2, 2], "dtype": "bfloat16",
             "value": [1.0, 2.3, -7.77, 1e-3]}
    j = jax_op("fill").lower(JaxCtx(jax.random.PRNGKey(0)), {}, attrs)
    t = torch_op("fill").lower(TorchCtx(0, torch.device("cpu")), {}, attrs)
    assert t["Out"][0].dtype == torch.bfloat16
    np.testing.assert_array_equal(t["Out"][0].float().numpy(),
                                  np.asarray(j["Out"][0], "float32"))
