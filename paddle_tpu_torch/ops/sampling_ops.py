"""Sampled and structured classification losses (counterpart of
paddle_tpu/ops/sampling_ops.py: nce :19, hierarchical_sigmoid :55,
teacher_student_sigmoid_loss :100 and positive_negative_pair :117).

Dense batched math as in the JAX package.  nce is a draw and a cost:
``nce_negatives`` draws the uniform negatives from the op's generator
(torch's Philox, not JAX's threefry: ROADMAP C), and ``nce_cost`` is
JAX's formula as a function of the drawn samples, which is what the
tests hold to JAX's.  The stable sigmoid cross entropies take lax.abs's
gradient at 0 and jnp.clip's at a bound (``_grad_rules``), and
torch.maximum splits a tie with 0 as lax.max does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework.registry import register_op, single_input
from ._grad_rules import abs as jabs
from ._grad_rules import clip


def _sigmoid_xent(z, target):
    """max(z, 0) - z * target + log1p(exp(-|z|)), JAX's spelling."""
    return (torch.maximum(z, torch.zeros_like(z)) - z * target
            + torch.log1p(torch.exp(-jabs(z))))


def _labels(ins, slot="Label"):
    label = single_input(ins, slot)
    if label.ndim == 2:
        label = label[:, 0]
    return label.long()


def nce_negatives(ctx, batch, k, n, device):
    """[batch, k] negatives drawn uniformly from [0, n) by the op's
    generator (zeros on a meta evaluation, which draws nothing)."""
    gen = ctx.rng()
    if gen is None:
        return torch.zeros((batch, k), dtype=torch.int64, device=device)
    return torch.randint(0, n, (batch, k), generator=gen, device=device)


def nce_cost(x, w, bias, samples, n, k):
    """(Cost [B, 1], SampleLogits [B, 1 + k]) of the samples [B, 1 + k]
    (the label first): each sample's logit less log(k / n), the uniform
    noise's log-odds, through the sigmoid cross entropy against 1 for the
    label and 0 for the negatives, summed over the samples."""
    logits = torch.bmm(w[samples], x[:, :, None])[..., 0]
    if bias is not None:
        logits = logits + bias[samples]
    adj = logits - float(np.float32(np.log(k / n)))
    target = torch.zeros_like(adj)
    target[:, 0] = 1.0
    return _sigmoid_xent(adj, target).sum(dim=1, keepdim=True), logits


@register_op("nce")
def _nce(ctx, ins, attrs):
    """Noise-contrastive estimation (ref nce_op.cc, the uniform sampler):
    Input [B, D], Weight [N, D], optional Bias [N], Label [B] (or [B,
    1]); attrs num_total_classes N and num_neg_samples k (10).  Cost [B,
    1], SampleLogits [B, 1 + k] and SampleLabels [B, 1 + k] (int64, the
    label then the negatives).  In f32."""
    x = single_input(ins, "Input").float()
    w = single_input(ins, "Weight").float()
    label = _labels(ins)
    bias = ins["Bias"][0].float() if ins.get("Bias") else None
    n = int(attrs.get("num_total_classes", w.shape[0]))
    k = int(attrs.get("num_neg_samples", 10))
    neg = nce_negatives(ctx, x.shape[0], k, n, x.device)
    samples = torch.cat([label[:, None], neg], dim=1)
    cost, logits = nce_cost(x, w, bias, samples, n, k)
    return {"Cost": [cost], "SampleLogits": [logits],
            "SampleLabels": [samples]}


@register_op("hierarchical_sigmoid")
def _hierarchical_sigmoid(ctx, ins, attrs):
    """Hierarchical sigmoid over the reference's default complete binary
    tree (ref hierarchical_sigmoid_op.cc, math/matrix_bit_code.h): class c
    is heap node c + num_classes; each of the ceil(log2(num_classes))
    steps up takes the parent's W row (node // 2 - 1, clipped into W)
    and the child's side as the bit.  X [B, D], W [num_classes - 1, D],
    Label [B], optional Bias [num_classes - 1].  Out [B, 1] the summed
    sigmoid cross entropies of the steps inside the tree, PreOut [B,
    depth] every step's logit.  In f32."""
    x = single_input(ins, "X").float()
    w = single_input(ins, "W").float()
    label = _labels(ins)
    bias = ins["Bias"][0].float() if ins.get("Bias") else None
    num_classes = int(attrs["num_classes"])
    depth = max(1, int(np.ceil(np.log2(max(num_classes, 2)))))
    node = label + num_classes
    costs = x.new_zeros(x.shape[0])
    pre = []
    for _ in range(depth):
        parent = node // 2
        row = parent - 1
        row_c = torch.clamp(row, 0, w.shape[0] - 1)
        z = (x * w[row_c]).sum(dim=1)
        if bias is not None:
            z = z + bias[row_c]
        step = _sigmoid_xent(z, (node % 2).float())
        costs = costs + torch.where((parent >= 1) & (row >= 0), step,
                                    torch.zeros_like(step))
        pre.append(z)
        node = parent
    return {"Out": [costs[:, None]], "PreOut": [torch.stack(pre, dim=1)]}


@register_op("teacher_student_sigmoid_loss")
def _ts_sigmoid_loss(ctx, ins, attrs):
    """ref teacher_student_sigmoid_loss_op.cc: where 0 < label < 1 (a
    teacher's soft score), log1p(exp(z_c)) - label * z_c with z clipped to
    [soft_max_lower_bound, soft_max_up_bound]; elsewhere the sigmoid cross
    entropy against label > 0.5.  In f32."""
    x = single_input(ins, "X").float()
    label = single_input(ins, "Label").float()
    up = float(attrs.get("soft_max_up_bound", 15.0))
    lo = float(attrs.get("soft_max_lower_bound", -15.0))
    z = x.reshape(label.shape)
    ce = _sigmoid_xent(z, (label > 0.5).float())
    zc = clip(z, lo, up)
    soft = torch.log1p(torch.exp(zc)) - label * zc
    return {"Y": [torch.where((label > 0.0) & (label < 1.0), soft, ce)]}


@register_op("positive_negative_pair")
def _positive_negative_pair(ctx, ins, attrs):
    """ref positive_negative_pair_op.cc: over the pairs of one query with
    different labels, how many the scores order as the labels do
    (PositivePair), against them (NegativePair) or tie (NeutralPair),
    each [1] f32.  Score, Label, QueryID [N, 1]."""
    score = single_input(ins, "Score").reshape(-1).float()
    label = single_input(ins, "Label").reshape(-1).float()
    qid = single_input(ins, "QueryID").reshape(-1).long()
    n = score.shape[0]
    upper = torch.ones((n, n), dtype=torch.bool, device=score.device).triu(1)
    pairs = (qid[:, None] == qid[None, :]) & (label[:, None] != label[None, :]) \
        & upper
    si, sj = score[:, None], score[None, :]
    margin = torch.where(label[:, None] > label[None, :], si - sj, sj - si)

    def count(hit):
        return (pairs & hit).float().sum().reshape(1)

    return {"PositivePair": [count(margin > 0)],
            "NegativePair": [count(margin < 0)],
            "NeutralPair": [count(margin == 0)]}
