"""Loss ops (counterpart of paddle_tpu/ops/loss_ops.py: cross_entropy
:26, the classifiers' loss on probabilities, softmax_with_cross_entropy
:42, sigmoid_cross_entropy_with_logits :60, the CTR models' loss,
square_error_cost :74, the regression's, and the extras :80-201:
mse_loss, smooth_l1_loss, huber_loss, log_loss, hinge_loss,
modified_huber_loss, bpr_loss, margin_rank_loss, rank_loss, kldiv_loss
and npair_loss).  Integer labels carry a trailing dim of 1, as in the
reference.  Each spells JAX's formula; its ``where`` picks the same side
at a tie, so the gradients at the kinks are JAX's."""
from __future__ import annotations

import torch

from ..framework.registry import register_op, single_input
from . import _grad_rules


def _squeeze_label(label):
    if label.ndim >= 2 and label.shape[-1] == 1:
        return label.squeeze(-1)
    return label


@register_op("cross_entropy")
def _cross_entropy(ctx, ins, attrs):
    """X is a probability distribution (post-softmax): -log(p + 1e-20)
    of the label's entry, or -sum(label * log(p + 1e-20)) for soft
    labels; rows whose label is ignore_index lose 0."""
    x = single_input(ins)
    label = single_input(ins, "Label")
    ignore_index = int(attrs.get("ignore_index", -100))
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * torch.log(x + 1e-20), dim=-1,
                          keepdim=True)
    else:
        lab = _squeeze_label(label).long()[..., None]
        picked = torch.gather(x, -1, lab.clamp(0, x.shape[-1] - 1))
        loss = -torch.log(picked + 1e-20)
        loss = torch.where(lab == ignore_index, torch.zeros_like(loss),
                           loss)
    return {"Y": [loss]}


@register_op("softmax_with_cross_entropy")
def _softmax_xent(ctx, ins, attrs):
    logits = single_input(ins, "Logits")
    label = single_input(ins, "Label")
    ignore_index = int(attrs.get("ignore_index", -100))
    log_p = torch.log_softmax(logits.float(), dim=-1)
    softmax = torch.exp(log_p)
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * log_p, dim=-1, keepdim=True)
    else:
        lab = _squeeze_label(label).long()[..., None]
        # ignored labels may lie outside [0, V): gather from a clamped index
        # and zero those rows after
        picked = torch.gather(log_p, -1, lab.clamp(0, log_p.shape[-1] - 1))
        loss = torch.where(lab == ignore_index, torch.zeros_like(picked),
                           -picked)
    return {"Loss": [loss.to(logits.dtype)],
            "Softmax": [softmax.to(logits.dtype)]}


@register_op("sigmoid_cross_entropy_with_logits")
def _sigmoid_xent(ctx, ins, attrs):
    """The stable form max(x, 0) - x * label + log1p(exp(-|x|)); entries
    whose label is ignore_index lose 0, and ``normalize`` divides by the
    count of the others (at least 1)."""
    x = single_input(ins)
    label = single_input(ins, "Label")
    ignore_index = int(attrs.get("ignore_index", -100))
    # torch.maximum splits a tie's gradient as jnp.maximum does
    loss = (torch.maximum(x, torch.zeros_like(x)) - x * label
            + torch.log1p(torch.exp(-_grad_rules.abs(x))))
    ignored = label == ignore_index
    loss = torch.where(ignored, torch.zeros((), dtype=loss.dtype,
                                            device=loss.device), loss)
    if attrs.get("normalize", False):
        norm = torch.clamp_min(torch.sum((~ignored).to(loss.dtype)), 1.0)
        loss = loss / norm
    return {"Out": [loss]}


@register_op("square_error_cost")
def _square_error_cost(ctx, ins, attrs):
    x, label = ins["X"][0], ins["Label"][0]
    return {"Out": [torch.square(x - label)]}


@register_op("mse_loss")
def _mse_loss(ctx, ins, attrs):
    x, label = ins["X"][0], ins["Label"][0]
    return {"Out": [torch.mean(torch.square(x - label))]}


@register_op("smooth_l1_loss")
def _smooth_l1_loss(ctx, ins, attrs):
    """ref smooth_l1_loss_op.cc: the sigma^2-scaled Huber of (X - Y)
    (times InsideWeight), times OutsideWeight, summed over each row."""
    x, y = ins["X"][0], ins["Y"][0]
    sigma = float(attrs.get("sigma", 1.0))
    s2 = sigma * sigma
    diff = x - y
    if ins.get("InsideWeight"):
        diff = diff * ins["InsideWeight"][0]
    ad = torch.abs(diff)
    val = torch.where(ad < 1.0 / s2, 0.5 * s2 * torch.square(diff),
                      ad - 0.5 / s2)
    if ins.get("OutsideWeight"):
        val = val * ins["OutsideWeight"][0]
    out = torch.sum(val.reshape(val.shape[0], -1), dim=1, keepdim=True)
    return {"Out": [out], "Diff": [diff]}


@register_op("huber_loss")
def _huber_loss(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    delta = float(attrs.get("delta", 1.0))
    r = y - x
    ar = torch.abs(r)
    out = torch.where(ar <= delta, 0.5 * torch.square(r),
                      delta * (ar - 0.5 * delta))
    return {"Out": [out], "Residual": [r]}


@register_op("log_loss")
def _log_loss(ctx, ins, attrs):
    p = single_input(ins, "Predicted")
    label = single_input(ins, "Labels")
    eps = float(attrs.get("epsilon", 1e-4))
    return {"Loss": [-label * torch.log(p + eps)
                     - (1 - label) * torch.log(1 - p + eps)]}


@register_op("hinge_loss")
def _hinge_loss(ctx, ins, attrs):
    logits = single_input(ins, "Logits")
    label = single_input(ins, "Labels")
    return {"Loss": [torch.relu(1.0 - (2.0 * label - 1.0) * logits)]}


@register_op("modified_huber_loss")
def _modified_huber_loss(ctx, ins, attrs):
    x = single_input(ins)
    y = single_input(ins, "Y")
    z = x * (2.0 * y - 1.0)
    out = torch.where(z >= -1.0, torch.square(torch.relu(1.0 - z)),
                      -4.0 * z)
    return {"Out": [out], "IntermediateVal": [z]}


@register_op("bpr_loss")
def _bpr_loss(ctx, ins, attrs):
    """Bayesian personalized ranking (ref bpr_loss_op.cc): the mean over
    the classes of log(1 + exp(x_j - x_label))."""
    x = single_input(ins)
    label = _squeeze_label(single_input(ins, "Label")).long()
    pos = torch.gather(x, -1, label[..., None])
    return {"Y": [torch.mean(torch.log1p(torch.exp(x - pos)), dim=-1,
                             keepdim=True)]}


@register_op("margin_rank_loss")
def _margin_rank_loss(ctx, ins, attrs):
    x1, x2 = ins["X1"][0], ins["X2"][0]
    label = single_input(ins, "Label")
    out = torch.relu(-label * (x1 - x2) + float(attrs.get("margin", 0.0)))
    return {"Out": [out], "Activated": [(out > 0).to(x1.dtype)]}


@register_op("rank_loss")
def _rank_loss(ctx, ins, attrs):
    label = single_input(ins, "Label")
    d = ins["Left"][0] - ins["Right"][0]
    return {"Out": [torch.log1p(torch.exp(d)) - label * d]}


@register_op("kldiv_loss")
def _kldiv_loss(ctx, ins, attrs):
    """target * (log(target + 1e-20) - x), reduced by ``reduction``:
    mean, sum, batchmean (the sum over the batch size) or none."""
    x = single_input(ins)
    target = single_input(ins, "Target")
    loss = target * (torch.log(target + 1e-20) - x)
    red = attrs.get("reduction", "mean")
    if red == "mean":
        loss = torch.mean(loss)
    elif red == "sum":
        loss = torch.sum(loss)
    elif red == "batchmean":
        loss = torch.sum(loss) / x.shape[0]
    return {"Loss": [loss]}


@register_op("npair_loss")
def _npair_loss(ctx, ins, attrs):
    """The softmax cross entropy of anchor-positive similarities against
    the same-label share of each row, plus l2_reg times the mean squared
    norms (ref npair_loss in layers/nn.py)."""
    anchor = single_input(ins, "Anchor")
    positive = single_input(ins, "Positive")
    labels = single_input(ins, "Labels").to(torch.float32)
    l2 = float(attrs.get("l2_reg", 0.002))
    sim = anchor @ positive.T
    lab = labels.reshape(-1, 1)
    same = (lab == lab.T).to(torch.float32)
    same = same / torch.sum(same, dim=1, keepdim=True)
    logp = torch.log_softmax(sim, dim=1)
    xent = -torch.mean(torch.sum(same * logp, dim=1))
    reg = l2 * (torch.mean(torch.sum(torch.square(anchor), 1))
                + torch.mean(torch.sum(torch.square(positive), 1))) / 2.0
    return {"Out": [xent + reg]}
