"""Loss ops (counterpart of paddle_tpu/ops/loss_ops.py: cross_entropy
:26, the classifiers' loss on probabilities, softmax_with_cross_entropy
:42, sigmoid_cross_entropy_with_logits :60, the CTR models' loss, and
square_error_cost :74, the regression's).  Integer labels carry a
trailing dim of 1, as in the reference."""
from __future__ import annotations

import torch

from ..framework.registry import register_op, single_input


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
            + torch.log1p(torch.exp(-torch.abs(x))))
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
