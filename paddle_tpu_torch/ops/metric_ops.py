"""In-graph metric ops (counterpart of paddle_tpu/ops/metric_ops.py:
accuracy :17, auc :32, mean_iou :68, precision_recall :86 and
edit_distance :117).

The histograms and counts are ``index_add`` of ones into f32 vectors:
atomic on the card, but sums of ones are exact below 2^24, so every
device gives the same bits.  auc's state is the persistable
StatPos/StatNeg pair, read in and written back as StatPosOut/StatNegOut.
"""
from __future__ import annotations

import torch

from ..framework.registry import register_op, single_input
from ._grad_rules import div


@register_op("accuracy")
def _accuracy(ctx, ins, attrs):
    """Inputs follow the reference: Out (top-k values), Indices (top-k
    ids), Label.  Accuracy (f32) is the share of rows whose label is among
    their indices; Correct and Total are int32 scalars, as the layer
    declares them."""
    idx = single_input(ins, "Indices")
    label = single_input(ins, "Label")
    if label.ndim >= 2 and label.shape[-1] == 1:
        label = label.squeeze(-1)
    hit = torch.any(idx == label[..., None].to(idx.dtype), dim=-1)
    correct = torch.sum(hit, dtype=torch.int32)
    total = torch.full((), hit.numel(), dtype=torch.int32, device=hit.device)
    acc = correct.float() / total.float()
    return {"Accuracy": [acc], "Correct": [correct], "Total": [total]}


def _counts(n, idx, weights):
    """An f32 [n] histogram: weights added at idx."""
    return torch.zeros(n, dtype=torch.float32, device=idx.device).index_add(
        0, idx, weights.to(torch.float32))


@register_op("auc")
def _auc(ctx, ins, attrs):
    """Histogram-bucketed streaming AUC (ref metrics/auc_op.cc): each
    prediction's bucket is p1 * num_thresholds in f32, truncated, then
    clipped to [0, num_thresholds]; the batch's histograms are added to
    StatPos/StatNeg, and the AUC is the trapezoid area under the ROC of
    the new histograms, swept from the highest threshold down."""
    preds = single_input(ins, "Predict")
    label = single_input(ins, "Label")
    stat_pos = single_input(ins, "StatPos").detach()
    stat_neg = single_input(ins, "StatNeg").detach()
    n = int(attrs.get("num_thresholds", 4095))
    preds = preds.detach()
    p1 = preds[:, 1] if preds.ndim == 2 and preds.shape[1] == 2 else (
        preds.reshape(-1))
    bucket = torch.clamp((p1 * n).to(torch.int32), 0, n).long()
    is_pos = label.reshape(-1) > 0
    new_pos = stat_pos + _counts(stat_pos.shape[0], bucket,
                                 is_pos).to(stat_pos.dtype)
    new_neg = stat_neg + _counts(stat_neg.shape[0], bucket,
                                 ~is_pos).to(stat_neg.dtype)
    tp = torch.flip(torch.cumsum(torch.flip(new_pos, [0]), 0), [0])
    fp = torch.flip(torch.cumsum(torch.flip(new_neg, [0]), 0), [0])
    tot_pos, tot_neg = tp[0], fp[0]
    zero = torch.zeros(1, dtype=tp.dtype, device=tp.device)
    tp_next = torch.cat([tp[1:], zero])
    fp_next = torch.cat([fp[1:], zero])
    area = torch.sum((fp - fp_next) * (tp + tp_next) / 2.0)
    auc = torch.where(tot_pos * tot_neg > 0,
                      area / (tot_pos * tot_neg + 1e-12),
                      torch.zeros((), dtype=area.dtype, device=area.device))
    return {"AUC": [auc.to(torch.float32)],
            "StatPosOut": [new_pos], "StatNegOut": [new_neg]}


@register_op("mean_iou")
def _mean_iou(ctx, ins, attrs):
    """Per class, intersection over union of the predicted and labelled
    sets; their mean over the classes either names.  OutWrong and
    OutCorrect are f32, as JAX's lowering gives them."""
    pred = single_input(ins, "Predictions").reshape(-1).long()
    label = single_input(ins, "Labels").reshape(-1).long()
    n = int(attrs["num_classes"])
    ones = torch.ones(pred.shape, dtype=torch.float32, device=pred.device)
    inter = _counts(n, pred, pred == label)
    union = _counts(n, pred, ones) + _counts(n, label, ones) - inter
    valid = union > 0
    zero = torch.zeros((), dtype=torch.float32, device=pred.device)
    iou = torch.where(valid, inter / torch.clamp_min(union, 1e-12), zero)
    miou = torch.sum(iou) / torch.clamp_min(
        torch.sum(valid.to(torch.float32)), 1.0)
    return {"OutMeanIou": [miou], "OutWrong": [union - inter],
            "OutCorrect": [inter]}


@register_op("precision_recall")
def _precision_recall(ctx, ins, attrs):
    """Macro and micro precision, recall and F1 over the per-class [tp,
    fp, fn] state (JAX's layout, not the reference's), accumulated in
    StatesInfo."""
    idx = single_input(ins, "Indices").reshape(-1).long()
    label = single_input(ins, "Labels").reshape(-1).long()
    states = single_input(ins, "StatesInfo")
    n = states.shape[0]
    right = idx == label
    tp = _counts(n, idx, right)
    fp = _counts(n, idx, ~right)
    fn = _counts(n, label, ~right)
    new = states + torch.stack([tp, fp, fn], dim=1)
    ctp, cfp, cfn = new[:, 0], new[:, 1], new[:, 2]
    prec = ctp / torch.clamp_min(ctp + cfp, 1.0)
    rec = ctp / torch.clamp_min(ctp + cfn, 1.0)
    f1 = 2 * prec * rec / torch.clamp_min(prec + rec, 1e-12)
    macro = torch.stack([torch.mean(prec), torch.mean(rec), torch.mean(f1)])
    stp, sfp, sfn = torch.sum(ctp), torch.sum(cfp), torch.sum(cfn)
    mp = stp / torch.clamp_min(stp + sfp, 1.0)
    mr = stp / torch.clamp_min(stp + sfn, 1.0)
    mf = 2 * mp * mr / torch.clamp_min(mp + mr, 1e-12)
    metrics = torch.cat([macro, torch.stack([mp, mr, mf])])
    return {"BatchMetrics": [metrics], "AccumMetrics": [metrics],
            "AccumStatesInfo": [new]}


@register_op("edit_distance")
def _edit_distance(ctx, ins, attrs):
    """Levenshtein distance of each row of Hyps [B, m] to the same row of
    Refs [B, n] (dense padded rows; ref edit_distance_op.cc), in f32.
    One step a hypothesis token, all rows and reference positions at
    once: with a[j] = min(prev[j] + 1, prev[j - 1] + cost) and cur[0] =
    i + 1, the row's recurrence cur[j] = min(a[j], cur[j - 1] + 1) is a
    running min, cummin(a - j) + j.  Tensor ops only, no branch on
    values, so the verifier's meta evaluation runs it."""
    hyp = single_input(ins, "Hyps")
    ref = single_input(ins, "Refs")
    if hyp.ndim == 1:
        hyp, ref = hyp[None], ref[None]
    b, m, n = hyp.shape[0], hyp.shape[1], ref.shape[1]
    j = torch.arange(n + 1, dtype=torch.float32, device=hyp.device)
    prev = j.expand(b, n + 1)
    for i in range(m):
        cost = (hyp[:, i:i + 1] != ref).to(torch.float32)       # [B, n]
        a = torch.minimum(prev[:, 1:] + 1, prev[:, :-1] + cost)
        a = torch.cat([torch.full((b, 1), i + 1.0, device=hyp.device), a],
                      dim=1)
        prev = torch.cummin(a - j, dim=1).values + j
    d = prev[:, n]
    if attrs.get("normalized", False):
        d = div(d, max(float(n), 1.0))
    return {"Out": [d[:, None]],
            "SequenceNum": [torch.tensor(b, dtype=torch.int64,
                                         device=hyp.device)]}
