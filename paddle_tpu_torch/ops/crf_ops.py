"""Linear-chain CRF ops (counterpart of paddle_tpu/ops/crf_ops.py:
linear_chain_crf :38 and crf_decoding :91).

Dense [B, T] batches with an optional float mask instead of LoD, as in
the JAX package, whose recurrences are log-semiring ``lax.scan``s; here
each is a Python loop over T, and autograd over the forward recursion
gives the loss's gradient.  Both ops compute in f32 whatever the input
dtype (the JAX lowerings cast first), so FLAGS_amp_bf16 does not reach
them.

Transition layout (the reference's linear_chain_crf_op.h): [N+2, N],
row 0 the start weights, row 1 the stop weights, rows 2.. the [N, N]
matrix w[i, j] = score(tag i -> tag j).  A sequence's length is its mask's
sum (T without a mask); past it the recursions hold their state.
"""
from __future__ import annotations

import torch

from ..framework.registry import register_op, single_input


def _terms(trans):
    return trans[0], trans[1], trans[2:]


def _seq_lens(ins, B, T, device):
    if ins.get("Mask"):
        return ins["Mask"][0].float().sum(dim=1).to(torch.int32)
    return torch.full((B,), T, dtype=torch.int32, device=device)


def _label(ins):
    label = single_input(ins, "Label")
    if label.ndim == 3:
        label = label[..., 0]
    return label.long()


@register_op("linear_chain_crf")
def _linear_chain_crf(ctx, ins, attrs):
    """Emission [B, T, N], Transition [N+2, N], Label [B, T] (or [B, T,
    1]) int, optional Mask [B, T] (1 a token).  Outputs LogLikelihood
    [B, 1] (the loss is -mean), Alpha [B, T, N] the forward recursion's
    log-space states, and EmissionExps / TransitionExps, exp of the
    inputs, kept for the reference's slots."""
    em = single_input(ins, "Emission").float()
    trans = single_input(ins, "Transition").float()
    label = _label(ins)
    B, T, N = em.shape
    start, stop, w = _terms(trans)
    lens = _seq_lens(ins, B, T, em.device)

    # the partition function: alpha in log space
    a = start[None, :] + em[:, 0]                               # [B, N]
    alphas = [a]
    for t in range(1, T):
        nxt = torch.logsumexp(a[:, :, None] + w[None, :, :], dim=1) \
            + em[:, t]
        a = torch.where((t < lens)[:, None], nxt, a)
        alphas.append(a)
    alpha = torch.stack(alphas, dim=1)
    log_z = torch.logsumexp(a + stop[None, :], dim=1)

    # the gold path's score
    rows = torch.arange(B, device=em.device)
    gold = start[label[:, 0]] + em[rows, 0, label[:, 0]]
    for t in range(1, T):
        step = w[label[:, t - 1], label[:, t]] + em[rows, t, label[:, t]]
        gold = gold + (t < lens).float() * step
    last = torch.clamp(lens.long() - 1, 0, T - 1)
    gold = gold + stop[label[rows, last]]

    return {"LogLikelihood": [(gold - log_z)[:, None]], "Alpha": [alpha],
            "EmissionExps": [torch.exp(em)],
            "TransitionExps": [torch.exp(trans)]}


@register_op("crf_decoding")
def _crf_decoding(ctx, ins, attrs):
    """Viterbi decode: Emission [B, T, N], Transition [N+2, N], optional
    Mask.  Output ViterbiPath [B, T] int32 (0 at padded steps); with a
    Label, 1 where the path equals it and 0 elsewhere instead (the
    reference's output under Label).  Ties take the first index, as
    jnp.argmax and torch.argmax do."""
    em = single_input(ins, "Emission").float()
    trans = single_input(ins, "Transition").float()
    B, T, N = em.shape
    start, stop, w = _terms(trans)
    lens = _seq_lens(ins, B, T, em.device)

    v = start[None, :] + em[:, 0]
    ptrs = []
    for t in range(1, T):
        cand = v[:, :, None] + w[None, :, :]                    # [B, i, j]
        ptrs.append(torch.argmax(cand, dim=1))
        v = torch.where((t < lens)[:, None],
                        cand.amax(dim=1) + em[:, t], v)
    tag = torch.argmax(v + stop[None, :], dim=1)
    rows = torch.arange(B, device=em.device)
    path = [tag]
    for t in range(T - 1, 0, -1):
        prev = ptrs[t - 1][rows, tag]
        # past a sequence's end the chain stays at its last tag
        tag = torch.where(t <= lens.long() - 1, prev, tag)
        path.append(tag)
    path = torch.stack(path[::-1], dim=1).to(torch.int32)
    if ins.get("Mask"):
        path = path * (ins["Mask"][0] > 0).to(torch.int32)
    if ins.get("Label"):
        correct = (path == _label(ins).to(torch.int32)).to(torch.int32)
        if ins.get("Mask"):
            correct = correct * (ins["Mask"][0] > 0).to(torch.int32)
        return {"ViterbiPath": [correct]}
    return {"ViterbiPath": [path]}
