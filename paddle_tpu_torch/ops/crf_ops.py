"""Linear-chain CRF and CTC ops (counterpart of paddle_tpu/ops/crf_ops.py:
linear_chain_crf :38, crf_decoding :91, warpctc :141, ctc_align :212 and
chunk_eval :234).

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

CTC (the reference's vendored warp-ctc) is JAX's log-semiring recursion
over the blank-extended label, NEG = -1e9 standing for log 0, as a loop
over T in JAX's float order; its gradient is autograd through the loop,
as JAX's is jax.vjp through its scan (torch.maximum splits a tie's
gradient as lax.max does).
"""
from __future__ import annotations

import torch

from ..framework.registry import register_op, single_input

NEG = -1e9


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


def _shifted(a, k, fill):
    """a [B, E] moved k places right along E, `fill` in the first k."""
    return torch.cat([torch.full((a.shape[0], k), fill, dtype=a.dtype,
                                 device=a.device), a[:, :-k]], dim=1)


@register_op("warpctc")
def _warpctc(ctx, ins, attrs):
    """CTC loss (ref warpctc_op.cc): Logits [B, T, C] unnormalised, Label
    [B, S] int (padded with -1 or the blank past each label's length),
    optional LogitsLength and LabelLength [B].  Loss [B, 1] = -log p(label
    | logits), divided by the logits' length under ``norm_by_times``.
    A row's recursion freezes past its LogitsLength; without a
    LabelLength, a label's length counts its entries >= 0 and not the
    blank.  In f32 whatever the logits' dtype."""
    logits = single_input(ins, "Logits").float()
    label = single_input(ins, "Label")
    if label.ndim == 3:
        label = label[..., 0]
    label = label.long()
    B, T, _ = logits.shape
    S = label.shape[1]
    blank = int(attrs.get("blank", 0))
    dev = logits.device
    lp = torch.log_softmax(logits, dim=-1)
    t_lens = (ins["LogitsLength"][0].reshape(B).long()
              if ins.get("LogitsLength")
              else torch.full((B,), T, dtype=torch.int64, device=dev))
    l_lens = (ins["LabelLength"][0].reshape(B).long()
              if ins.get("LabelLength")
              else ((label >= 0) & (label != blank)).sum(dim=1))
    # the extended label: blank l1 blank l2 ... lS blank (2S + 1)
    E = 2 * S + 1
    lab = torch.where(label < 0, torch.full_like(label, blank), label)
    ext = torch.full((B, E), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = lab
    valid = torch.arange(E, device=dev)[None, :] < (2 * l_lens + 1)[:, None]
    can_skip = (ext != blank) & (ext != _shifted(ext, 2, -1))
    # each step's log-probs of the extended label's symbols, [B, T, E]
    lp_ext = torch.gather(lp, 2, ext[:, None, :].expand(B, T, E))
    neg = torch.full((B, E), NEG, device=dev)
    a = torch.cat([lp_ext[:, 0, :1],
                   torch.where(l_lens[:, None] > 0, lp_ext[:, 0, 1:2],
                               neg[:, :1]),
                   neg[:, 2:]], dim=1)
    for t in range(1, T):
        stay = a
        prev1 = _shifted(a, 1, NEG)
        prev2 = torch.where(can_skip, _shifted(a, 2, NEG), neg)
        m = torch.maximum(stay, torch.maximum(prev1, prev2))
        m_safe = torch.maximum(m, neg)
        summed = (torch.exp(stay - m_safe) + torch.exp(prev1 - m_safe)
                  + torch.exp(prev2 - m_safe))
        new = torch.where(valid, m_safe + torch.log(summed) + lp_ext[:, t],
                          neg)
        a = torch.where((t < t_lens)[:, None], new, a)
    rows = torch.arange(B, device=dev)
    end1 = a[rows, torch.clamp(2 * l_lens, 0, E - 1)]      # the last blank
    end2 = torch.where(l_lens > 0, a[rows, torch.clamp(2 * l_lens - 1, 0,
                                                       E - 1)], neg[:, 0])
    m = torch.maximum(end1, end2)
    loss = -(m + torch.log(torch.exp(end1 - m) + torch.exp(end2 - m)))
    if attrs.get("norm_by_times"):
        loss = loss / t_lens.float()
    return {"Loss": [loss[:, None]]}


@register_op("ctc_align")
def _ctc_align(ctx, ins, attrs):
    """ref ctc_align_op.cc: repeats collapsed, then blanks dropped.  Input
    [B, T] (or [B, T, 1]) ids; Output [B, T] int32, the kept ids packed to
    the left in order, ``padding_value`` after them (the dense stand-in
    for the LoD shrink).  The packing is a stable sort of the dropped
    flags as int32 (a stable sort of bools, on every device)."""
    x = single_input(ins, "Input")
    if x.ndim == 3:
        x = x[..., 0]
    x = x.to(torch.int32)
    blank = int(attrs.get("blank", 0))
    pad = int(attrs.get("padding_value", 0))
    keep = (x != blank) & (x != _shifted(x, 1, -1))
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    packed = torch.gather(x, 1, order)
    return {"Output": [torch.where(torch.gather(keep, 1, order), packed,
                                   torch.full_like(packed, pad))]}


@register_op("chunk_eval")
def _chunk_eval(ctx, ins, attrs):
    """Chunk precision, recall and F1 of IOB tags (ref chunk_eval_op.cc,
    the plain IOB scheme): Inference and Label [B, T] ints, tag = type *
    2 (+0 B, +1 I), ids from 2 * num_chunk_types on Outside; the
    ``excluded_chunk_types`` count as Outside; optional Mask [B, T].  A
    chunk starts at a B, or at an I after Outside or another type; a
    pair of chunks is correct when both start and end together with one
    type.  The three rates [1] f32; the counts [1] int64."""
    inf = single_input(ins, "Inference")
    lab = single_input(ins, "Label")
    if inf.ndim == 3:
        inf = inf[..., 0]
    if lab.ndim == 3:
        lab = lab[..., 0]
    inf, lab = inf.long(), lab.long()
    mask = (ins["Mask"][0].to(torch.bool) if ins.get("Mask")
            else torch.ones(inf.shape, dtype=torch.bool, device=inf.device))
    outside = 2 * int(attrs["num_chunk_types"])
    for ex in attrs.get("excluded_chunk_types", []) or []:
        inf = torch.where(inf // 2 == int(ex), outside, inf)
        lab = torch.where(lab // 2 == int(ex), outside, lab)

    def starts(tags):
        prev = _shifted(tags, 1, outside)
        is_b = (tags % 2 == 0) & (tags < outside)
        is_i = (tags % 2 == 1) & (tags < outside)
        i_start = is_i & ((prev >= outside) | (prev // 2 != tags // 2))
        return (is_b | i_start) & mask

    def next_breaks(st, inside):
        """Whether the chunk ends at each step: the next step starts a
        chunk or lies outside (past the end counts)."""
        brk = st | ~inside
        return torch.cat([brk[:, 1:], torch.ones_like(brk[:, :1])], dim=1)

    inf_st, lab_st = starts(inf), starts(lab)
    inf_in = (inf < outside) & mask
    lab_in = (lab < outside) & mask
    inf_end = inf_in & next_breaks(inf_st, inf_in)
    lab_end = lab_in & next_breaks(lab_st, lab_in)
    type_eq = (inf // 2) == (lab // 2)
    in_ok = torch.zeros(inf.shape[0], dtype=torch.bool, device=inf.device)
    count = torch.zeros(inf.shape[0], dtype=torch.int64, device=inf.device)
    for t in range(inf.shape[1]):
        both = inf_st[:, t] & lab_st[:, t] & type_eq[:, t]
        cont = (in_ok & inf_in[:, t] & lab_in[:, t] & ~inf_st[:, t]
                & ~lab_st[:, t] & type_eq[:, t])
        in_ok = both | cont
        close = in_ok & inf_end[:, t] & lab_end[:, t]
        count = count + close.long()
        in_ok = in_ok & ~close
    correct = count.sum()
    num_inf = inf_st.long().sum()
    num_lab = lab_st.long().sum()
    precision = correct / torch.clamp(num_inf, min=1)
    recall = correct / torch.clamp(num_lab, min=1)
    f1 = 2 * precision * recall / torch.clamp(precision + recall, min=1e-12)
    return {"Precision": [precision.float().reshape(1)],
            "Recall": [recall.float().reshape(1)],
            "F1-Score": [f1.float().reshape(1)],
            "NumInferChunks": [num_inf.reshape(1)],
            "NumLabelChunks": [num_lab.reshape(1)],
            "NumCorrectChunks": [correct.reshape(1)]}
