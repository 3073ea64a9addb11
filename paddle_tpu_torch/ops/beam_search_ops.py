"""Beam search ops (counterpart of paddle_tpu/ops/beam_search_ops.py:
beam_search :22 and beam_search_decode :62).

Dense [batch, beam] tensors, as in the JAX package: one expansion step
is a masked add and a top-K over the K x V candidates of each row, and
the decode loop is layers.StaticRNN.  JAX takes the top K with
``lax.top_k``, which puts the lower flat index first among equal
scores; ``torch.topk`` promises no order among ties, so the port takes
the first K of a stable descending sort, which keeps that order.  Both
ops are integer bookkeeping on the scores: no gradient flows through
them.
"""
from __future__ import annotations

import torch

from ..framework.registry import register_op, single_input

NEG_INF = -1e9


@register_op("beam_search")
def _beam_search(ctx, ins, attrs):
    """One expansion step.

    Inputs: PreScores [B, K] cumulative log-probs (the first step's row
    is [0, -1e9, ...]); PreIds [B, K] each beam's last token; LogProbs
    [B, K, V] the next token's log-probs; optional State [B, K, ...].
    attrs: beam_size (K), end_id.  Outputs: Scores [B, K], Ids and
    Parents [B, K] int32 (Parents = flat index // V, Ids = flat index %
    V), and StateOut, State gathered by parent.

    A finished beam (PreIds == end_id) is frozen: its only continuation
    is end_id at no cost, so its score is carried unchanged."""
    pre_scores = single_input(ins, "PreScores")
    pre_ids = single_input(ins, "PreIds")
    log_probs = single_input(ins, "LogProbs")
    B, K, V = log_probs.shape
    end_id = int(attrs.get("end_id", 1))

    finished = pre_ids.to(torch.int32) == end_id                # [B, K]
    only_end = torch.full((V,), NEG_INF, dtype=log_probs.dtype,
                          device=log_probs.device)
    only_end[end_id] = 0.0
    step_lp = torch.where(finished[..., None], only_end, log_probs)
    total = pre_scores[..., None] + step_lp                     # [B, K, V]
    flat = total.reshape(B, K * V)
    order = torch.sort(flat, dim=1, descending=True, stable=True).indices
    idx = order[:, :K]                                          # [B, K]
    scores = torch.gather(flat, 1, idx)
    parents = torch.div(idx, V, rounding_mode="floor")
    outs = {"Scores": [scores], "Ids": [(idx % V).to(torch.int32)],
            "Parents": [parents.to(torch.int32)]}
    if ins.get("State"):
        # the beam reorder fused in: State [B, K, ...] gathered by parent
        state = ins["State"][0]
        rows = torch.arange(B, device=state.device)[:, None]
        outs["StateOut"] = [state[rows, parents]]
    return outs


@register_op("beam_search_decode")
def _beam_search_decode(ctx, ins, attrs):
    """Backtrack the stored steps into whole hypotheses.

    Inputs: Ids and Parents [T, B, K] (beam_search's per-step outputs
    stacked by the loop), Scores [B, K] the final cumulative scores.
    Outputs: SentenceIds [B, K, T] int32, SentenceScores [B, K] (Scores
    itself).  A loop from the last step back: each beam's token at step
    t, then its parent's beam at step t - 1."""
    ids = single_input(ins, "Ids").long()
    parents = single_input(ins, "Parents").long()
    scores = single_input(ins, "Scores")
    T, B, K = ids.shape
    beam = torch.arange(K, device=ids.device).expand(B, K)
    toks = []
    for t in range(T - 1, -1, -1):
        toks.append(torch.gather(ids[t], 1, beam))
        beam = torch.gather(parents[t], 1, beam)
    sent = torch.stack(toks[::-1], dim=-1).to(torch.int32)      # [B, K, T]
    return {"SentenceIds": [sent], "SentenceScores": [scores]}
