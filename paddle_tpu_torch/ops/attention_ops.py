"""Fused attention ops and the fused LM-head loss (counterpart of
paddle_tpu/ops/attention_ops.py: fused_attention :19, fused_mha :71 and
fused_lm_head_loss :173).

``fused_attention`` runs flash attention on pre-projected ``[B, T, H*d]``
q/k/v: the kernel reads them as ``[B, H, T, d]`` views through strides and
writes o straight into ``[B, T, H*d]``, with no transpose copy on either
side.  Its context-parallel branch (ring attention) is not ported yet
(ROADMAP queue A.7).

One op owns the q/k/v and output projection weights.  The projections run
with the WEIGHTS as the left operand, so q/k/v come out contiguous in the
head-major ``[H, d_head, B*T]`` layout that the flash kernel reads without
a transpose copy, and the output projection is one plain matmul over the
transposed ``[E, B*T]`` result.  The projections are plain products
outside any kernel (torch.matmul), as they are ``dot_general``s left to
XLA in the JAX package.

The JAX lowering pads tokens to a 128 granule for Mosaic's tiles; the
port's kernel masks ragged tiles itself, so nothing is padded here.  Both
ops are differentiable end to end: the projections through torch
autograd, the kernels through their ``torch.autograd.Function``s.

Under FLAGS_amp_bf16 the three ops take the JAX lowerings' AMP policy
(``amp_inputs``: the activations and the weights enter as bf16; the
projections, the flash kernels and the head run on bf16 operands with f32
accumulation).  ``fused_mha``'s output stays bf16 (``amp_result``),
``fused_attention``'s is cast back to its input's dtype (JAX
attention_ops.py:29-30, :63), the loss is f32.
"""
from __future__ import annotations

import torch

from ..core.enforce import EnforceNotMet
from ..framework.registry import register_op, single_input
from ..kernels.flash_attention import flash_attention, flash_attention_hdt
from ..kernels.lm_head import lm_head_xent
from .math_ops import amp_inputs, amp_result


@register_op("fused_attention")
def _fused_attention(ctx, ins, attrs):
    """Q [B, Tq, n_head*d], K and V [B, Tk, n_head*d] -> Out [B, Tq,
    n_head*d].  attrs: n_head, causal, scale (0 => 1/sqrt(d)).  Under
    AMP, q, k and v enter as bf16 and the output leaves in Q's dtype."""
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    orig_dtype = q.dtype
    q, k, v = amp_inputs(q, k, v)
    n_head = int(attrs["n_head"])
    causal = bool(attrs.get("causal", False))
    B, T, E = q.shape
    d = E // n_head

    def split(x):                  # [B, T, E] -> a [B, H, T, d] view
        return x.reshape(B, x.shape[1], n_head, d).transpose(1, 2)

    scale = float(attrs.get("scale", 0.0)) or None
    o = flash_attention(split(q), split(k), split(v), causal=causal,
                        scale=scale)
    return {"Out": [o.transpose(1, 2).reshape(B, T, E).to(orig_dtype)]}


@register_op("fused_mha")
def _fused_mha(ctx, ins, attrs):
    """X [B, T, D] (+ XKV [B, Tk, Dk] for cross-attention); Wq [D, E],
    Wk/Wv [Dk, E], Wo [E, D_out]; attrs n_head, causal."""
    x = ins["X"][0]
    wq, wk, wv = ins["Wq"][0], ins["Wk"][0], ins["Wv"][0]
    wo = ins["Wo"][0]
    n_head = int(attrs["n_head"])
    causal = bool(attrs.get("causal", False))
    B, T, D = x.shape
    E = int(wo.shape[0])
    dh = E // n_head
    if causal and ins.get("XKV"):
        raise EnforceNotMet(
            "fused_mha: causal masking is only defined for "
            "self-attention (positions of XKV and X differ)")
    xkv = ins["XKV"][0] if ins.get("XKV") else x
    Tk = xkv.shape[1]
    orig_dtype = x.dtype
    # AMP: bf16 operands, bf16 projections and o (f32 accumulation inside
    # the products), the output in bf16 (JAX attention_ops.py:102, :162-170)
    x, xkv, wq, wk, wv, wo = amp_inputs(x, xkv, wq, wk, wv, wo)
    xq2 = x.reshape(B * T, D)
    xk2 = xkv.reshape(B * Tk, -1)
    # weights as lhs: [E, B*T] comes out head-major, no transpose copy
    q = torch.matmul(wq.t(), xq2.t()).reshape(n_head, dh, B * T)
    k = torch.matmul(wk.t(), xk2.t()).reshape(n_head, dh, B * Tk)
    v = torch.matmul(wv.t(), xk2.t()).reshape(n_head, dh, B * Tk)
    o, _ = flash_attention_hdt(q, k, v, batch=B, causal=causal)
    out = torch.matmul(o.reshape(E, B * T).t(), wo)
    return {"Out": [amp_result(out.reshape(B, T, -1), orig_dtype)]}


@register_op("fused_lm_head_loss")
def _fused_lm_head_loss(ctx, ins, attrs):
    """X [N, D] activations, W [D, V] head weights, Label [N] int ->
    Loss [1] = sum_n loss_n / N over ALL N tokens, ignored ones included
    (their loss_n is 0), as the JAX lowering divides.  The streamed head
    kernel (kernels/lm_head.py) never holds the [N, V] logits; the
    backward goes through it in chunks of the ``chunk_size`` attr.  Any N
    and V: the JAX gates on N % 256 and d <= 2048 are Mosaic's."""
    x = single_input(ins, "X")
    w = single_input(ins, "W")
    label = single_input(ins, "Label").reshape(-1)
    n = x.shape[0]
    chunk = int(attrs.get("chunk_size", 2048))
    x, w = amp_inputs(x, w)     # AMP: bf16 x and W; the loss stays f32
    losses = lm_head_xent(x, w, label, chunk=chunk)
    return {"Loss": [(torch.sum(losses) / n).reshape(1)]}
