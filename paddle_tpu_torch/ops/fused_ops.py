"""The fused transformer block op (counterpart of
paddle_tpu/ops/fused_ops.py: fused_transformer_block :464),
depthwise_conv2d_transpose (:238), fake_quantize_range_abs_max (:246)
and the tensor-array plumbing rnn_memory_helper (:297), write_to_array
(:304) and read_from_array (:329)."""
from __future__ import annotations

import torch

from ..core.enforce import EnforceNotMet
from ..framework.registry import register_op, single_input
from ..kernels.fused_block import transformer_block
from ._grad_rules import clip, div
from .math_ops import amp_inputs, amp_result
from .nn_ops import _conv2d_transpose
from .quantize_ops import _ste_round

# the op's parameter slots, in transformer_block's params order
BLOCK_SLOTS = ("Ln1Scale", "Ln1Bias", "Wq", "Wk", "Wv", "Wo", "Ln2Scale",
               "Ln2Bias", "W1", "B1", "W2", "B2")
# the slots AMP casts with X: the matrices (JAX fused_ops.py:491-496)
MATRIX_SLOTS = ("Wq", "Wk", "Wv", "Wo", "W1", "W2")


@register_op("fused_transformer_block")
def _fused_transformer_block(ctx, ins, attrs):
    """One whole pre-norm transformer block (LN -> MHA -> residual -> LN
    -> MLP -> residual) as a single op, emitted by
    transpiler/fused_block.py (FLAGS_fuse_block).

    X [B, T, D]; Wq/Wk/Wv [D, E], Wo [E, D], W1 [D, F], W2 [F, D], LN
    scales/biases [D], B1 [F], B2 [D].  attrs: n_head, causal, eps1, eps2.
    Lowers to ``kernels/fused_block.transformer_block``: the block kernel
    of X's dtype on the card, its plain version on the CPU and on meta
    tensors (shape inference).  Under FLAGS_amp_bf16, the JAX lowering's
    policy (JAX ops/fused_ops.py:479-501): ``amp_inputs`` casts X and the
    six matrices to bf16 (the LN params and biases stay f32), and the
    output goes through ``amp_result``, so a block's bf16 output stays
    bf16 and the next block takes bf16 X; the weight gradients flow back
    to the f32 masters through the casts."""
    x = single_input(ins)
    orig = x.dtype
    params = {s: single_input(ins, s) for s in BLOCK_SLOTS}
    x, *mats = amp_inputs(x, *(params[s] for s in MATRIX_SLOTS))
    params.update(zip(MATRIX_SLOTS, mats))
    out = transformer_block(
        x, tuple(params[s] for s in BLOCK_SLOTS),
        n_head=int(attrs["n_head"]),
        causal=bool(attrs.get("causal", False)),
        eps1=float(attrs.get("eps1", 1e-5)),
        eps2=float(attrs.get("eps2", 1e-5)))
    return {"Out": [amp_result(out, orig)]}


@register_op("depthwise_conv2d_transpose")
def _depthwise_conv2d_transpose(ctx, ins, attrs):
    """ref conv_transpose_op.cc's depthwise variant: conv2d_transpose
    with groups = the input's channels."""
    x = single_input(ins, "Input")
    return _conv2d_transpose(ctx, ins, dict(attrs, groups=int(x.shape[1])))


@register_op("fake_quantize_range_abs_max")
def _fake_quantize_range_abs_max(ctx, ins, attrs):
    """ref fake_quantize_op.cc range_abs_max: quantize against the max of
    |x|-maxes over the last `window_size` steps.  Stateful form: Iter ([1]
    step counter) and InScales (the circular history) fed, both updated and
    written back as OutIter / OutScales (detached: they are state); the fed
    buffer's length is the window.  Stateless form (no Iter / InScales): the
    running max of InScale and |x|'s max, which never decays (JAX's
    documented approximation)."""
    x = single_input(ins, "X")
    qmax = float(2 ** (int(attrs.get("bit_length", 8)) - 1) - 1)
    window = int(attrs.get("window_size", 10000))
    cur = torch.abs(x).max()
    outs = {}
    if ins.get("Iter") and ins.get("InScales"):
        it = ins["Iter"][0].reshape(()).to(torch.int32)
        hist = ins["InScales"][0].reshape(-1)[:window]
        window = hist.shape[0]
        slots = torch.arange(window, device=hist.device)
        hist = torch.where(slots == torch.remainder(it, window),
                           cur.to(hist.dtype), hist)
        seen = torch.clamp(it + 1, max=window)
        scale = torch.where(slots < seen, hist,
                            torch.zeros((), dtype=hist.dtype,
                                        device=hist.device)).max()
        outs["OutScales"] = [hist.detach()]
        outs["OutIter"] = [(it + 1).reshape(1)]
    else:
        in_scale = (ins["InScale"][0].reshape(()) if ins.get("InScale")
                    else cur)
        scale = torch.maximum(cur, in_scale)
    q = clip(_ste_round(x / clip(scale, 1e-8) * qmax), -qmax, qmax)
    outs.update({"Out": [div(q * scale, qmax)],
                 "OutScale": [scale.reshape(1)]})
    return outs


@register_op("rnn_memory_helper")
def _rnn_memory_helper(ctx, ins, attrs):
    """ref rnn_memory_helper_op.cc: the identity that threads RNN state
    across steps (its gradient the identity too)."""
    return {"Out": [single_input(ins, "X")]}


def _array_index(i, n):
    """The row a tensor-array index names, as lax.dynamic_index_in_dim
    and dynamic_update_index_in_dim take it: a negative index wraps once,
    then the index is clamped into [0, n - 1] (on a length-3 array 5 and
    -1 name row 2, -5 row 0).  A [1] int64 tensor: nothing syncs."""
    i = i.reshape(1).long()
    return torch.clamp(torch.where(i < 0, i + n, i), 0, n - 1)


@register_op("write_to_array")
def _write_to_array(ctx, ins, attrs):
    """ref tensor_array_read_write_op.cc, dense: the array is an [N, ...]
    tensor and X is written into row I (``_array_index``'s rule).
    Consecutive writes thread the array: the previous write's Out is the
    next one's Array input; the first write of a fresh array gives its
    length in the ``array_len`` attr instead."""
    x = single_input(ins, "X")
    if ins.get("Array"):
        arr = ins["Array"][0]
    else:
        if "array_len" not in attrs:
            raise EnforceNotMet(
                "write_to_array without an Array input needs the "
                "array_len attr (the fresh array's length); chained "
                "writes must thread the previous Out into Array")
        arr = x.new_zeros((int(attrs["array_len"]),) + tuple(x.shape))
    i = _array_index(single_input(ins, "I"), arr.shape[0])
    return {"Out": [arr.index_copy(0, i, x.unsqueeze(0).to(arr.dtype))]}


@register_op("read_from_array")
def _read_from_array(ctx, ins, attrs):
    """Row I of the [N, ...] array X (``_array_index``'s rule)."""
    x = single_input(ins, "X")
    i = _array_index(single_input(ins, "I"), x.shape[0])
    return {"Out": [x.index_select(0, i).squeeze(0)]}
