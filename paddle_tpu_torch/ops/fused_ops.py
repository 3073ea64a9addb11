"""The fused transformer block op (counterpart of
paddle_tpu/ops/fused_ops.py: fused_transformer_block :464)."""
from __future__ import annotations

from ..core import flags
from ..core.enforce import EnforceNotMet
from ..framework.registry import register_op, single_input
from ..kernels.fused_block import transformer_block

# the op's parameter slots, in transformer_block's params order
BLOCK_SLOTS = ("Ln1Scale", "Ln1Bias", "Wq", "Wk", "Wv", "Wo", "Ln2Scale",
               "Ln2Bias", "W1", "B1", "W2", "B2")


@register_op("fused_transformer_block")
def _fused_transformer_block(ctx, ins, attrs):
    """One whole pre-norm transformer block (LN -> MHA -> residual -> LN
    -> MLP -> residual) as a single op, emitted by
    transpiler/fused_block.py (FLAGS_fuse_block).

    X [B, T, D]; Wq/Wk/Wv [D, E], Wo [E, D], W1 [D, F], W2 [F, D], LN
    scales/biases [D], B1 [F], B2 [D].  attrs: n_head, causal, eps1, eps2.
    Lowers to ``kernels/fused_block.transformer_block``: the block kernel
    on the card, its plain version on the CPU and on meta tensors (shape
    inference).  f32 only: the JAX lowering's AMP casts (JAX
    ops/fused_ops.py:479-501) and the bf16 block kernel are ROADMAP B.8d,
    so under FLAGS_amp_bf16 the op refuses to run."""
    if flags.get_flag("amp_bf16"):
        raise EnforceNotMet(
            "fused_transformer_block: no AMP policy under FLAGS_amp_bf16 "
            "yet; the block op's bf16 casts and the bf16 block kernel are "
            "ROADMAP B.8d (its recompute's bf16 flash is B.8b)")
    out = transformer_block(
        single_input(ins), tuple(single_input(ins, s) for s in BLOCK_SLOTS),
        n_head=int(attrs["n_head"]),
        causal=bool(attrs.get("causal", False)),
        eps1=float(attrs.get("eps1", 1e-5)),
        eps2=float(attrs.get("eps2", 1e-5)))
    return {"Out": [out]}
