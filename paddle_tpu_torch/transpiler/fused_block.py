"""Fuse-block transpiler: whole-transformer-block pattern matching
(counterpart of paddle_tpu/transpiler/fused_block.py).

Scans the global block for the pre-norm transformer-block op sequence that
models/transformer.py's encoder_layer(fused=True) emits —

    layer_norm -> fused_mha -> elementwise_add (residual)
    -> layer_norm -> mul -> elementwise_add (bias) -> relu
    -> mul -> elementwise_add (bias) -> elementwise_add (residual)

— and collapses each match into ONE ``fused_transformer_block`` op
(ops/fused_ops.py), with the JAX package's pattern, dataflow, consumer,
persistable and shape checks and the same replacement op, so transpiled
programs serialize alike.  Gated by FLAGS_fuse_block via ``maybe_fuse``;
any mismatch leaves the ops unfused.  Run it before ``minimize``, as
bench.py does.  A rewrite that fused anything re-verifies the program as
the JAX transpiler does (``analysis.maybe_check_transpiled``): a fusion
that severed dataflow raises a ProgramVerificationError naming
FuseBlockTranspiler, unless FLAGS_verify_program is off.
"""
from __future__ import annotations

from typing import Optional

from ..core import flags
from ..framework.program import Operator, Program, default_main_program

# op-type skeleton of one pre-norm block, in program order
_PATTERN = ("layer_norm", "fused_mha", "elementwise_add", "layer_norm",
            "mul", "elementwise_add", "relu", "mul", "elementwise_add",
            "elementwise_add")


class FuseBlockTranspiler:
    def transpile(self, program: Optional[Program] = None) -> int:
        """Rewrite in place; returns the number of blocks fused."""
        program = program or default_main_program()
        block = program.global_block()
        ops = block.ops

        # consumers per var across ALL blocks: an intermediate read
        # outside the fused window must keep the unfused ops
        consumers: dict = {}
        for b in program.blocks:
            for op in b.ops:
                for n in op.input_names():
                    consumers[n] = consumers.get(n, 0) + 1

        new_ops = []
        i = 0
        fused = 0
        while i < len(ops):
            repl, width = self._try_match(block, ops, i, consumers)
            if repl is not None:
                new_ops.append(repl)
                i += width
                fused += 1
            else:
                new_ops.append(ops[i])
                i += 1
        if fused:
            block.ops = new_ops
            program._bump()
            from .. import analysis
            analysis.maybe_check_transpiled(program, "FuseBlockTranspiler")
        return fused

    def _try_match(self, block, ops, i, consumers):
        n = len(_PATTERN)
        if i + n > len(ops):
            return None, 0
        win = ops[i:i + n]
        if tuple(op.type for op in win) != _PATTERN:
            return None, 0
        (ln1, mha, res1, ln2, mul1, badd1, relu, mul2, badd2,
         res2) = win

        def out0(op, slot):
            return op.outputs.get(slot, [None])[0]

        def in0(op, slot):
            return op.inputs.get(slot, [None])[0]

        x = in0(ln1, "X")
        # dataflow: each stage consumes the previous stage's output,
        # residuals reference x and the first residual sum
        chain = (
            in0(mha, "X") == out0(ln1, "Y")
            and not mha.inputs.get("XKV")
            and in0(res1, "X") == out0(mha, "Out")
            and in0(res1, "Y") == x
            and in0(ln2, "X") == out0(res1, "Out")
            and in0(mul1, "X") == out0(ln2, "Y")
            and in0(badd1, "X") == out0(mul1, "Out")
            and in0(relu, "X") == out0(badd1, "Out")
            and in0(mul2, "X") == out0(relu, "Out")
            and in0(badd2, "X") == out0(mul2, "Out")
            and in0(res2, "X") == out0(badd2, "Out")
            and in0(res2, "Y") == out0(res1, "Out"))
        if not chain:
            return None, 0
        # both layer_norms: affine, over the last axis of a rank-3
        # activation (the kernel normalizes dim -1)
        for ln in (ln1, ln2):
            if not (ln.inputs.get("Scale") and ln.inputs.get("Bias")
                    and int(ln.attrs.get("begin_norm_axis", 1)) == 2):
                return None, 0
        # MLP matmuls must be the fc flattening the kernel assumes
        if int(mul1.attrs.get("x_num_col_dims", 1)) != 2 or \
                int(mul2.attrs.get("x_num_col_dims", 1)) != 2:
            return None, 0
        # shapes: square block (wo: [E, D], w1: [D, F], w2: [F, D])
        try:
            D = int(block.var(x).shape[-1])
            wq = block.var(in0(mha, "Wq"))
            wo = block.var(in0(mha, "Wo"))
            w1 = block.var(in0(mul1, "Y"))
            w2 = block.var(in0(mul2, "Y"))
            if (wq.shape[0] != D or wo.shape[1] != D
                    or w1.shape[0] != D or w2.shape[1] != D
                    or w1.shape[1] != w2.shape[0]):
                return None, 0
        except (KeyError, TypeError, IndexError):
            return None, 0
        # every intermediate must be internal to the window (res1 is
        # read twice inside; everything else once)
        internal = {out0(ln1, "Y"): 1, out0(mha, "Out"): 1,
                    out0(res1, "Out"): 2, out0(ln2, "Y"): 1,
                    out0(mul1, "Out"): 1, out0(badd1, "Out"): 1,
                    out0(relu, "Out"): 1, out0(mul2, "Out"): 1,
                    out0(badd2, "Out"): 1}
        for name, want in internal.items():
            if consumers.get(name, 0) != want:
                return None, 0
            if block.has_var(name) and block.var(name).persistable:
                return None, 0
        repl = Operator(
            block, "fused_transformer_block",
            {"X": [x],
             "Ln1Scale": [in0(ln1, "Scale")],
             "Ln1Bias": [in0(ln1, "Bias")],
             "Wq": [in0(mha, "Wq")], "Wk": [in0(mha, "Wk")],
             "Wv": [in0(mha, "Wv")], "Wo": [in0(mha, "Wo")],
             "Ln2Scale": [in0(ln2, "Scale")],
             "Ln2Bias": [in0(ln2, "Bias")],
             "W1": [in0(mul1, "Y")], "B1": [in0(badd1, "Y")],
             "W2": [in0(mul2, "Y")], "B2": [in0(badd2, "Y")]},
            {"Out": [out0(res2, "Out")]},
            {"n_head": int(mha.attrs["n_head"]),
             "causal": bool(mha.attrs.get("causal", False)),
             "eps1": float(ln1.attrs.get("epsilon", 1e-5)),
             "eps2": float(ln2.attrs.get("epsilon", 1e-5))})
        return repl, len(_PATTERN)


def maybe_fuse(program: Optional[Program] = None) -> int:
    """Apply FuseBlockTranspiler when FLAGS_fuse_block is on; returns
    the number of blocks fused (0 when off or nothing matched)."""
    if not flags.get_flag("fuse_block"):
        return 0
    return FuseBlockTranspiler().transpile(program)
