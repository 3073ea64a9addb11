"""Inference transpiler: fold batch_norm into the conv2d before it
(counterpart of paddle_tpu/transpiler/inference_transpiler.py, the
reference's inference_transpiler.py:24 _fuse_batch_norm).

Fold: W' = W * gamma / sqrt(var + eps) per output channel,
      b' = (b - mean) * gamma / sqrt(var + eps) + beta.
The folded tensors are computed with torch on the weights' device, in
JAX's float order.  The fold is skipped where anything else reads the
conv's output (a skip connection, a sub-block); the conv keeps its output
var, and an ``assign`` aliases the BN output name onto it, so a fetch of
either stays legal.
"""
from __future__ import annotations

import torch

from ..framework.program import Operator, Program


class InferenceTranspiler:
    def transpile(self, program: Program, place=None, scope=None):
        from ..framework.executor import global_scope
        scope = scope or global_scope()
        block = program.global_block()
        ops = block.ops
        # readers of each var across every block
        consumers: dict = {}
        for b in program.blocks:
            for bop in b.ops:
                for n in bop.input_names():
                    consumers[n] = consumers.get(n, 0) + 1
        new_ops = []
        i = 0
        while i < len(ops):
            op = ops[i]
            nxt = ops[i + 1] if i + 1 < len(ops) else None
            if (op.type == "conv2d" and nxt is not None
                    and nxt.type == "batch_norm"
                    and op.outputs.get("Output", [None])[0]
                    == nxt.inputs.get("X", [None])[0]
                    and consumers.get(op.outputs["Output"][0], 0) == 1):
                self._fold(scope, op, nxt)
                new_ops.append(op)
                new_ops.append(Operator(
                    block, "assign", {"X": [op.outputs["Output"][0]]},
                    {"Out": [nxt.outputs["Y"][0]]}, {}))
                i += 2
                continue
            new_ops.append(op)
            i += 1
        block.ops = new_ops
        program._bump()
        return program

    def _fold(self, scope, conv_op, bn_op):
        def get(name):
            return scope.find_var(name).detach()

        w_name = conv_op.inputs["Filter"][0]
        W = get(w_name)
        scale, bias = get(bn_op.inputs["Scale"][0]), get(bn_op.inputs["Bias"][0])
        mean = get(bn_op.inputs["Mean"][0])
        var = get(bn_op.inputs["Variance"][0])
        eps = float(bn_op.attrs.get("epsilon", 1e-5))
        alpha = scale / torch.sqrt(var + eps)          # [C_out]
        scope.set_var(w_name, (W * alpha[:, None, None, None]).to(W.dtype))
        # the conv's bias if it has one, else the BN bias var becomes it
        if conv_op.inputs.get("Bias"):
            b_name = conv_op.inputs["Bias"][0]
            new_b = (get(b_name) - mean) * alpha + bias
        else:
            b_name = bn_op.inputs["Bias"][0]
            conv_op.inputs["Bias"] = [b_name]
            new_b = -mean * alpha + bias
        scope.set_var(b_name, new_b.to(W.dtype))
