"""QAT quantize transpiler (counterpart of
paddle_tpu/transpiler/quantize_transpiler.py).

``training_transpile`` rewrites a training program so every quantizable
op (mul, matmul, conv2d, conv2d_transpose) reads fake-quantized inputs and
weights: abs_max or moving_average_abs_max activation quantization,
channel-wise abs_max (or abs_max) weight quantization; training stays in
floating point with straight-through gradients.  ``freeze_program`` turns
a trained program into one that runs on int8 or fp8: the weights
quantized once beside f32 scale vectors in the scope, each quantizable
consumer a ``quantized_matmul`` / ``quantized_conv2d`` op
(ops/quantize_ops.py).  Both rewrites are JAX's op for op, so the
programs serialize alike, and both end with the verifier's post-condition
(``analysis.maybe_check_transpiled``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.dtypes import convert_dtype
from ..core.enforce import EnforceNotMet
from ..framework import unique_name
from ..framework.program import Operator, Parameter, Program

QUANTIZABLE_OPS = ("mul", "matmul", "conv2d", "conv2d_transpose")
FAKE_QUANT_OPS = ("fake_quantize_abs_max",
                  "fake_quantize_moving_average_abs_max",
                  "fake_quantize_range_abs_max",
                  "fake_channel_wise_quantize_abs_max")


class QuantizeTranspiler:
    def __init__(self, weight_bits: int = 8, activation_bits: int = 8,
                 activation_quantize_type: str = "abs_max",
                 weight_quantize_type: str = "channel_wise_abs_max",
                 moving_rate: float = 0.9):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.activation_quantize_type = activation_quantize_type
        self.weight_quantize_type = weight_quantize_type
        self.moving_rate = moving_rate

    def training_transpile(self, program: Optional[Program] = None,
                           startup_program: Optional[Program] = None):
        from ..framework.program import (default_main_program,
                                         default_startup_program)
        program = program or default_main_program()
        self._startup = startup_program or default_startup_program()
        block = program.global_block()
        params = {p.name for p in program.all_parameters()}
        # cache key: (var name, weight quant_axis for this consumer kind):
        # a weight feeding both a conv2d (axis 0) and a mul/matmul (axis 1)
        # gets two channel-wise quantizations
        quantized = {}
        new_ops: list = []
        for op in list(block.ops):
            if op.type in QUANTIZABLE_OPS:
                self._consumer_type = op.type
                axis_kind = 0 if op.type == "conv2d" else 1
                for slot, names in op.inputs.items():
                    new_names = []
                    for n in names:
                        key = (n, axis_kind if n in params else None)
                        if key not in quantized:
                            quantized[key] = self._insert_quant(
                                block, new_ops, n, n in params)
                        new_names.append(quantized[key])
                    op.inputs[slot] = new_names
            new_ops.append(op)
        block.ops = new_ops
        program._bump()
        from .. import analysis
        analysis.maybe_check_transpiled(
            program, "QuantizeTranspiler.training_transpile")
        return program

    def _insert_quant(self, block, new_ops, name: str, is_weight: bool):
        var = block.var(name)
        qname = unique_name.generate(name + ".quantized")
        block.create_var(qname, shape=var.shape, dtype=var.dtype)
        scale = block.create_var(unique_name.generate(name + ".scale"),
                                 dtype="float32")
        if is_weight:
            if self.weight_quantize_type == "channel_wise_abs_max":
                op_type = "fake_channel_wise_quantize_abs_max"
            else:
                op_type = "fake_quantize_abs_max"
            attrs = {"bit_length": self.weight_bits}
            inputs = {"X": [name]}
        elif self.activation_quantize_type == "moving_average_abs_max":
            op_type = "fake_quantize_moving_average_abs_max"
            # persistable state initialised to 1.0 by the startup program;
            # the name is deterministic, so a program and its for_test
            # clone transpiled apart share one scale var through the scope
            scale_name = name + ".quant_in_scale"
            scale = (block.var(scale_name) if block.has_var(scale_name)
                     else block.create_var(scale_name, shape=[],
                                           dtype="float32",
                                           persistable=True))
            sb = self._startup.global_block()
            if not sb.has_var(scale_name):
                sb.create_var(scale_name, shape=[], dtype="float32",
                              persistable=True)
                sb.append_op("fill_constant", {}, {"Out": [scale_name]},
                             {"shape": [], "dtype": "float32",
                              "value": 1.0})
            inputs = {"X": [name], "InScale": [scale.name]}
            attrs = {"bit_length": self.activation_bits,
                     "moving_rate": self.moving_rate, "is_test": False}
        else:
            op_type = "fake_quantize_abs_max"
            attrs = {"bit_length": self.activation_bits}
            inputs = {"X": [name]}
        if op_type == "fake_channel_wise_quantize_abs_max":
            # quant_axis 1 for mul/matmul ([in, out]) and conv2d_transpose
            # (IOHW), 0 for conv2d (OIHW)
            attrs["quant_axis"] = 0 if self._consumer_type == "conv2d" else 1
        new_ops.append(Operator(block, op_type, inputs,
                                {"Out": [qname], "OutScale": [scale.name]},
                                attrs))
        return qname

    def freeze_program(self, program: Program, scope=None,
                       quantize_dtype: str = "int8"):
        """Rewrite a trained QAT program to run on int8 or fp8.

        The weights are quantized once, with torch on their own device
        (per-channel absmax along the recorded quant_axis), into int8 or
        fp8 tensors in the scope with f32 scale vectors beside them.  fc's
        ``mul``, a plain ``matmul`` (no transpose, alpha 1) and ``conv2d``
        become ``quantized_matmul`` / ``quantized_conv2d`` reading the raw
        activation, which the op quantizes against the trained
        moving-average scale (InScale) or dynamically.  Fake ops whose
        outputs went dead are dropped, surviving moving-average ops flip to
        is_test, and fp32 Parameters nothing reads any more are deleted.

        A missing weight or scale in the scope, or a moving-average scale
        still at its 1.0 initializer, raises EnforceNotMet: a program whose
        quant ops were never trained is refused, not folded.  The host
        reads (that 1.0 check) happen here, at freeze time only."""
        from ..ops.quantize_ops import channel_scales, qspec, quantize_array
        if scope is None:
            from ..framework.executor import global_scope
            scope = global_scope()
        qspec(quantize_dtype)           # validate the spelling up front
        block = program.global_block()
        params = {p.name for p in program.all_parameters()}

        # quantized-var name -> (source var, fake op)
        produced: dict = {}
        for op in block.ops:
            if op.type in FAKE_QUANT_OPS:
                produced[op.outputs["Out"][0]] = (op.inputs["X"][0], op)

        def _need(name, what):
            v = scope.find_var(name)
            if v is None:
                raise EnforceNotMet(
                    f"freeze_program: no recorded value for {what} "
                    f"{name!r} in the scope — run the startup program "
                    f"and train (or load trained params) before "
                    f"freezing; freezing an untrained program would "
                    f"fold garbage scales")
            return v

        def _act_scale_input(fop):
            """InScale wiring for one quantized activation input: the
            trained moving-average scale var, or None (dynamic)."""
            if fop.type != "fake_quantize_moving_average_abs_max":
                return None
            scale_name = fop.inputs["InScale"][0]
            val = _need(scale_name, "moving-average activation scale")
            if float(val.reshape(())) == 1.0:
                raise EnforceNotMet(
                    f"freeze_program: activation scale {scale_name!r} "
                    f"is still at its 1.0 initializer — the quant op "
                    f"was never trained (no recorded scales); run "
                    f"training steps before freezing")
            return scale_name

        qweights: dict = {}     # (param, axis) -> (qname, scale_name)

        def _quantize_weight(wname, axis, kind):
            key = (wname, axis)
            if key in qweights:
                return qweights[key]
            W = _need(wname, "weight").detach()
            if kind == "fake_channel_wise_quantize_abs_max":
                scales = channel_scales(W, axis)
            else:
                scales = torch.clamp(torch.abs(W).max().float(), min=1e-8)
            shape = [1] * W.ndim
            if scales.ndim:
                shape[axis] = -1
            wq = quantize_array(W, scales.reshape(shape), quantize_dtype)
            qname = unique_name.generate(wname + ".quantized_w")
            sname = unique_name.generate(wname + ".w_scale")
            block.create_var(qname, shape=W.shape,
                             dtype=convert_dtype(wq.dtype),
                             persistable=True, stop_gradient=True)
            block.create_var(sname, shape=scales.shape, dtype="float32",
                             persistable=True, stop_gradient=True)
            scope.set_var(qname, wq)
            scope.set_var(sname, scales)
            qweights[key] = (qname, sname)
            return qweights[key]

        def _rewrite(op):
            """One consumer op -> its quantized twin, or None (keep)."""
            if op.type == "mul":
                w_slot, x_slot = "Y", "X"
            elif op.type == "matmul":
                if (op.attrs.get("transpose_X") or op.attrs.get("transpose_Y")
                        or float(op.attrs.get("alpha", 1.0)) != 1.0):
                    return None
                w_slot, x_slot = "Y", "X"
            elif op.type == "conv2d":
                w_slot, x_slot = "Filter", "Input"
            else:
                return None
            wq_name = op.inputs.get(w_slot, [None])[0]
            xq_name = op.inputs.get(x_slot, [None])[0]
            if wq_name not in produced or xq_name not in produced:
                return None
            w_src, w_fop = produced[wq_name]
            x_src, x_fop = produced[xq_name]
            if w_src not in params:
                return None     # the weight input is not a parameter
            axis = int(w_fop.attrs.get("quant_axis",
                                       0 if op.type == "conv2d" else 1))
            qname, sname = _quantize_weight(w_src, axis, w_fop.type)
            in_scale = _act_scale_input(x_fop)
            if op.type == "conv2d":
                inputs = {"Input": [x_src], "Filter": [qname],
                          "FilterScale": [sname]}
                if in_scale:
                    inputs["InScale"] = [in_scale]
                return Operator(
                    block, "quantized_conv2d", inputs,
                    {"Output": [op.outputs["Output"][0]]},
                    {"quantize_dtype": quantize_dtype,
                     "strides": op.attrs.get("strides", [1, 1]),
                     "paddings": op.attrs.get("paddings", [0, 0]),
                     "dilations": op.attrs.get("dilations", [1, 1]),
                     "groups": op.attrs.get("groups", 1)})
            inputs = {"X": [x_src], "W": [qname], "WScale": [sname]}
            if in_scale:
                inputs["InScale"] = [in_scale]
            return Operator(
                block, "quantized_matmul", inputs,
                {"Out": [op.outputs["Out"][0]]},
                {"quantize_dtype": quantize_dtype,
                 "x_num_col_dims": op.attrs.get("x_num_col_dims", 1)})

        new_ops = []
        for op in block.ops:
            repl = _rewrite(op) if op.type in QUANTIZABLE_OPS else None
            new_ops.append(repl if repl is not None else op)

        # drop fake-quantize ops whose quantized outputs no longer feed
        # anything (the rewritten consumers read the raw sources)
        still_read = {n for op in new_ops if op.type not in FAKE_QUANT_OPS
                      for n in op.input_names()}
        kept = []
        for op in new_ops:
            if (op.type in FAKE_QUANT_OPS
                    and op.outputs["Out"][0] not in still_read):
                continue
            if op.type == "fake_quantize_moving_average_abs_max":
                op.attrs["is_test"] = True
            kept.append(op)
        block.ops = kept

        # drop orphaned fp32 weight Parameters: their consumers read the
        # int8/fp8 twins now.  "used" walks every block, as the verifier's
        # orphan lint does
        used = {n for b in program.blocks for op in b.ops
                for n in op.input_names() + op.output_names()}
        for name in [n for n, v in block.vars.items()
                     if isinstance(v, Parameter) and n not in used]:
            del block.vars[name]
        program._bump()
        from .. import analysis
        analysis.maybe_check_transpiled(
            program, "QuantizeTranspiler.freeze_program")
        return program
