"""Optimizers: program rewriters that append update ops.

Counterpart of paddle_tpu/optimizer.py:27-311 (``Optimizer`` and
``Adam``).  ``minimize`` appends the ``autodiff`` op
(framework/backward.py), a learning-rate var and the accumulators
(persistable vars initialised by ``fill_constant`` in the startup
program), then one update op per trainable parameter.  Var names come out
letter for letter as the JAX package's (``Adam_0.lr``,
``Adam_0.<param>.moment1`` ...), so optimizer state binds by name across
the two packages.

Not ported yet, and refused rather than ignored: gradient accumulation
(``accumulate_steps > 1``, ROADMAP queue A.3), a gradient clip set on the
program and regularization (ROADMAP queue A.5).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .framework import unique_name
from .framework.backward import append_backward
from .framework.program import (Parameter, Program, Variable,
                                default_startup_program)

# the attribute the JAX package's clip.set_gradient_clip sets on a program
_CLIP_ATTR = "__gradient_clip__"


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        self._lr_input = learning_rate
        self.regularization = regularization
        self._name = name or unique_name.generate(type(self).__name__)
        self._accumulators: Dict[str, Dict[str, str]] = {}
        self._lr_var: Optional[Variable] = None

    # -- learning rate -----------------------------------------------------
    def _create_lr_var(self, program: Program) -> Variable:
        if isinstance(self._lr_input, Variable):
            return self._lr_input
        block = program.global_block()
        name = self._name + ".lr"
        if block.has_var(name):
            return block.var(name)
        lr = block.create_var(name=name, shape=[1], dtype="float32",
                              persistable=True, stop_gradient=True)
        sb = default_startup_program().global_block()
        if not sb.has_var(name):
            sb.create_var(name=name, shape=[1], dtype="float32",
                          persistable=True)
            sb.append_op("fill_constant", outputs={"Out": [name]},
                         attrs={"shape": [1], "dtype": "float32",
                                "value": float(self._lr_input)})
        return lr

    # -- accumulators (ref optimizer.py _add_accumulator) ------------------
    def _add_accumulator(self, name: str, param: Parameter, block,
                         fill_value=0.0, shape=None, dtype=None) -> str:
        acc_name = f"{self._name}.{param.name}.{name}"
        self._accumulators.setdefault(name, {})[param.name] = acc_name
        if block.has_var(acc_name):
            return acc_name
        shape = list(shape if shape is not None else param.shape)
        dtype = dtype or param.dtype
        block.create_var(name=acc_name, shape=shape, dtype=dtype,
                         persistable=True, stop_gradient=True)
        sb = default_startup_program().global_block()
        if not sb.has_var(acc_name):
            sb.create_var(name=acc_name, shape=shape, dtype=dtype,
                          persistable=True)
            sb.append_op("fill_constant", outputs={"Out": [acc_name]},
                         attrs={"shape": shape, "dtype": dtype,
                                "value": float(fill_value)})
        return acc_name

    # -- the per-param update op (subclass hook) ---------------------------
    def _append_optimize_op(self, block, param: Parameter, grad_name: str,
                            lr_name: str):
        raise NotImplementedError

    def _create_accumulators(self, block, params: List[Parameter]):
        pass

    # -- minimize (ref optimizer.py:294) -----------------------------------
    def minimize(self, loss: Variable, startup_program=None,
                 parameter_list=None, no_grad_set=None,
                 accumulate_steps: int = 1
                 ) -> Tuple[None, List[Tuple[Parameter, Variable]]]:
        program = loss.block.program
        if accumulate_steps and int(accumulate_steps) > 1:
            raise NotImplementedError(
                "gradient accumulation (accumulate_steps > 1) is not "
                "ported yet (ROADMAP queue A.3)")
        if getattr(program, _CLIP_ATTR, None) is not None:
            raise NotImplementedError(
                "gradient clipping is not ported yet (ROADMAP queue A.5)")
        if self.regularization is not None:
            raise NotImplementedError(
                "regularization is not ported yet (ROADMAP queue A.5)")
        param_grads = append_backward(loss, parameter_list, no_grad_set)
        for param, _ in param_grads:
            if getattr(param, "regularizer", None) is not None:
                raise NotImplementedError(
                    f"parameter {param.name!r} has a regularizer; "
                    f"regularization is not ported yet (ROADMAP queue A.5)")
        block = program.global_block()
        lr = self._create_lr_var(program)
        self._create_accumulators(block, [p for p, _ in param_grads])
        for param, grad in param_grads:
            self._append_optimize_op(block, param, grad.name, lr.name)
        return None, param_grads


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("moment1", p, block)
            self._add_accumulator("moment2", p, block)
            self._add_accumulator("beta1_pow", p, block,
                                  fill_value=self._beta1, shape=[1])
            self._add_accumulator("beta2_pow", p, block,
                                  fill_value=self._beta2, shape=[1])

    def _append_optimize_op(self, block, param, grad_name, lr_name):
        a = self._accumulators
        m1 = a["moment1"][param.name]
        m2 = a["moment2"][param.name]
        b1 = a["beta1_pow"][param.name]
        b2 = a["beta2_pow"][param.name]
        block.append_op("adam",
                        {"Param": [param.name], "Grad": [grad_name],
                         "Moment1": [m1], "Moment2": [m2],
                         "Beta1Pow": [b1], "Beta2Pow": [b2],
                         "LearningRate": [lr_name]},
                        {"ParamOut": [param.name], "Moment1Out": [m1],
                         "Moment2Out": [m2], "Beta1PowOut": [b1],
                         "Beta2PowOut": [b2]},
                        {"beta1": self._beta1, "beta2": self._beta2,
                         "epsilon": self._epsilon})


AdamOptimizer = Adam
