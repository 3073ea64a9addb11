"""Optimizers: program rewriters that append update ops.

Counterpart of paddle_tpu/optimizer.py:27-311 (``Optimizer``, ``SGD``
:218, ``Momentum`` :229 and ``Adam``).  ``minimize`` appends the ``autodiff`` op
(framework/backward.py), a learning-rate var and the accumulators
(persistable vars initialised by ``fill_constant`` in the startup
program), then one update op per trainable parameter.  Var names come out
letter for letter as the JAX package's (``Adam_0.lr``,
``Adam_0.<param>.moment1`` ...), so optimizer state binds by name across
the two packages.

``minimize(accumulate_steps=k)`` rewrites the program as the JAX package
does (:83-166, :208-217): the grads add into persistable ``grad_acc``
accumulators, an f32 ``.acc_counter`` counts the micro-steps modulo k,
and every update op is gated, so its outputs keep their ``.preupdate``
values except on every k-th run, which applies the mean of the last k
micro-batch grads and clears the accumulators.  The ops, slots, attrs
and var names are the JAX package's, so an accumulating program and its
persistables bind by name across the two packages.

``minimize`` applies, in the JAX package's order (:169-215): the
accumulation, then the gradient clip set on the program
(clip.set_gradient_clip; with accumulation it clips the accumulated
mean), then each parameter's regularizer or else the optimizer's
(regularizer.py), then the update.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .clip import append_gradient_clip_ops
from .framework import unique_name
from .framework.backward import append_backward
from .framework.program import (Parameter, Program, Variable,
                                default_startup_program)


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

    # -- gradient accumulation (ref ir/multi_batch_merge_pass.cc) ----------
    def _append_grad_accumulation(self, block, param_grads, k):
        """Rewrite the grads into running accumulators; returns the new
        (param, mean grad) pairs, the boundary gate var name (1.0 on
        every k-th run, else 0.0) and the accumulator names."""
        cname = self._name + ".acc_counter"
        block.create_var(name=cname, shape=[1], dtype="float32",
                         persistable=True, stop_gradient=True)
        sb = default_startup_program().global_block()
        if not sb.has_var(cname):
            sb.create_var(name=cname, shape=[1], dtype="float32",
                          persistable=True)
            sb.append_op("fill_constant", outputs={"Out": [cname]},
                         attrs={"shape": [1], "dtype": "float32",
                                "value": 0.0})
        block.append_op("increment", {"X": [cname]}, {"Out": [cname]},
                        {"step": 1.0})

        def tmp(suffix, dtype="float32"):
            name = unique_name.generate(f"{self._name}.{suffix}")
            block.create_var(name=name, dtype=dtype, stop_gradient=True)
            return name

        kc, zc = tmp("k_const"), tmp("zero_const")
        block.append_op("fill_constant", outputs={"Out": [kc]},
                        attrs={"shape": [1], "dtype": "float32",
                               "value": float(k)})
        block.append_op("fill_constant", outputs={"Out": [zc]},
                        attrs={"shape": [1], "dtype": "float32",
                               "value": 0.0})
        # the counter wraps in place (counter <- counter mod k), so an f32
        # counter never reaches 2^24, where it would stop counting
        block.append_op("elementwise_mod", {"X": [cname], "Y": [kc]},
                        {"Out": [cname]})
        eq = tmp("is_boundary_b", "bool")
        block.append_op("equal", {"X": [cname], "Y": [zc]}, {"Out": [eq]})
        gate = tmp("is_boundary")
        block.append_op("cast", {"X": [eq]}, {"Out": [gate]},
                        {"out_dtype": "float32"})

        new_pairs, acc_names = [], []
        for param, grad in param_grads:
            acc = self._add_accumulator("grad_acc", param, block)
            block.append_op("elementwise_add", {"X": [acc],
                                                "Y": [grad.name]},
                            {"Out": [acc]})
            eff = tmp(f"{param.name}.grad_avg")
            block.append_op("scale", {"X": [acc]}, {"Out": [eff]},
                            {"scale": 1.0 / k})
            new_pairs.append((param, block.var(eff)))
            acc_names.append(acc)
        return new_pairs, gate, acc_names

    def _append_gated_optimize_op(self, block, param, grad_name, lr_name,
                                  gate):
        """The subclass update, then every var it writes gated back to its
        pre-update value unless this run is a boundary:
        w = old + (w - old) * gate."""
        start = len(block.ops)
        self._append_optimize_op(block, param, grad_name, lr_name)
        written = sorted({n for op in block.ops[start:]
                          for names in op.outputs.values() for n in names})
        saves = []
        for i, w in enumerate(written):
            old = unique_name.generate(f"{w}.preupdate")
            block.create_var(name=old, dtype="float32",
                             stop_gradient=True)
            # the snapshot goes BEFORE the update ops
            block.append_op("assign", {"X": [w]}, {"Out": [old]},
                            index=start + i)
            saves.append((w, old))
        for w, old in saves:
            diff = unique_name.generate(f"{w}.upd_delta")
            block.create_var(name=diff, dtype="float32",
                             stop_gradient=True)
            block.append_op("elementwise_sub", {"X": [w], "Y": [old]},
                            {"Out": [diff]})
            block.append_op("elementwise_mul", {"X": [diff], "Y": [gate]},
                            {"Out": [diff]})
            block.append_op("elementwise_add", {"X": [old], "Y": [diff]},
                            {"Out": [w]})

    # -- minimize (ref optimizer.py:294) -----------------------------------
    def minimize(self, loss: Variable, startup_program=None,
                 parameter_list=None, no_grad_set=None,
                 accumulate_steps: int = 1
                 ) -> Tuple[None, List[Tuple[Parameter, Variable]]]:
        program = loss.block.program
        param_grads = append_backward(loss, parameter_list, no_grad_set)
        block = program.global_block()
        gate = None
        acc_names: List[str] = []
        if accumulate_steps and int(accumulate_steps) > 1:
            param_grads, gate, acc_names = self._append_grad_accumulation(
                block, param_grads, int(accumulate_steps))
        append_gradient_clip_ops(program, param_grads)
        lr = self._create_lr_var(program)
        self._create_accumulators(block, [p for p, _ in param_grads])
        for param, grad in param_grads:
            reg = param.regularizer or self.regularization
            if reg is not None:
                reg.append_regularization_op(param, grad.name, block)
            if gate is None:
                self._append_optimize_op(block, param, grad.name, lr.name)
            else:
                self._append_gated_optimize_op(block, param, grad.name,
                                               lr.name, gate)
        if gate is not None:
            # clear the accumulators on boundary runs: acc *= (1 - gate)
            inv = unique_name.generate(f"{self._name}.not_boundary")
            block.create_var(name=inv, dtype="float32", stop_gradient=True)
            block.append_op("scale", {"X": [gate]}, {"Out": [inv]},
                            {"scale": -1.0, "bias": 1.0})
            for acc in acc_names:
                block.append_op("elementwise_mul", {"X": [acc], "Y": [inv]},
                                {"Out": [acc]})
        return None, param_grads


class SGD(Optimizer):
    def _append_optimize_op(self, block, param, grad_name, lr_name):
        block.append_op("sgd",
                        {"Param": [param.name], "Grad": [grad_name],
                         "LearningRate": [lr_name]},
                        {"ParamOut": [param.name]}, {})


SGDOptimizer = SGD


class Momentum(Optimizer):
    """One ``velocity`` accumulator a parameter (``<name>.<param>.
    velocity``, zeros); ``use_nesterov`` takes the Nesterov step."""

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("velocity", p, block)

    def _append_optimize_op(self, block, param, grad_name, lr_name):
        vel = self._accumulators["velocity"][param.name]
        block.append_op("momentum",
                        {"Param": [param.name], "Grad": [grad_name],
                         "Velocity": [vel], "LearningRate": [lr_name]},
                        {"ParamOut": [param.name], "VelocityOut": [vel]},
                        {"mu": self._momentum,
                         "use_nesterov": self._use_nesterov})


MomentumOptimizer = Momentum


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
