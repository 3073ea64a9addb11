"""Optimizers: program rewriters that append update ops.

Counterpart of paddle_tpu/optimizer.py, whole: ``Optimizer``, ``SGD``
:218, ``Momentum`` :229, ``LarsMomentum`` :252, ``Adam`` :278, ``AdamW``
:314, ``Adamax`` :337, ``Adagrad`` :368, ``DecayedAdagrad`` :389,
``Adadelta`` :410, ``RMSProp`` :435, ``Ftrl`` :470, ``Lamb`` :498,
``ProximalGD`` :536, ``ProximalAdagrad`` :555 and ``ModelAverage`` :579.
``minimize`` appends the ``autodiff`` op
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
(regularizer.py), then the update.  A parameter whose
``ParamAttr.learning_rate`` is not 1.0 gets a ``scale`` op of the lr var
into ``<name>.<param>.lr`` just before its update op, which reads that
var (:189-200).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

from .clip import append_gradient_clip_ops
from .framework import unique_name
from .framework.backward import append_backward
from .framework.program import (Parameter, Program, Variable,
                                default_main_program,
                                default_startup_program, program_guard)


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
            lr_name = lr.name
            plr = getattr(param, "optimize_attr",
                          {"learning_rate": 1.0})["learning_rate"]
            if plr != 1.0:
                scaled = f"{self._name}.{param.name}.lr"
                if not block.has_var(scaled):
                    block.create_var(name=scaled, shape=[1],
                                     dtype="float32", stop_gradient=True)
                block.append_op("scale", {"X": [lr.name]},
                                {"Out": [scaled]}, {"scale": float(plr)})
                lr_name = scaled
            if gate is None:
                self._append_optimize_op(block, param, grad.name, lr_name)
            else:
                self._append_gated_optimize_op(block, param, grad.name,
                                               lr_name, gate)
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


class LarsMomentum(Optimizer):
    def __init__(self, learning_rate, momentum, lars_coeff=1e-3,
                 lars_weight_decay=5e-4, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("velocity", p, block)

    def _append_optimize_op(self, block, param, grad_name, lr_name):
        vel = self._accumulators["velocity"][param.name]
        block.append_op("lars_momentum",
                        {"Param": [param.name], "Grad": [grad_name],
                         "Velocity": [vel], "LearningRate": [lr_name]},
                        {"ParamOut": [param.name], "VelocityOut": [vel]},
                        {"mu": self._momentum,
                         "lars_coeff": self._lars_coeff,
                         "lars_weight_decay": self._lars_weight_decay})


LarsMomentumOptimizer = LarsMomentum


class AdamW(Adam):
    """Adam's accumulators; the ``adamw`` op adds the decoupled decay."""

    def __init__(self, learning_rate=0.001, weight_decay=0.01, **kw):
        super().__init__(learning_rate, **kw)
        self._coeff = weight_decay

    def _append_optimize_op(self, block, param, grad_name, lr_name):
        a = self._accumulators
        m1 = a["moment1"][param.name]
        m2 = a["moment2"][param.name]
        b1 = a["beta1_pow"][param.name]
        b2 = a["beta2_pow"][param.name]
        block.append_op("adamw",
                        {"Param": [param.name], "Grad": [grad_name],
                         "Moment1": [m1], "Moment2": [m2],
                         "Beta1Pow": [b1], "Beta2Pow": [b2],
                         "LearningRate": [lr_name]},
                        {"ParamOut": [param.name], "Moment1Out": [m1],
                         "Moment2Out": [m2], "Beta1PowOut": [b1],
                         "Beta2PowOut": [b2]},
                        {"beta1": self._beta1, "beta2": self._beta2,
                         "epsilon": self._epsilon, "coeff": self._coeff})


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("moment", p, block)
            self._add_accumulator("inf_norm", p, block)
            self._add_accumulator("beta1_pow", p, block,
                                  fill_value=self._beta1, shape=[1])

    def _append_optimize_op(self, block, param, grad_name, lr_name):
        a = self._accumulators
        m = a["moment"][param.name]
        inf = a["inf_norm"][param.name]
        b1 = a["beta1_pow"][param.name]
        block.append_op("adamax",
                        {"Param": [param.name], "Grad": [grad_name],
                         "Moment": [m], "InfNorm": [inf], "Beta1Pow": [b1],
                         "LearningRate": [lr_name]},
                        {"ParamOut": [param.name], "MomentOut": [m],
                         "InfNormOut": [inf], "Beta1PowOut": [b1]},
                        {"beta1": self._beta1, "beta2": self._beta2,
                         "epsilon": self._epsilon})


AdamaxOptimizer = Adamax


class Adagrad(Optimizer):
    """One ``moment`` accumulator a parameter (zeros)."""

    def __init__(self, learning_rate, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("moment", p, block)

    def _append_optimize_op(self, block, param, grad_name, lr_name):
        m = self._accumulators["moment"][param.name]
        block.append_op("adagrad",
                        {"Param": [param.name], "Grad": [grad_name],
                         "Moment": [m], "LearningRate": [lr_name]},
                        {"ParamOut": [param.name], "MomentOut": [m]},
                        {"epsilon": self._epsilon})


AdagradOptimizer = Adagrad


class DecayedAdagrad(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("moment", p, block)

    def _append_optimize_op(self, block, param, grad_name, lr_name):
        m = self._accumulators["moment"][param.name]
        block.append_op("decayed_adagrad",
                        {"Param": [param.name], "Grad": [grad_name],
                         "Moment": [m], "LearningRate": [lr_name]},
                        {"ParamOut": [param.name], "MomentOut": [m]},
                        {"decay": self._decay, "epsilon": self._epsilon})


DecayedAdagradOptimizer = DecayedAdagrad


class Adadelta(Optimizer):
    """Its op takes no learning rate (the lr var is made all the same)."""

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("avg_squared_grad", p, block)
            self._add_accumulator("avg_squared_update", p, block)

    def _append_optimize_op(self, block, param, grad_name, lr_name):
        a = self._accumulators
        g = a["avg_squared_grad"][param.name]
        u = a["avg_squared_update"][param.name]
        block.append_op("adadelta",
                        {"Param": [param.name], "Grad": [grad_name],
                         "AvgSquaredGrad": [g], "AvgSquaredUpdate": [u]},
                        {"ParamOut": [param.name], "AvgSquaredGradOut": [g],
                         "AvgSquaredUpdateOut": [u]},
                        {"rho": self._rho, "epsilon": self._epsilon})


AdadeltaOptimizer = Adadelta


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("mean_square", p, block)
            self._add_accumulator("moment", p, block)
            if self._centered:
                self._add_accumulator("mean_grad", p, block)

    def _append_optimize_op(self, block, param, grad_name, lr_name):
        a = self._accumulators
        ms = a["mean_square"][param.name]
        m = a["moment"][param.name]
        ins = {"Param": [param.name], "Grad": [grad_name],
               "MeanSquare": [ms], "Moment": [m], "LearningRate": [lr_name]}
        outs = {"ParamOut": [param.name], "MeanSquareOut": [ms],
                "MomentOut": [m]}
        if self._centered:
            mg = a["mean_grad"][param.name]
            ins["MeanGrad"] = [mg]
            outs["MeanGradOut"] = [mg]
        block.append_op("rmsprop", ins, outs,
                        {"decay": self._rho, "epsilon": self._epsilon,
                         "momentum": self._momentum,
                         "centered": self._centered})


RMSPropOptimizer = RMSProp


class Ftrl(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("squared", p, block)
            self._add_accumulator("linear", p, block)

    def _append_optimize_op(self, block, param, grad_name, lr_name):
        a = self._accumulators
        sq = a["squared"][param.name]
        lin = a["linear"][param.name]
        block.append_op("ftrl",
                        {"Param": [param.name], "Grad": [grad_name],
                         "SquaredAccumulator": [sq],
                         "LinearAccumulator": [lin],
                         "LearningRate": [lr_name]},
                        {"ParamOut": [param.name], "SquaredAccumOut": [sq],
                         "LinearAccumOut": [lin]},
                        {"l1": self._l1, "l2": self._l2,
                         "lr_power": self._lr_power})


FtrlOptimizer = Ftrl


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._wd = lamb_weight_decay
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
        block.append_op("lamb",
                        {"Param": [param.name], "Grad": [grad_name],
                         "Moment1": [a["moment1"][param.name]],
                         "Moment2": [a["moment2"][param.name]],
                         "Beta1Pow": [a["beta1_pow"][param.name]],
                         "Beta2Pow": [a["beta2_pow"][param.name]],
                         "LearningRate": [lr_name]},
                        {"ParamOut": [param.name],
                         "Moment1Out": [a["moment1"][param.name]],
                         "Moment2Out": [a["moment2"][param.name]],
                         "Beta1PowOut": [a["beta1_pow"][param.name]],
                         "Beta2PowOut": [a["beta2_pow"][param.name]]},
                        {"beta1": self._beta1, "beta2": self._beta2,
                         "epsilon": self._epsilon,
                         "weight_decay": self._wd})


LambOptimizer = Lamb


class ProximalGD(Optimizer):
    """Gradient descent with the l1/l2 proximal step."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2 = l1, l2

    def _append_optimize_op(self, block, param, grad_name, lr_name):
        block.append_op("proximal_gd",
                        {"Param": [param.name], "Grad": [grad_name],
                         "LearningRate": [lr_name]},
                        {"ParamOut": [param.name]},
                        {"l1": self._l1, "l2": self._l2})


ProximalGDOptimizer = ProximalGD


class ProximalAdagrad(Optimizer):
    """Adagrad's step with the l1/l2 proximal step."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2 = l1, l2

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("moment", p, block)

    def _append_optimize_op(self, block, param, grad_name, lr_name):
        m = self._accumulators["moment"][param.name]
        block.append_op("proximal_adagrad",
                        {"Param": [param.name], "Grad": [grad_name],
                         "Moment": [m], "LearningRate": [lr_name]},
                        {"ParamOut": [param.name], "MomentOut": [m]},
                        {"l1": self._l1, "l2": self._l2})


ProximalAdagradOptimizer = ProximalAdagrad


class ModelAverage(Optimizer):
    """The running average of every parameter's value after each step,
    with an apply/restore swap (ref optimizer.py:1373).

    Construct it AFTER ``minimize``: it appends an ``average_accumulates``
    op a parameter to the main program (``sum_1`` and a [1]
    ``num_accumulates`` accumulator each, zeros), after the update ops, so
    each run folds the updated values into the sums.  ``with
    ma.apply(exe):`` runs ``apply_program``, which backs each parameter
    up into ``<name>.<param>.backup`` and sets it to sum_1 /
    max(num, 1), or leaves it as it is while num is 0 (an apply right
    after the startup run is a no-op); ``restore`` (on leaving the block)
    runs ``restore_program``, which assigns the backups back.  The
    window knobs are kept for the API; ``max_average_window`` caps the
    count (the op's sliding sum past it)."""

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, program=None,
                 startup_program=None, **kw):
        super().__init__(0.0, **kw)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        main = program or default_main_program()
        block = main.global_block()
        self._params = [v for v in main.list_vars()
                        if isinstance(v, Parameter)]

        def _append_accumulation():
            for p in self._params:
                s1 = self._add_accumulator("sum_1", p, block)
                num = self._add_accumulator("num_accumulates", p, block,
                                            shape=[1])
                block.append_op("average_accumulates",
                                {"param": [p.name], "in_sum_1": [s1],
                                 "in_num_accumulates": [num]},
                                {"out_sum_1": [s1],
                                 "out_num_accumulates": [num]},
                                {"max_average_window":
                                 float(self.max_average_window)})

        if startup_program is not None:
            # _add_accumulator writes its fill_constant ops into the
            # default startup program: route them to the caller's
            with program_guard(main, startup_program):
                _append_accumulation()
        else:
            _append_accumulation()
        self._build_swap_programs()

    def _declare(self, block, name, shape, dtype):
        if not block.has_var(name):
            block.create_var(name=name, shape=list(shape or [1]),
                             dtype=dtype, persistable=True,
                             stop_gradient=True)

    def _build_swap_programs(self):
        self.apply_program = Program()
        self.restore_program = Program()
        ab = self.apply_program.global_block()
        rb = self.restore_program.global_block()
        for p in self._params:
            s1 = self._accumulators["sum_1"][p.name]
            num = self._accumulators["num_accumulates"][p.name]
            backup = f"{self._name}.{p.name}.backup"
            for blk in (ab, rb):
                self._declare(blk, p.name, p.shape, p.dtype)
                self._declare(blk, backup, p.shape, p.dtype)
            self._declare(ab, s1, p.shape, p.dtype)
            self._declare(ab, num, [1], "float32")
            ab.append_op("assign", {"X": [p.name]}, {"Out": [backup]})
            one = f"{self._name}.{p.name}.one"
            denom = f"{self._name}.{p.name}.denom"
            avg = f"{self._name}.{p.name}.avg"
            has = f"{self._name}.{p.name}.has_acc"
            hasf = f"{self._name}.{p.name}.has_acc_f"
            delta = f"{self._name}.{p.name}.avg_delta"
            for n in (one, denom, avg, hasf, delta):
                ab.create_var(name=n, dtype="float32", stop_gradient=True)
            ab.create_var(name=has, dtype="bool", stop_gradient=True)
            ab.append_op("fill_constant", outputs={"Out": [one]},
                         attrs={"shape": [1], "dtype": "float32",
                                "value": 1.0})
            ab.append_op("elementwise_max", {"X": [num], "Y": [one]},
                         {"Out": [denom]})
            ab.append_op("elementwise_div", {"X": [s1], "Y": [denom]},
                         {"Out": [avg]})
            # param += (num >= 1) * (avg - param)
            ab.append_op("greater_equal", {"X": [num], "Y": [one]},
                         {"Out": [has]})
            ab.append_op("cast", {"X": [has]}, {"Out": [hasf]},
                         {"out_dtype": "float32"})
            ab.append_op("elementwise_sub", {"X": [avg], "Y": [p.name]},
                         {"Out": [delta]})
            ab.append_op("elementwise_mul", {"X": [delta], "Y": [hasf]},
                         {"Out": [delta]})
            ab.append_op("elementwise_add", {"X": [p.name], "Y": [delta]},
                         {"Out": [p.name]})
            rb.append_op("assign", {"X": [backup]}, {"Out": [p.name]})

    def apply(self, executor, need_restore=True):
        """Context manager: the parameters hold their averages inside the
        block, and their trained values again after it (need_restore)."""

        @contextlib.contextmanager
        def _ctx():
            executor.run(self.apply_program)
            try:
                yield self
            finally:
                if need_restore:
                    self.restore(executor)

        return _ctx()

    def restore(self, executor):
        executor.run(self.restore_program)
