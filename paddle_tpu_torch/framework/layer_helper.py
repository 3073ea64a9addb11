"""LayerHelper: shared machinery for layer functions.

Counterpart of paddle_tpu/framework/layer_helper.py: creates parameters
(wiring their initializer into the startup program), creates output vars,
appends ops, and applies activations / bias.

Output shapes and dtypes are inferred by running the op's own lowering on
``meta`` tensors — one source of truth instead of separate InferShape
functions, as the JAX package does with ``jax.eval_shape``.  Meta tensors
take every op's plain branch (no kernel launches, no allocation).  Dynamic
(batch) dims are -1 in the IR; they are replaced by the prime sentinel 97
for the evaluation and restored after it, also where a reshape folded the
sentinel into a product.  ``meta_tensor``, ``meta_shape`` and
``meta_lower`` are that machinery; the verifier's shape inference
(analysis/shape_inference.py) runs the same.

The evaluation runs with FLAGS_amp_bf16 off, so the AMP policy stays a
lowering-time policy: a program built under the flag declares the f32
dtypes it declares without it, and every parameter created from an
inferred dtype, with its optimizer state, stays an f32 master copy.  (The
JAX package's eval_shape runs its AMP lowerings, so a program built there
under the flag declares bf16 parameters after the first bf16 activation:
ROADMAP queue C.)
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from ..core import flags
from ..core.enforce import EnforceNotMet
from ..core.dtypes import convert_dtype, to_torch_dtype
from .program import (Block, Parameter, Variable, default_main_program,
                      default_startup_program)
from . import unique_name
from .initializer import Initializer, XavierInitializer, ConstantInitializer
from .registry import LowerContext, get_op_def

_DYN_SUBST = 97  # prime sentinel substituted for -1 dims during meta eval
_META = torch.device("meta")


def meta_tensor(shape, dtype) -> torch.Tensor:
    """A ``meta`` tensor of a var's (shape, dtype), -1 dims as the
    sentinel."""
    shape = tuple(_DYN_SUBST if s == -1 else int(s) for s in (shape or ()))
    return torch.empty(shape, dtype=to_torch_dtype(dtype), device=_META)


def meta_shape(t: torch.Tensor, had_dyn: bool) -> tuple:
    """A meta result's shape with -1 restored where the sentinel survived
    (possibly folded into a product by reshape/flatten: it is prime)."""
    shape = list(t.shape)
    if had_dyn:
        shape = [-1 if s != 0 and s % _DYN_SUBST == 0 else s for s in shape]
    return tuple(shape)


def meta_lower(opdef, ins: Dict[str, Sequence[torch.Tensor]], attrs):
    """One evaluation of an op's lowering on meta tensors, with no
    autograd: the plain branch of every wrapper, nothing launched or
    allocated, and ``ctx.rng()`` None (nothing is drawn).  FLAGS_amp_bf16
    and FLAGS_quantize_dtype are off meanwhile: both are lowering-time
    policies, and the program declares the f32 dtypes it declares without
    them."""
    amp = flags.get_flag("amp_bf16")
    qd = flags.get_flag("quantize_dtype")
    flags.set_flag("amp_bf16", False)
    flags.set_flag("quantize_dtype", "")
    try:
        with torch.no_grad():
            return opdef.lower(LowerContext(0, _META), ins, attrs)
    finally:
        flags.set_flag("amp_bf16", amp)
        flags.set_flag("quantize_dtype", qd)


class ParamAttr:
    """Parameter attribute bundle (ref python/paddle/fluid/param_attr.py).
    ``regularizer`` (regularizer.py) rides on the Parameter, and
    ``Optimizer.minimize`` applies it in place of the optimizer's own;
    ``learning_rate`` scales the optimizer's lr for this parameter (a
    ``scale`` op of the lr var feeds its update op).  ``sharding`` (a
    PartitionSpec-style tuple in the JAX package) needs the parallel
    planes, which are not ported: any value but None raises."""

    def __init__(self, name=None, initializer: Optional[Initializer] = None,
                 learning_rate: float = 1.0, regularizer=None,
                 trainable: bool = True, sharding=None):
        if sharding is not None:
            raise EnforceNotMet(
                f"ParamAttr(sharding={sharding!r}): sharded parameters "
                f"are not ported yet (ROADMAP queue A.7)")
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.sharding = sharding

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if attr is False:
            return None
        raise ValueError(f"bad param_attr: {attr!r}")


class LayerHelper:
    def __init__(self, layer_type: str, name: Optional[str] = None):
        self.layer_type = layer_type
        self.layer_name = name
        self.main_program = default_main_program()
        self.startup_program = default_startup_program()

    @property
    def block(self) -> Block:
        return self.main_program.current_block()

    def name(self, suffix: str = "") -> str:
        """The layer's ``name``, else a fresh unique name of its type (a
        new one each call), with ``.suffix``."""
        base = self.layer_name or unique_name.generate(self.layer_type)
        return f"{base}.{suffix}" if suffix else base

    # -- vars/params -------------------------------------------------------
    def create_variable_for_type_inference(self, dtype="float32",
                                           stop_gradient=False) -> Variable:
        return self.block.create_var(
            name=unique_name.generate(self.layer_type + ".tmp"),
            dtype=dtype, stop_gradient=stop_gradient)

    def create_parameter(self, attr, shape, dtype="float32",
                         is_bias: bool = False,
                         default_initializer: Optional[Initializer] = None
                         ) -> Optional[Parameter]:
        attr = ParamAttr._to_attr(attr)
        if attr is None:
            return None
        name = attr.name or unique_name.generate(
            self.layer_name or self.layer_type
        ) + (".b_0" if is_bias else ".w_0")
        init = attr.initializer or default_initializer or (
            ConstantInitializer(0.0) if is_bias else XavierInitializer())
        shape = [int(s) for s in shape]
        p = self.main_program.global_block().create_parameter(
            name, shape, dtype=dtype, trainable=attr.trainable,
            regularizer=attr.regularizer)
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        # startup-program twin + init op
        sb = self.startup_program.global_block()
        if not sb.has_var(name):
            sp = sb.create_parameter(name, shape, dtype=dtype,
                                     trainable=attr.trainable)
            init(sp, sb)
        return p

    # -- op append with meta-tensor shape inference ------------------------
    def append_op(self, type: str, inputs: Dict[str, Sequence[Variable]],
                  outputs: Dict[str, Sequence[Variable]],
                  attrs: Optional[Dict[str, Any]] = None):
        attrs = attrs or {}
        in_names = {k: [v.name for v in vs] for k, vs in inputs.items()}
        out_names = {k: [v.name for v in vs] for k, vs in outputs.items()}
        op = self.block.append_op(type, in_names, out_names, attrs)
        self._infer_shapes(type, inputs, outputs, attrs)
        return op

    def _infer_shapes(self, type, inputs, outputs, attrs):
        ins = {k: [meta_tensor(v.shape, v.dtype) for v in vs]
               for k, vs in inputs.items()}
        try:
            outs = meta_lower(get_op_def(type), ins, attrs)
        except Exception:  # noqa: BLE001 — best-effort build-time metadata
            return
        had_dyn = any(-1 in (v.shape or ())
                      for vs in inputs.values() for v in vs)
        for slot, vars_ in outputs.items():
            for v, t in zip(vars_, outs.get(slot, [])):
                v.shape = meta_shape(t, had_dyn)
                v.dtype = convert_dtype(t.dtype)

    # -- activation/bias sugar ---------------------------------------------
    def append_bias_op(self, input_var: Variable, bias: Optional[Parameter],
                       dim_start: int = 1) -> Variable:
        if bias is None:
            return input_var
        out = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op("elementwise_add",
                       {"X": [input_var], "Y": [bias]}, {"Out": [out]},
                       {"axis": dim_start})
        return out

    def append_activation(self, input_var: Variable,
                          act: Optional[str]) -> Variable:
        if act is None:
            return input_var
        out = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op(act, {"X": [input_var]}, {"Out": [out]}, {})
        return out
