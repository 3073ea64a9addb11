"""Abstract shape/dtype inference over a whole Program.

Counterpart of paddle_tpu/analysis/shape_inference.py.  Symbolic shapes
(-1 = a dynamic batch dim) propagate op by op through the global block,
each op resolved by

  1. its registered infer rule (framework/registry.py
     register_shape_infer, the reference's InferShape), else
  2. one evaluation of the op's own lowering on ``meta`` tensors
     (framework/layer_helper.py ``meta_lower``, the build-time machinery:
     -1 dims ride through as a prime sentinel, FLAGS_amp_bf16 and
     FLAGS_quantize_dtype are off, no autograd), where the JAX package runs ``jax.eval_shape``, else
  3. "unknown shape": unknown ops never crash the pass.  The ops of
     ``UNEVALUABLE_OPS`` go there directly when no rule answers: their
     lowering needs what only a run has (the program and the live env
     of a control-flow op, the expanded forward of ``autodiff``).

The meta evaluation takes every kernel wrapper's plain branch: nothing is
launched and nothing is allocated, on the card or on the host.  The
``autodiff`` op goes through its rule and never runs the forward.

Evaluating with the AMP flag off is a divergence by design from the JAX
package, whose eval_shape runs its AMP lowerings: AMP is lowering-time
only in the port and its programs declare f32, so with the flag on every
bf16 activation would read as a ``dtype_mismatch``.  FLAGS_quantize_dtype
is off there too, also by design (JAX's eval_shape runs its low-precision
matmuls): a product's output shape and dtype do not depend on the flag,
and its abs-max scales and casts have nothing to infer on meta tensors.

Findings:
  * ``shape_mismatch`` (error): an infer rule proves the op's inputs
    incompatible, or the inferred output provably contradicts the shape
    the program declares for that var;
  * ``dtype_mismatch`` (warn): inferred vs declared element type
    disagree;
  * ``shape_infer_failed`` (error only under ``strict=True``, the
    transpiler post-condition mode, else silent): the meta evaluation of
    an op with fully-known input shapes raised, which on a transpiled
    program means a miscompiled consumer.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..core.dtypes import convert_dtype
from ..framework.layer_helper import meta_lower, meta_shape, meta_tensor
from ..framework.registry import get_op_def, get_shape_infer
from . import traversal
from .findings import ERROR, WARN, AnalysisResult, Finding
from .infer_rules import InferError

PASS = "shape_inference"

# JAX's list (paddle_tpu/analysis/shape_inference.py:50-54), less the ops
# the port has not registered: without a rule these are "unknown shape"
# even under strict mode (the control-flow ops read ctx.env, which a meta
# evaluation does not have)
UNEVALUABLE_OPS = frozenset({"while", "conditional_block", "scan",
                             "static_rnn_scan", "increment_loop_counter",
                             "autodiff", "fused_attention"})

ShapeDtype = Tuple[Optional[tuple], Optional[str]]


def _canon_dtype(dt) -> Optional[str]:
    if dt is None:
        return None
    try:
        return convert_dtype(dt)
    except (TypeError, ValueError):
        return str(dt)


def _fully_known(shape) -> bool:
    return shape is not None and all(int(d) != -1 for d in shape)


def _shapes_conflict(a, b) -> bool:
    """Both known, provably different (rank or a non-dynamic dim)."""
    if a is None or b is None:
        return False
    if len(a) != len(b):
        # a scalar () vs (1,) style rank drift is benign squeeze
        # territory; only call rank conflicts when both sides have extent
        return bool(a) and bool(b)
    return any(x != -1 and y != -1 and int(x) != int(y)
               for x, y in zip(a, b))


def _meta_eval(opdef, ins_info: Dict[str, List[ShapeDtype]], attrs
               ) -> Optional[Dict[str, List[ShapeDtype]]]:
    """One evaluation of the op's lowering on meta inputs.  Returns None
    when any input is unknown; raises on a lowering error."""
    ins: Dict[str, List] = {}
    had_dyn = False
    for slot, infos in ins_info.items():
        for shape, dtype in infos:
            if shape is None or dtype is None:
                return None
            had_dyn = had_dyn or any(int(d) == -1 for d in shape)
            ins.setdefault(slot, []).append(meta_tensor(shape, dtype))
    outs = meta_lower(opdef, ins, attrs)
    return {slot: [(meta_shape(t, had_dyn), _canon_dtype(t.dtype))
                   for t in ts]
            for slot, ts in outs.items()}


class ShapeInferencePass:
    """Propagate symbolic shapes through the global block, checking
    inferred against declared.  Sub-blocks keep their declared
    (build-time) metadata; the lint surface is block 0, where every
    transpiler rewrites."""

    name = PASS

    def run(self, program, result: AnalysisResult,
            feed_shapes: Optional[Dict[str, tuple]] = None,
            strict: bool = False) -> Dict[str, ShapeDtype]:
        result.passes_run.append(self.name)
        block = program.global_block()
        env: Dict[str, ShapeDtype] = {}
        # seed: feeds (runtime shapes when the executor knows them),
        # data vars and persistable state from declared metadata
        for name, var in block.vars.items():
            shape, dtype = traversal.declared_info(block, name)
            if var.is_data or var.persistable:
                env[name] = (shape, dtype)
        for name, shape in (feed_shapes or {}).items():
            _, dtype = traversal.declared_info(block, name)
            env[name] = (tuple(shape), dtype)

        for i, op in enumerate(block.ops):
            if op.type in traversal.STRUCTURAL_OPS:
                continue
            ins_info = {
                slot: [env.get(n) or traversal.declared_info(block, n)
                       for n in names]
                for slot, names in op.inputs.items()}
            outs = None
            rule = get_shape_infer(op.type)
            try:
                if rule is not None:
                    outs = rule(op, ins_info, op.attrs)
                if outs is None and op.type not in UNEVALUABLE_OPS:
                    outs = _meta_eval(get_op_def(op.type), ins_info,
                                      op.attrs)
            except InferError as e:
                result.add(Finding(
                    pass_name=self.name, code="shape_mismatch",
                    severity=ERROR, message=str(e), block_idx=block.idx,
                    op_index=i, op_type=op.type,
                    var_names=tuple(traversal.op_input_names(op)),
                    callsite=getattr(op, "callsite", None)))
                outs = None
            except Exception as e:      # the meta evaluation failed
                known = all(
                    info is not None and _fully_known(info[0])
                    for infos in ins_info.values() for info in infos)
                if strict and known:
                    result.add(Finding(
                        pass_name=self.name, code="shape_infer_failed",
                        severity=ERROR,
                        message=(f"meta evaluation of {op.type!r} "
                                 f"failed on fully-known input shapes: "
                                 f"{str(e)[:300]}"),
                        block_idx=block.idx, op_index=i,
                        op_type=op.type,
                        var_names=tuple(traversal.op_input_names(op)),
                        callsite=getattr(op, "callsite", None)))
                outs = None

            if outs is None:
                result.unknown_shape_ops.append(op.type)
            for slot, names in op.outputs.items():
                inferred = (outs or {}).get(slot, [])
                for j, n in enumerate(names):
                    if not n:
                        continue
                    inf: ShapeDtype = (inferred[j] if j < len(inferred)
                                       else (None, None))
                    decl_shape, decl_dtype = traversal.declared_info(
                        block, n)
                    if _shapes_conflict(inf[0], decl_shape):
                        result.add(Finding(
                            pass_name=self.name, code="shape_mismatch",
                            severity=ERROR,
                            message=(f"op {op.type!r} produces "
                                     f"{_fmt(inf[0])} for var {n!r} but "
                                     f"the program declares "
                                     f"{_fmt(decl_shape)}"),
                            block_idx=block.idx, op_index=i,
                            op_type=op.type, var_names=(n,),
                            callsite=getattr(op, "callsite", None)))
                    elif (inf[1] is not None and decl_dtype is not None
                          and _canon_dtype(inf[1])
                          != _canon_dtype(decl_dtype)):
                        result.add(Finding(
                            pass_name=self.name, code="dtype_mismatch",
                            severity=WARN,
                            message=(f"op {op.type!r} produces "
                                     f"{inf[1]} for var {n!r} but the "
                                     f"program declares {decl_dtype}"),
                            block_idx=block.idx, op_index=i,
                            op_type=op.type, var_names=(n,),
                            callsite=getattr(op, "callsite", None)))
                    # prefer the propagated view; fall back to declared
                    env[n] = (inf[0] if inf[0] is not None
                              else decl_shape,
                              inf[1] if inf[1] is not None
                              else decl_dtype)
        return env


def _fmt(shape):
    return "?" if shape is None else list(shape)
